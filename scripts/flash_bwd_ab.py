#!/usr/bin/env python3
"""Phases of `chip_smoke.py` from checkouts of this repository on one card,
in turns: each run imports its own checkout's `chip_smoke.py` and sources
in a process of its own, runs the phases named by --phases in order, then
a digest of a forward kernel's outputs on seeded inputs (--digest), one
run after the other in the order given:

    python3 scripts/flash_bwd_ab.py --jsonl ab.jsonl \\
        parent=.checkout/parent change=.checkout/change \\
        change=.checkout/change parent=.checkout/parent

    python3 scripts/flash_bwd_ab.py --phases wkv_bwd,rwkv_train --digest wkv \\
        --jsonl ab.jsonl parent=... change=... change=... parent=...

Phases: `flash_bwd` (the flash backward's kernels at llama3.2-1b's
training width and their cases), `llm_train` (three AdamW steps of
llama3.2-1b, B 2, S 4096, one traced step), `wkv_bwd` (the WKV backward
at rwkv6-3b's width and its cases), `rwkv_train` (two AdamW steps of
rwkv6-3b, B 1, S 4096, one traced step).  Digests: `flash` (o and LSE of
the flash forward), `wkv` (y and the final state of `wkv` and
`wkv_with_state`).  The digest must be the same in every run: a change
to a backward leaves its forward bitwise as it was.

Prints one JSON line a run (the label, the main numbers of each phase,
the digest), whether the digests agree, and the card's name and power
limit; every phase line of every run also goes to --jsonl with the run's
label.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys

# the backward kernels' names in a trace, for a checkout whose
# `chip_smoke.py` predates its FLASH_BWD_TRACE / WKV_BWD_TRACE
SIMT_TRACE = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
WKV_SIMT_TRACE = ("wkv_bwd_kernel",)


def _update(digest, tensors) -> None:
    import torch

    for t in tensors:
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        digest.update(raw.contiguous().cpu().numpy().tobytes())


def flash_digest(device) -> str:
    """sha256 over the flash forward's o and LSE on seeded inputs: bf16 at
    llama3.2-1b's width (causal and not, S 4096), bf16 D 128 and D 32 with
    ragged S != T, fp32 D 64."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_with_lse

    gen = torch.Generator(device=device).manual_seed(77)
    digest = hashlib.sha256()
    for B, H, S, T, D, dtype, causal in ((2, 32, 4096, 4096, 64, torch.bfloat16, True),
                                         (2, 32, 4096, 4096, 64, torch.bfloat16, False),
                                         (1, 8, 1000, 700, 128, torch.bfloat16, True),
                                         (1, 8, 129, 300, 32, torch.bfloat16, False),
                                         (1, 8, 1000, 1000, 64, torch.float32, True)):
        q = torch.randn((B, H, S, D), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((B, H, T, D), generator=gen, device=device).to(dtype)
                for _ in range(2))
        _update(digest, flash_attention_with_lse(q, k, v, causal=causal))
    return digest.hexdigest()


def wkv_digest(device) -> str:
    """sha256 over `wkv`'s y and `wkv_with_state`'s y and state on seeded
    inputs: fp32 and bf16 at rwkv6-3b's width (B 4, H 40, S 4096, K 64;
    g across the clip floor), a ragged S 1000, K 32 and K 16."""
    import torch

    from repro_torch.kernels.wkv_chunk import wkv, wkv_with_state

    gen = torch.Generator(device=device).manual_seed(78)
    digest = hashlib.sha256()
    for B, H, S, K, dtype in ((4, 40, 4096, 64, torch.float32),
                              (4, 40, 4096, 64, torch.bfloat16),
                              (1, 40, 1000, 64, torch.float32),
                              (1, 40, 2048, 32, torch.float32),
                              (2, 8, 300, 16, torch.float32)):
        r, k, v = (0.5 * torch.randn((B, H, S, K), generator=gen, device=device)
                   for _ in range(3))
        g = -torch.exp(0.8 * torch.randn((B, H, S, K), generator=gen, device=device) - 0.5)
        u = 0.3 * torch.randn((H, K), generator=gen, device=device)
        args = [t.to(dtype) for t in (r, k, v, g, u)]
        _update(digest, [wkv(*args, chunk=S)])
        _update(digest, wkv_with_state(*args, chunk=S))
    return digest.hexdigest()


DIGESTS = {"flash": flash_digest, "wkv": wkv_digest}


def run_phase(cs, name, device, lines) -> dict:
    """One phase of the checkout's `chip_smoke` (module ``cs``); its main
    numbers from the lines it emitted."""
    from repro_torch.configs import get_config

    import torch

    if name == "flash_bwd":
        cs.flash_bwd_phase(device)
        f = lines["flash_bwd"]
        return {k: f.get(k) for k in ("dq_ms", "dkdv_ms", "backward_ms",
                                      "sdpa_backward_ms", "non_causal")}
    if name == "wkv_bwd":
        cs.wkv_bwd_phase(device)
        f = lines["wkv_bwd"]
        return {k: f.get(k) for k in ("ms", "device_ms", "bound_ms", "design_floor_ms",
                                      "plain_ms")}
    if name == "llm_train":
        cfg = get_config("llama3.2-1b")
        L = cfg.num_layers
        dq, dkdv = getattr(cs, "FLASH_BWD_TRACE", {}).get(torch.bfloat16, SIMT_TRACE)
        cs.llm_train_phase(cfg, cs.LLM_TRAIN["batch"], cs.LLM_TRAIN["steps"],
                           {"flash_bf16_kernel": 2 * L, dq: L, dkdv: L},
                           dict(flash_attention=2 * L, flash_attention_bwd_dq=L,
                                flash_attention_bwd_dkdv=L),
                           "flash", cs.held_flash_layer0, device, "llm_train")
        watch = "flash"
    elif name == "rwkv_train":
        cfg = get_config("rwkv6-3b")
        L = cfg.num_layers
        bwd = getattr(cs, "WKV_BWD_TRACE", WKV_SIMT_TRACE)
        cs.llm_train_phase(cfg, cs.RWKV_TRAIN["batch"], cs.RWKV_TRAIN["steps"],
                           {"wkv_chunk_kernel": 2 * L, **{k: L for k in bwd}},
                           dict(wkv=2 * L, wkv_bwd=L), "wkv", cs.held_wkv_layer0,
                           device, "rwkv_train")
        watch = "wkv"
    else:
        raise SystemExit(f"flash_bwd_ab: unknown phase {name!r}")
    train, prof = lines[name], lines[f"{name}_profile"]
    kernels = {k["name"][:60]: k for k in prof["kernels"] if watch in k["name"]}
    return dict(steady_step_ms=train["steady_step_ms"], step_ms=train["step_ms"],
                traced_step_device_ms=prof["device_busy_ms"],
                traced_group=prof["groups"].get(watch), traced_kernels=kernels)


def run_one(checkout: str, label: str, jsonl: str, phases, digest: str) -> dict:
    """The phases and the digest of one checkout in this process."""
    checkout = os.path.abspath(checkout)
    sys.path[:0] = [checkout, os.path.join(checkout, "src")]
    import torch

    cs = importlib.import_module("chip_smoke")
    lines = {}
    emit = cs.emit

    def keep(phase, **fields):
        lines[phase] = fields
        emit(phase, run=label, **fields)

    cs.emit = keep
    if jsonl:
        cs.JSONL.append(jsonl)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    out = dict(run=label, checkout=checkout)
    for i, name in enumerate(phases):
        if i:
            cs.release()
        out[name] = run_phase(cs, name, device, lines)
    out[f"{digest}_digest"] = DIGESTS[digest](device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", help="label=checkout, in order")
    ap.add_argument("--phases", default="flash_bwd,llm_train",
                    help="comma-separated, in order (default: flash_bwd,llm_train)")
    ap.add_argument("--digest", default="flash", choices=sorted(DIGESTS))
    ap.add_argument("--jsonl", default="", help="append every phase line here")
    ap.add_argument("--one", nargs=2, metavar=("LABEL", "CHECKOUT"),
                    help=argparse.SUPPRESS)  # one run, in this process
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if args.one:
        print("AB " + json.dumps(run_one(args.one[1], args.one[0], args.jsonl, phases,
                                         args.digest)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA card is available", file=sys.stderr)
        return 1
    if args.jsonl:
        os.makedirs(os.path.dirname(os.path.abspath(args.jsonl)), exist_ok=True)
    results = []
    for run in args.runs:
        label, checkout = run.split("=", 1)
        checkout = os.path.abspath(checkout)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--jsonl",
                              os.path.abspath(args.jsonl) if args.jsonl else "",
                              "--phases", ",".join(phases), "--digest", args.digest,
                              "--one", label, checkout],
                             capture_output=True, text=True, cwd=checkout)
        tail = [l for l in out.stdout.splitlines() if l.startswith("AB ")]
        if out.returncode != 0 or not tail:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            print(f"flash_bwd_ab: run {label} ({checkout}) failed", file=sys.stderr)
            return 1
        results.append(json.loads(tail[-1][3:]))
        print(json.dumps(results[-1]), flush=True)
    digests = {r[f"{args.digest}_digest"] for r in results}
    print(json.dumps({f"{args.digest}_bitwise_equal_across_runs": len(digests) == 1}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
