#!/usr/bin/env python3
"""The flash attention backward of checkouts of this repository on one card,
in turns: each checkout's own `chip_smoke.py` phases `flash_bwd` (the two
backward kernels at llama3.2-1b's training width and their cases) and
`llm_train` (three AdamW steps of llama3.2-1b, B 2, S 4096, one traced
step), each run in a process of its own from that checkout's sources and
kernels, one after the other in the order given:

    python3 scripts/flash_bwd_ab.py --jsonl ab.jsonl \\
        parent=.checkout/parent change=.checkout/change \\
        change=.checkout/change parent=.checkout/parent

Prints one JSON line a run (the label; the main shape's dQ, dK/dV and
SDPA backward ms; the flash share of the traced step; the step ms; a
digest of the forward's o and LSE on seeded inputs, which must be the same
in every run: the backward's change leaves the forward bitwise as it was)
and the card's name and power limit; every phase line of every run also
goes to --jsonl with the run's label.  Needs a CUDA card.
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
# `chip_smoke.py` predates its FLASH_BWD_TRACE
SIMT_TRACE = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")


def forward_digest(device) -> str:
    """sha256 over the forward kernel's o and LSE on seeded inputs: bf16 at
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
        for t in flash_attention_with_lse(q, k, v, causal=causal):
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            digest.update(raw.cpu().numpy().tobytes())
    return digest.hexdigest()


def run_one(checkout: str, label: str, jsonl: str) -> dict:
    """The two phases of one checkout in this process."""
    checkout = os.path.abspath(checkout)
    sys.path[:0] = [checkout, os.path.join(checkout, "src")]
    import torch

    cs = importlib.import_module("chip_smoke")
    from repro_torch.configs import get_config

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
    cs.flash_bwd_phase(device)
    cs.release()
    cfg = get_config("llama3.2-1b")
    L = cfg.num_layers
    dq_name, dkdv_name = getattr(cs, "FLASH_BWD_TRACE", {}).get(torch.bfloat16, SIMT_TRACE)
    cs.llm_train_phase(cfg, cs.LLM_TRAIN["batch"], cs.LLM_TRAIN["steps"],
                       {"flash_bf16_kernel": 2 * L, dq_name: L, dkdv_name: L},
                       dict(flash_attention=2 * L, flash_attention_bwd_dq=L,
                            flash_attention_bwd_dkdv=L),
                       "flash", cs.held_flash_layer0, device, "llm_train")
    digest = forward_digest(device)
    flash, train = lines["flash_bwd"], lines["llm_train"]
    groups = lines["llm_train_profile"]["groups"]
    return dict(run=label, checkout=checkout, dq_ms=flash["dq_ms"],
                dkdv_ms=flash["dkdv_ms"], backward_ms=flash["backward_ms"],
                sdpa_backward_ms=flash["sdpa_backward_ms"],
                non_causal=flash.get("non_causal"),
                steady_step_ms=train["steady_step_ms"], step_ms=train["step_ms"],
                traced_step_device_ms=lines["llm_train_profile"]["device_busy_ms"],
                traced_flash=groups.get("flash"), forward_digest=digest)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", help="label=checkout, in order")
    ap.add_argument("--jsonl", default="", help="append every phase line here")
    ap.add_argument("--one", nargs=2, metavar=("LABEL", "CHECKOUT"),
                    help=argparse.SUPPRESS)  # one run, in this process
    args = ap.parse_args(argv)
    if args.one:
        print("AB " + json.dumps(run_one(args.one[1], args.one[0], args.jsonl)), flush=True)
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
                              "--one", label, checkout],
                             capture_output=True, text=True, cwd=checkout)
        tail = [l for l in out.stdout.splitlines() if l.startswith("AB ")]
        if out.returncode != 0 or not tail:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            print(f"flash_bwd_ab: run {label} ({checkout}) failed", file=sys.stderr)
            return 1
        results.append(json.loads(tail[-1][3:]))
        print(json.dumps(results[-1]), flush=True)
    digests = {r["forward_digest"] for r in results}
    print(json.dumps({"forward_bitwise_equal_across_runs": len(digests) == 1}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
