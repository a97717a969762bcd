#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
(nvcc, sm_90a), holds each kernel against its plain PyTorch version on the
card, then drives the port's paths at the full width of the gcn-paper
workload (a 2**20-vertex graph, dims [256, 256, 256, 64], random seeded
weights), for exchange_chunks 1 and 2 each: the layer-wise GCN inference
sweep (`launch/serve_gnn.run_sweep`) and the full-graph training step
(`launch/train_gnn.run_training`, lr 0.1), each held to its single-device
reference.  Each phase prints one JSON line; the next-to-last lines are the
per-kernel summary and the card's name and power limit from nvidia-smi, and
the last line is {"ok": true, "device": {...}}.  Any failed check raises, so the script exits
non-zero and prints no result.  It needs a CUDA card and the repository's
`src/` beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-4
SWEEPS = 3
TRAIN_STEPS = 5
TRAIN_LR = 0.1  # the loss falls at every step at this width (lr 0.3+ overshoots)
KERNEL_SOURCES = {"ell_spmm": "src/repro_torch/kernels/csrc/ell_spmm.cu"}


# torch.sparse (the library yardstick only) warns that it is in beta
warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ell_case(name, ids, mask, H, normalize, reps):
    """One ELL-SpMM case: the kernel against its plain version on the card,
    times of kernel / plain / one torch.sparse.mm call, and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_spmm import ell_spmm

    V, K = ids.shape
    N, D = H.shape
    got = ell_spmm(ids, mask, H, normalize=normalize)
    again = ell_spmm(ids, mask, H, normalize=normalize)
    want = ref.ell_spmm_ref(ids, mask, H, normalize=normalize)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= TOL, f"{name} normalize={normalize}: max |kernel - plain| "
          f"{err} > {TOL}")
    check(torch.equal(got, again), f"{name}: two launches differ")
    # the library yardstick: one sparse x dense product, the matrix built
    # once from ids/mask (1/deg folded into the values when normalizing;
    # repeated neighbors summed by coalesce, so it is a valid CSR)
    nz = mask != 0
    vals = mask / mask.sum(1, keepdim=True).clamp(min=1.0) if normalize else mask
    r, _ = nz.nonzero(as_tuple=True)
    csr = torch.sparse_coo_tensor(torch.stack([r, ids[nz].long()]), vals[nz],
                                  size=(V, N), check_invariants=True
                                  ).coalesce().to_sparse_csr()
    lib_err = float((torch.sparse.mm(csr, H) - want).abs().max())
    kernel_ms = cuda_ms(lambda: ell_spmm(ids, mask, H, normalize=normalize), reps)
    plain_ms = cuda_ms(lambda: ref.ell_spmm_ref(ids, mask, H, normalize=normalize),
                       max(1, reps // 4))
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, H), reps)
    # least work the function needs on these inputs: every H row some
    # unmasked slot names read once, ids + mask read once, out written once;
    # a multiply-add per unmasked slot and feature (+ the degree divide)
    nnz = int(nz.sum())
    touched = int(torch.unique(ids[nz]).numel())
    least_bytes = touched * D * 4 + V * K * 8 + V * D * 4
    ops = 2 * nnz * D + (V * K + V * D if normalize else 0)
    bytes_ms = least_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    row = dict(kernel="ell_spmm", case=name, normalize=normalize, V=V, K=K,
               N=N, D=D, nnz=nnz, max_abs_err=err, tol=TOL,
               bitwise_repeat=True, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_max_abs_err=lib_err,
               least_bytes=least_bytes, ops=ops,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    emit("kernel", **row)
    return row


def random_ell(gen, V, K, N, D, p, device, weighted=False):
    ids = torch.randint(0, N, (V, K), generator=gen, dtype=torch.int32)
    mask = (torch.rand((V, K), generator=gen) < p).float()
    if weighted:
        mask = mask * torch.rand((V, K), generator=gen)
    H = torch.randn((N, D), generator=gen)
    return ids.to(device), mask.to(device), H.to(device)


def kernel_phase(eng, device):
    """Every ELL-SpMM case of the contract, from the main path's own shape
    down to the ragged and degenerate ones."""
    gen = torch.Generator().manual_seed(0)
    ids, mask = eng._consts["ids"], eng._consts["mask"]
    X = eng.store.device_table()
    table = torch.cat([X, X.new_zeros((1, X.shape[1]))], 0)
    rows = [ell_case("gcn-paper layout", ids, mask, table, False, 10),
            ell_case("gcn-paper layout", ids, mask, table, True, 10)]
    weights = torch.rand(mask.shape, generator=gen).to(device)
    rows.append(ell_case("gcn-paper layout, weighted mask", ids,
                         (mask * weights).contiguous(), table, False, 10))
    for D in (37, 36):
        for normalize in (False, True):
            rows.append(ell_case(f"ragged V=1003 D={D}",
                                 *random_ell(gen, 1003, 7, 502, D, 0.6, device),
                                 normalize, 100))
    rows.append(ell_case("K=1", *random_ell(gen, 4096, 1, 4096, 256, 0.9, device),
                         True, 100))
    # K past one shared-memory stage (64 slots), D past one column pass
    rows.append(ell_case("K=100 D=300",
                         *random_ell(gen, 3000, 100, 5000, 300, 0.7, device,
                                     weighted=True), True, 100))
    ids_w, mask_w, H_w = random_ell(gen, 2048, 16, 3000, 64, 0.5, device,
                                    weighted=True)
    mask_w[:512] = 0.0  # all-masked rows: zero out, degree clamps to 1
    rows.append(ell_case("all-masked rows + weighted", ids_w, mask_w, H_w,
                         True, 100))
    # a contiguous H whose data pointer is 4 bytes off 16-byte alignment
    # takes the 4-byte path even though D % 4 == 0
    flat = torch.randn(3000 * 64 + 1, generator=gen).to(device)
    H_off = flat[1:].view(3000, 64)
    rows.append(ell_case("misaligned H, D=64", ids_w, mask_w, H_off, False, 100))
    return rows


def transpose_case(name, ids, mask, ct, N, normalize, reps, plan=None):
    """One case of the ELL-SpMM backward: the transpose kernel against its
    plain version on the card, a gradient through `ell_spmm` under autograd,
    times of kernel / plain / one torch.sparse.mm call with the transposed
    matrix, and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_spmm import (
        ell_spmm,
        ell_spmm_transpose,
        ell_transpose_plan,
    )

    V, K = ids.shape
    D = ct.shape[1]
    plan_ms = None  # the engine's plan was built with the engine
    if plan is None:
        t0 = time.perf_counter()
        plan = ell_transpose_plan(ids, mask, N)
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) * 1e3

    def kernel():
        return ell_spmm_transpose(ids, mask, ct, N, normalize=normalize,
                                  plan=plan)

    got, again = kernel(), kernel()
    want = ref.ell_spmm_transpose_ref(ids, mask, ct, N, normalize=normalize)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite dH")
    check(err <= TOL, f"transpose {name} normalize={normalize}: max |kernel - "
          f"plain| {err} > {TOL}")
    check(torch.equal(got, again), f"transpose {name}: two launches differ")
    H = torch.randn((N, D), device=ct.device).requires_grad_()
    (grad,) = torch.autograd.grad(
        ell_spmm(ids, mask, H, normalize=normalize, plan=plan), H, ct)
    grad_err = float((grad - want).abs().max()) if grad.numel() else 0.0
    check(grad_err <= TOL, f"transpose {name}: autograd through ell_spmm "
          f"differs from the plain gradient by {grad_err}")
    del H, grad
    # the library yardstick: one sparse x dense product with the transposed
    # matrix [N, V] (1/deg folded into the values when normalizing)
    nz = mask != 0
    vals = mask / mask.sum(1, keepdim=True).clamp(min=1.0) if normalize else mask
    r, _ = nz.nonzero(as_tuple=True)
    csr_t = torch.sparse_coo_tensor(torch.stack([ids[nz].long(), r]), vals[nz],
                                    size=(N, V), check_invariants=True
                                    ).coalesce().to_sparse_csr()
    lib_err = float((torch.sparse.mm(csr_t, ct) - want).abs().max())
    kernel_ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(lambda: ref.ell_spmm_transpose_ref(
        ids, mask, ct, N, normalize=normalize), max(1, reps // 4))
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr_t, ct), reps)
    # least work the function needs on these inputs: every ct row some
    # unmasked slot names read once, the plan and each listed slot's mask
    # read once (the whole mask when normalizing, for the degrees), dH
    # written once; a multiply-add per listed slot and feature (+ the divide)
    nnz = int(plan[1].numel())
    touched = int(torch.unique(r).numel())
    least_bytes = (touched * D * 4 + nnz * (8 + 4) + (N + 1) * 8 + N * D * 4
                   + (V * K * 4 if normalize else 0))
    ops = 2 * nnz * D + (V * K + V * D if normalize else 0)
    bytes_ms = least_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    row = dict(kernel="ell_spmm_transpose", case=name, normalize=normalize,
               V=V, K=K, N=N, D=D, nnz=nnz, max_abs_err=err, tol=TOL,
               autograd_max_abs_err=grad_err, bitwise_repeat=True,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_max_abs_err=lib_err, plan_ms=plan_ms,
               least_bytes=least_bytes, ops=ops,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    emit("kernel", **row)
    return row


def transpose_phase(eng, device):
    """Every case of the ELL-SpMM backward: the main path's own layout at
    the layer width (256) and the chunk width (128), then the weighted,
    ragged and degenerate ones."""
    gen = torch.Generator().manual_seed(1)
    ids, mask, plan = eng._consts["ids"], eng._consts["mask"], eng._consts["plan"]
    N = eng.Vp + 1  # the gather table's rows: every vertex + the zero pad row
    rows = []
    for D, normalize in ((256, False), (256, True), (128, False)):
        ct = torch.randn((eng.Vp, D), generator=gen).to(device)
        rows.append(transpose_case(f"gcn-paper layout D={D}", ids, mask, ct,
                                   N, normalize, 10, plan=plan))
    weights = torch.rand(mask.shape, generator=gen).to(device)
    ct = torch.randn((eng.Vp, 256), generator=gen).to(device)
    rows.append(transpose_case("gcn-paper layout D=256, weighted mask", ids,
                               (mask * weights).contiguous(), ct, N, False, 10))
    del ct, weights
    for D in (37, 36):
        for normalize in (False, True):
            ids_r, mask_r, _ = random_ell(gen, 1003, 7, 502, D, 0.6, device)
            ct = torch.randn((1003, D), generator=gen).to(device)
            rows.append(transpose_case(f"ragged V=1003 D={D}", ids_r, mask_r,
                                       ct, 502, normalize, 100))
    ids_1, mask_1, _ = random_ell(gen, 4096, 1, 4096, 256, 0.9, device)
    rows.append(transpose_case("K=1", ids_1, mask_1, torch.randn(
        (4096, 256), generator=gen).to(device), 4096, True, 100))
    # long segments (K=100 over 5000 rows) and D past one column pass
    ids_l, mask_l, _ = random_ell(gen, 3000, 100, 5000, 300, 0.7, device,
                                  weighted=True)
    rows.append(transpose_case("K=100 D=300", ids_l, mask_l, torch.randn(
        (3000, 300), generator=gen).to(device), 5000, True, 100))
    ids_w, mask_w, _ = random_ell(gen, 2048, 16, 3000, 64, 0.5, device,
                                  weighted=True)
    mask_w[:512] = 0.0  # all-masked rows: they add nothing, degree clamps to 1
    rows.append(transpose_case("all-masked rows + weighted", ids_w, mask_w,
                               torch.randn((2048, 64), generator=gen).to(device),
                               3000, True, 100))
    # a contiguous ct whose data pointer is 4 bytes off 16-byte alignment
    # takes the 4-byte path even though D % 4 == 0
    flat = torch.randn(2048 * 64 + 1, generator=gen).to(device)
    ct_off = flat[1:].view(2048, 64)
    rows.append(transpose_case("misaligned ct, D=64", ids_w, mask_w, ct_off,
                               3000, False, 100))
    return rows


def sweep_phase(g, chunks, device):
    """The main path: SWEEPS timed layer-wise sweeps through
    serve_gnn.run_sweep at full width, launches counted from 0."""
    from repro_torch.core.models.gnn import init_gnn_params
    from repro_torch.kernels.ell_spmm import ell_spmm
    from repro_torch.launch import serve_gnn

    t0 = time.perf_counter()
    args = serve_gnn.parse_args([
        "--device", str(device), "--exec", "broadcast", "--model", "gcn",
        "--exchange-chunks", str(chunks), "--hidden", "256", "--layers", "3"])
    eng = serve_gnn.build_engine(args, g)
    params = init_gnn_params("gcn", eng.dims, torch.Generator().manual_seed(0),
                             eng.device)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ell_spmm.launches = 0
    embs, walls = [], []
    for _ in range(SWEEPS):
        emb, wall = serve_gnn.run_sweep(eng, params)
        embs.append(emb)
        walls.append(wall)
    launches = ell_spmm.launches
    peak = torch.cuda.max_memory_allocated()
    L = len(eng.dims) - 1
    check(launches == L * chunks * SWEEPS,
          f"ell_spmm launched {launches} times in {SWEEPS} sweeps, expected "
          f"{L} layers x {chunks} chunks each")
    emb = embs[-1]
    check(emb.shape == (g.num_vertices, eng.dims[-1]), f"shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite embeddings")
    bitwise = all(np.array_equal(e, embs[0]) for e in embs[1:])
    check(bitwise, "sweeps are not bitwise equal")
    ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                     reference=True))
    err = float(np.max(np.abs(emb - ref)))
    check(err <= TOL, f"sweep vs reference sweep: {err} > {TOL}")
    median_s = float(np.median(walls))
    emit("sweep", exchange_chunks=chunks, vertices=g.num_vertices, K=eng.K,
         dims=eng.dims, sweeps=SWEEPS, walls_ms=[w * 1e3 for w in walls],
         median_ms=median_s * 1e3, vertices_per_s=g.num_vertices / median_s,
         ell_spmm_launches=launches, launches_per_sweep=launches / SWEEPS,
         bitwise_equal_sweeps=bitwise, oracle_max_abs_err=err, oracle_tol=TOL,
         inference_bytes=eng.comm_stats.inference_bytes,
         max_memory_allocated=peak, setup_s=setup_s)
    return eng, params, launches


def train_phase(g, chunks, device):
    """The training path: TRAIN_STEPS timed steps through
    train_gnn.run_training at full width, launches counted from 0; then a
    second run from the same initial state, which must be bitwise equal, and
    the single-device reference run (per-step loss gap <= TOL)."""
    from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_transpose
    from repro_torch.launch import train_gnn

    t0 = time.perf_counter()
    args = train_gnn.parse_args([
        "--device", str(device), "--exec", "broadcast", "--protocol", "sync",
        "--model", "gcn", "--exchange-chunks", str(chunks), "--hidden", "256",
        "--layers", "3", "--lr", str(TRAIN_LR)])
    eng = train_gnn.build_engine(args, g)  # the transpose plan included
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ell_spmm.launches = ell_spmm_transpose.launches = 0
    run = train_gnn.run_training(eng, TRAIN_STEPS)
    fwd, bwd = ell_spmm.launches, ell_spmm_transpose.launches
    peak = torch.cuda.max_memory_allocated()
    L = len(eng.dims) - 1
    check(fwd == L * chunks * TRAIN_STEPS,
          f"ell_spmm launched {fwd} times in {TRAIN_STEPS} steps, expected "
          f"{L} layers x {chunks} chunks each")
    # layer 0 aggregates the constant features: no backward through it
    check(bwd == (L - 1) * chunks * TRAIN_STEPS,
          f"ell_spmm_transpose launched {bwd} times in {TRAIN_STEPS} steps, "
          f"expected {L - 1} layers x {chunks} chunks each")
    losses = run["losses"]
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    logits = run["logits"]
    check(tuple(logits.shape) == (eng.Vp, eng.dims[-1]), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    train_acc, test_acc = eng.accuracy(logits, "train"), eng.accuracy(logits, "test")
    params, walls = run["state"]["params"], run["walls"]
    del run, logits
    torch.cuda.reset_peak_memory_stats()
    again = train_gnn.run_training(eng, TRAIN_STEPS, oracle_check=True)
    ref_peak = torch.cuda.max_memory_allocated()
    bitwise = again["losses"] == losses and all(
        torch.equal(a[key], b[key]) for a, b in
        zip(params["layers"], again["state"]["params"]["layers"])
        for key in ("w", "b"))
    check(bitwise, "two training runs from the same state differ")
    gaps = [abs(a - b) for a, b in zip(losses, again["ref_losses"])]
    check(max(gaps) <= TOL, f"step vs reference step: {gaps} > {TOL}")
    median_s = float(np.median(walls))
    emit("train", exchange_chunks=chunks, vertices=g.num_vertices, K=eng.K,
         dims=eng.dims, lr=TRAIN_LR, steps=TRAIN_STEPS, losses=losses,
         ref_losses=again["ref_losses"], loss_gaps=gaps, oracle_tol=TOL,
         walls_ms=[w * 1e3 for w in walls],
         walls_second_run_ms=[w * 1e3 for w in again["walls"]], median_step_ms=median_s * 1e3,
         steps_per_s=1.0 / median_s, train_acc=train_acc, test_acc=test_acc,
         ell_spmm_launches=fwd, ell_spmm_transpose_launches=bwd,
         bitwise_equal_runs=bitwise, max_memory_allocated=peak,
         max_memory_allocated_with_reference=ref_peak, setup_s=setup_s)
    return eng, fwd, bwd


def profile_phase(phase, fn, kernels):
    """torch.profiler trace of one call of fn, after one untraced warm-up
    cycle of the profiler: device busy time, idle share, the longest idle
    gaps, and the kernels that took the time.  ``kernels`` maps each kernel
    that must appear to its launches in one call, which the trace must
    hold exactly (a trace that lost events would understate the busy
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    check(len(traced) == 1, f"{phase}: expected one traced cycle")
    spans, by_name = [], {}
    for e in traced[0]:
        # device work only: the profiler's own step range is mirrored onto
        # the device timeline as an annotation spanning the whole call
        if e.device_type != DeviceType.CUDA or e.name.startswith("ProfilerStep") \
                or getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end, e.name))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    check(bool(spans), "the profiler recorded no device activity")
    busy_us, gaps, cur = 0.0, [], None
    for s, t, name in sorted(spans):  # union of the device intervals
        if cur is None or s > cur[1]:
            if cur is not None:
                busy_us += cur[1] - cur[0]
                gaps.append((s - cur[1], cur[2], name))
            cur = [s, t, name]
        elif t > cur[1]:
            cur[1:] = [t, name]
    busy_us += cur[1] - cur[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for kernel, launches in kernels.items():
        n = sum(c for name, (c, _) in by_name.items() if kernel in name)
        check(n == launches, f"{phase} trace holds {n} launches of {kernel}, "
              f"expected {launches}")
    emit(phase, traced_wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         device_idle_share=max(0.0, 1.0 - busy_us / wall_us),
         longest_idle_gaps=[dict(us=g, after=a[:80], before=b[:80])
                            for g, a, b in sorted(gaps, reverse=True)[:3]],
         kernels=[dict(name=n[:120], count=c, ms=us / 1e3)
                  for n, (c, us) in top],
         other_kernels_ms=sum(us for _, (_, us) in by_name.items()) / 1e3
         - sum(us for _, (_, us) in top) / 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.core.graph import er_graph
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build(list(KERNEL_SOURCES))
    emit("build", seconds=time.perf_counter() - t0, kernels=built)

    t0 = time.perf_counter()
    g = er_graph(CONFIG.num_vertices, avg_degree=CONFIG.avg_degree,
                 feature_dim=CONFIG.feature_dim,
                 num_classes=CONFIG.num_classes, seed=0)
    emit("graph", generator="er_graph", vertices=g.num_vertices,
         edges=g.num_edges, seconds=time.perf_counter() - t0)

    launches = {"ell_spmm": 0, "ell_spmm_transpose": 0}
    for chunks in (1, 2):
        eng, params, n = sweep_phase(g, chunks, device)
        launches["ell_spmm"] += n
        if chunks == 1:
            # kernel cases at the main path's own layout, counted apart
            rows = {"ell_spmm": kernel_phase(eng, device),
                    "ell_spmm_transpose": transpose_phase(eng, device)}
            profile_phase("profile", lambda: eng.infer_full_graph(params=params),
                          {"ell_spmm_kernel": len(eng.dims) - 1})
        del eng, params
        torch.cuda.empty_cache()
    for chunks in (1, 2):
        eng, fwd, bwd = train_phase(g, chunks, device)
        launches["ell_spmm"] += fwd
        launches["ell_spmm_transpose"] += bwd
        if chunks == 1:
            step, state = eng.make_step(), eng.init_state()
            L = len(eng.dims) - 1  # layer 0 runs no backward kernel
            profile_phase("train_profile", lambda: step(state),
                          {"ell_spmm_kernel": L, "ell_spmm_transpose_kernel": L - 1})
            del step, state
        del eng
        torch.cuda.empty_cache()

    replaces = {"ell_spmm": "src/repro/kernels/ell_spmm.py:26",
                "ell_spmm_transpose": "src/repro/kernels/ell_spmm.py:98"}
    summary = []
    for name, kernel_rows in rows.items():
        main_row = kernel_rows[0]  # gcn-paper layout, D=256, normalize off
        summary.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCES["ell_spmm"],
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in kernel_rows),
            ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
