#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
(nvcc, sm_90a), holds each kernel against its plain PyTorch version on the
card, then drives the port's main path at the full width of the gcn-paper
workload: the layer-wise GCN inference sweep (`launch/serve_gnn.run_sweep`)
over a 2**20-vertex graph with dims [256, 256, 256, 64] and random seeded
weights, for exchange_chunks 1 and 2.  Each phase prints one JSON line; the
next-to-last lines are the per-kernel summary and the card's name and power
limit from nvidia-smi, and the last line is
{"ok": true, "device": {...}}.  Any failed check raises, so the script exits
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


def profile_phase(eng, params):
    """torch.profiler trace of one sweep: device busy time, idle share, and
    the kernels that took it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.infer_full_graph(params=params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    check(bool(spans), "the profiler recorded no device activity")
    busy_us, cur_start, cur_end = 0.0, None, None
    for s, t in sorted(spans):  # union of the device intervals
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = s, t
        else:
            cur_end = max(cur_end, t)
    busy_us += cur_end - cur_start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    check(any("ell_spmm_kernel" in name for name in by_name),
          "the ELL kernel is not in the trace")
    emit("profile", traced_wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         device_idle_share=max(0.0, 1.0 - busy_us / wall_us),
         kernels=[dict(name=n[:120], count=c, ms=us / 1e3)
                  for n, (c, us) in top])


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

    launches = 0
    for chunks in (1, 2):
        eng, params, n = sweep_phase(g, chunks, device)
        launches += n
        if chunks == 1:
            # kernel cases at the main path's own layout, counted apart
            rows = kernel_phase(eng, device)
            profile_phase(eng, params)
        del eng, params
        torch.cuda.empty_cache()

    main_row = rows[0]  # gcn-paper layout, normalize=False: what the sweep runs
    print(json.dumps({"kernels": [dict(
        name="ell_spmm", route="cuda", source=KERNEL_SOURCES["ell_spmm"],
        replaces="src/repro/kernels/ell_spmm.py:26",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"])]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
