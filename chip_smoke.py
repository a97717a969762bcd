#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--jsonl PATH]

Builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
(nvcc, sm_90a, one process per source, all started together), holds each
kernel against its plain PyTorch version on the card, then drives the port's
paths.  First the kernel API's language-model kernels at model width:
`ops.flash_attention` at llama3.2-1b's (32 heads of dim 64, train_4k's 4096
tokens; bf16 causal and non-causal, fp32 causal) and `ops.wkv` at
rwkv6-3b's (40 heads of key dim 64, chunk 64, four 4096-token sequences).
Then the GNN paths at the full width of the gcn-paper workload (a
2**20-vertex graph, dims [256, 256, 256, 64], random seeded weights), for
exchange_chunks 1 and 2 each and for the models gcn, sage, gin and gat: the
layer-wise inference sweep (`launch/serve_gnn.run_sweep`) and the
full-graph training step (`launch/train_gnn.run_training`; lr `TRAIN_LR`),
each held to its single-device reference, with every kernel's launches
counted from 0 around each drive.  Last, gcn and gat at exchange_chunks 2
once more inside a world-size-1 NCCL group joined through the launchers'
group options (phases `nccl_sweep`, `nccl_train`): the all_gather, its
reduce-scatter and the all_reduce run on the card, every collective call is
counted, and the results must equal the runs without a group bit for bit
(one rank: the collectives are copies on the card, no wire time).  Each
phase prints one JSON line; the next-to-last lines
are the per-kernel summary and the card's name and power limit from
nvidia-smi, and the last line is {"ok": true, "device": {...}}; with
``--jsonl PATH`` every phase line is also appended to PATH.  Any failed check
raises, so the script exits non-zero and prints no result.  It needs a CUDA
card and the repository's `src/` beside it.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_TENSOR_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
TOL = 1e-4
# device clock cycles (about 0.2 ms) that cover the host's enqueueing of one
# call in `cuda_ms(..., queued=True)`: a kernel wrapper takes 0.03-0.07 ms
HOST_CALL_CYCLES = 400_000
SWEEPS = 3
TRACE_ATTEMPTS = 3  # traces of one profile phase, until one holds every launch
# widths that reach every lane group of the ELL forward and transpose (G
# lanes an entry, U units a lane: csrc/ell_spmm.cu `with_lane_group`) in
# units of 4 or 16 bytes: W = 1, 3, 2, 6, 4, 11, 8, 21, 16, 41, 32, 64, 81
# and the general form past 288 units
LANE_GROUP_WIDTHS = (1, 2, 3, 6, 11, 21, 41, 81, 300, 4, 8, 12, 16, 24, 32, 44,
                     64, 84, 128, 164, 256, 324, 1200)
TRAIN_STEPS = 5
# the loss falls at every step at this width: gcn overshoots from lr 0.3;
# gat fell at every step from 0.05 to 10 on the CPU at this width (2**14
# vertices) and diverged at 20; on the CPU at 2**14 vertices sage fell at
# every step from 0.05 to 0.3 and rose at 1.0, gin fell from 0.05 to 3.0,
# most in 5 steps at 0.1; at 0.1 both fell at every step on the H100 at
# this width (sage 4.51 to 3.65, gin 4.28 to 4.08)
TRAIN_LR = {"gcn": 0.1, "sage": 0.1, "gin": 0.1, "gat": 1.0}
MODELS = ("gcn", "sage", "gin", "gat")
# the models and exchange_chunks the world-size-1 NCCL group runs
NCCL_MODELS, NCCL_CHUNKS = ("gcn", "gat"), 2
SOURCES = {"ell_spmm": "src/repro_torch/kernels/csrc/ell_spmm.cu",
           "sddmm": "src/repro_torch/kernels/csrc/sddmm.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "wkv_chunk": "src/repro_torch/kernels/csrc/wkv_chunk.cu"}
# each kernel: its source, and the TPU kernel (or gradient rule) it replaces
KERNELS = {
    "ell_spmm": ("ell_spmm", "src/repro/kernels/ell_spmm.py:26"),
    "ell_spmm_transpose": ("ell_spmm", "src/repro/kernels/ell_spmm.py:98"),
    "sddmm": ("sddmm", "src/repro/kernels/sddmm.py:16"),
    "ell_slot_transpose": ("sddmm", "src/repro/kernels/sddmm.py:109"),
    "ell_attend_dw": ("ell_spmm", "src/repro/kernels/ell_spmm.py:137"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:20"),
    "wkv": ("wkv_chunk", "src/repro/kernels/wkv_chunk.py:26"),
}
# fp32 flash: the JAX tier's tolerance (tests/test_kernels.py), as
# (atol, rtol).  bf16 flash: kernel and plain each round every p to bf16
# (2**-8 relative) and the output once more, so |kernel - plain| <= 2**-7
# (|plain| + P.|V|): held with the scale P.|V| (flash_case)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# the JAX tier's bf16 tolerance, kept only to show what it lets pass
FLASH_JAX_BF16_TOL = (3e-2, 3e-2)
WKV_TOL = (1e-4, 1e-3)
# bf16 wkv outputs: kernel and plain both compute in fp32 and round once to
# bf16, which may land one bf16 step (2**-7 relative) apart
WKV_BF16_TOL = (1e-4, 2.0 ** -7)


# torch.sparse (the library yardstick only) warns that it is in beta
warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly")


def counters() -> dict:
    """Each kernel's wrapper, which holds its launch count."""
    from repro_torch.kernels.ell_spmm import (
        ell_attend_dw,
        ell_spmm,
        ell_spmm_transpose,
    )
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.sddmm import ell_slot_transpose, sddmm
    from repro_torch.kernels.wkv_chunk import wkv

    return dict(ell_spmm=ell_spmm, ell_spmm_transpose=ell_spmm_transpose,
                sddmm=sddmm, ell_slot_transpose=ell_slot_transpose,
                ell_attend_dw=ell_attend_dw, flash_attention=flash_attention,
                wkv=wkv)


def zero_counts() -> None:
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in counters().items()}


def check_counts(got: dict, want: dict, what: str) -> None:
    want = {name: want.get(name, 0) for name in got}
    check(got == want, f"{what}: kernel launches {got}, expected {want}")


def step_launches(model: str, L: int, C: int, T: int) -> dict:
    """Launches of T training steps.  gcn: the forward per layer and chunk,
    the transpose for layers 1.. (layer 0 aggregates the constant features).
    gat: the attend forward, its transpose and its dw per layer and chunk
    (layer 0's Hw depends on w), and one slot transpose per layer for the
    attention column's gather (chunk 0 only).  sage and gin launch gcn's."""
    if model != "gat":
        return dict(ell_spmm=L * C * T, ell_spmm_transpose=(L - 1) * C * T)
    return dict(ell_spmm=L * C * T, ell_spmm_transpose=L * C * T,
                ell_attend_dw=L * C * T, ell_slot_transpose=L * T)


def check_calls(got: dict, want: dict, what: str) -> None:
    want = {name: want.get(name, 0) for name in got}
    check(got == want, f"{what}: collective calls {got}, expected {want}")


def step_calls(model: str, L: int, C: int, T: int) -> dict:
    """Collective calls of T training steps in a process group, then the
    all_gather of the last logits: an all_gather per layer and chunk, a
    reduce-scatter (its backward) per layer and chunk whose table needs a
    gradient (as the transpose: not layer 0's constant features, but gat's
    Hw), and one flat all_reduce of the loss and the gradients a step."""
    grad_layers = L if model == "gat" else L - 1
    return dict(all_gather=L * C * T + 1, reduce_scatter=grad_layers * C * T,
                all_reduce=T)


def compare_baseline(name: str, result: dict, baseline: dict, keys) -> dict:
    """The phase's result against the same phase without a process group:
    bitwise equal in ``keys`` (arrays, lists of floats, or lists of layers
    of tensors), and both medians side by side."""
    def equal(a, b):
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        if isinstance(a, list) and a and isinstance(a[0], dict):
            return all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                       for k in x)
        return a == b
    for key in keys:
        check(equal(result[key], baseline[key]),
              f"{name}: {key} differs from the run without a group")
    return dict(bitwise_equal_to_no_group=True,
                no_group_median_ms=baseline["median_ms"],
                timing_note="world-size-1 NCCL group: each collective is a "
                            "copy on the card, no wire time")


def reference_launches(model: str, L: int, T: int, backward: bool) -> dict:
    """Launches of T reference steps (or sweeps: no backward).  The gcn
    reference is plain throughout; gat's edge logits go through the SDDMM
    kernel and its gradient through the slot transpose, as the reference
    calls its Pallas SDDMM.  sage and gin: as gcn."""
    if model != "gat":
        return {}
    return dict(sddmm=L * T, ell_slot_transpose=L * T if backward else 0)


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


JSONL = []  # the file every phase line is also appended to (--jsonl)


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    for path in JSONL:
        with open(path, "a") as f:
            f.write(line + "\n")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of fn() over reps back-to-back calls, after one
    warm-up, between two events.  A kernel of a few microseconds is timed at
    the host's rate of calls: this is what a caller pays per call.  With
    ``queued`` the calls wait behind a device-side sleep long enough for the
    host to enqueue them all, so the events time the device work alone."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(reps * HOST_CALL_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(least_bytes: int, ops: int, rate: float = FP32_FLOPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over ``rate`` (fp32 unless given)."""
    bytes_ms = least_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return dict(least_bytes=least_bytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def excess(got, want, tol, scale=None) -> float:
    """How far |got - want| exceeds atol + rtol * scale anywhere (scale
    |want| unless given); <= 0 is within ``tol``."""
    atol, rtol = tol
    if not got.numel():
        return -atol
    scale = want.float().abs() if scale is None else scale
    return float(((got.float() - want.float()).abs() - rtol * scale).max()) - atol


def held(name, kernel, plain, what, autograd=None, tol=(TOL, 0.0), scale=None):
    """Two launches of the kernel against its plain version on the same
    inputs: finite, within ``tol`` = (atol, rtol) elementwise
    (|kernel - plain| <= atol + rtol * scale, scale |plain| unless
    ``scale(plain)`` gives it), bitwise equal to each other; ``autograd``
    (optional) is the same result through the differentiable wrapper."""
    got, again = kernel(), kernel()
    want = plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(got).all()), f"{what} {name}: non-finite output")
    over = excess(got, want, tol, None if scale is None else scale(want))
    check(over <= 0, f"{what} {name}: |kernel - plain| exceeds {tol[0]} + "
          f"{tol[1]} x scale by up to {over} (max abs {err})")
    check(torch.equal(got, again), f"{what} {name}: two launches differ")
    grad_err = None
    if autograd is not None:
        grad = autograd()
        grad_err = float((grad - want).abs().max()) if grad.numel() else 0.0
        check(grad_err <= TOL, f"{what} {name}: through autograd differs from "
              f"the plain version by {grad_err}")
    return want, dict(max_abs_err=err, tol=list(tol), excess=over,
                      bitwise_repeat=True, autograd_max_abs_err=grad_err)


def ell_case(name, ids, mask, H, normalize, reps):
    """One ELL-SpMM case: the kernel against its plain version on the card,
    times of kernel / plain / one torch.sparse.mm call, and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_spmm import ell_spmm

    V, K = ids.shape
    N, D = H.shape
    want, row = held(f"{name} normalize={normalize}",
                     lambda: ell_spmm(ids, mask, H, normalize=normalize),
                     lambda: ref.ell_spmm_ref(ids, mask, H, normalize=normalize),
                     "ell_spmm")
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

    def kernel():
        return ell_spmm(ids, mask, H, normalize=normalize)

    def library():
        return torch.sparse.mm(csr, H)

    kernel_ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(lambda: ref.ell_spmm_ref(ids, mask, H, normalize=normalize),
                       max(1, reps // 4))
    library_ms = cuda_ms(library, reps)
    # least work the function needs on these inputs: every H row some
    # unmasked slot names read once, ids + mask read once, out written once;
    # a multiply-add per unmasked slot and feature (+ the degree divide)
    nnz = int(nz.sum())
    touched = int(torch.unique(ids[nz]).numel())
    least_bytes = touched * D * 4 + V * K * 8 + V * D * 4
    ops = 2 * nnz * D + (V * K + V * D if normalize else 0)
    row.update(kernel="ell_spmm", case=name, normalize=normalize, V=V, K=K,
               N=N, D=D, nnz=nnz, tol=TOL, kernel_ms=kernel_ms,
               kernel_device_ms=cuda_ms(kernel, reps, queued=True),
               plain_ms=plain_ms, library_ms=library_ms,
               library_device_ms=cuda_ms(library, reps, queued=True),
               library_max_abs_err=lib_err, **bound(least_bytes, ops))
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
    down to the ragged and degenerate ones, and every lane-group shape of
    the kernel.  The GAT widths are in `gat_kernel_phase`."""
    gen = torch.Generator().manual_seed(0)
    ids, mask = eng._consts["ids"], eng._consts["mask"]
    X = eng.store.device_table()
    table = torch.cat([X, X.new_zeros((1, X.shape[1]))], 0)
    rows = [ell_case("gcn-paper layout", ids, mask, table, False, 10),
            ell_case("gcn-paper layout", ids, mask, table, True, 10)]
    weights = torch.rand(mask.shape, generator=gen).to(device)
    rows.append(ell_case("gcn-paper layout, weighted mask", ids,
                         (mask * weights).contiguous(), table, False, 10))
    # gcn at exchange_chunks 2: a table of 128 columns
    rows.append(ell_case("gcn-paper layout D=128", ids, mask,
                         table[:, :128].contiguous(), False, 10))
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
    # every lane-group shape: each width twice, H aligned (the 16-byte path
    # where D % 4 == 0) and 4 bytes off alignment (the 4-byte path); 40 slots
    # a row, so the ids are loaded in two passes of 32
    ids_g, mask_g, _ = random_ell(gen, 2048, 40, 3000, 1, 0.6, device,
                                  weighted=True)
    for D in LANE_GROUP_WIDTHS:
        flat = torch.randn(3000 * D + 1, generator=gen).to(device)
        for off in (0, 1):
            rows.append(ell_case(
                f"lane group D={D}" + (", misaligned H" if off else ""),
                ids_g, mask_g, flat[off:off + 3000 * D].view(3000, D),
                off == 0, 20))
    return rows


def transpose_case(name, ids, mask, ct, N, normalize, reps, plan=None,
                   diagnose=False):
    """One case of the ELL-SpMM backward: the transpose kernel against its
    plain version on the card, a gradient through `ell_spmm` under autograd,
    times of kernel / plain / one torch.sparse.mm call with the transposed
    matrix, and the bound.  With ``diagnose`` (normalize off), what the
    plan's indirection costs: the device time of one torch.index_select of
    the weights at the plan's slots (the kernel's random weight reads
    alone), and of the forward kernel over the same entries laid out as an
    ELL table [N, max segment] (every segment's rows and weights in plan
    order), with whether its output equals the transpose's bit for bit."""
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

    def autograd():
        H = torch.randn((N, D), device=ct.device).requires_grad_()
        return torch.autograd.grad(
            ell_spmm(ids, mask, H, normalize=normalize, plan=plan), H, ct)[0]

    want, row = held(f"{name} normalize={normalize}", kernel,
                     lambda: ref.ell_spmm_transpose_ref(ids, mask, ct, N,
                                                        normalize=normalize),
                     "ell_spmm_transpose", autograd)
    # the library yardstick: one sparse x dense product with the transposed
    # matrix [N, V] (1/deg folded into the values when normalizing)
    nz = mask != 0
    vals = mask / mask.sum(1, keepdim=True).clamp(min=1.0) if normalize else mask
    r, _ = nz.nonzero(as_tuple=True)
    csr_t = torch.sparse_coo_tensor(torch.stack([ids[nz].long(), r]), vals[nz],
                                    size=(N, V), check_invariants=True
                                    ).coalesce().to_sparse_csr()
    lib_err = float((torch.sparse.mm(csr_t, ct) - want).abs().max())

    def library():
        return torch.sparse.mm(csr_t, ct)

    kernel_ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(lambda: ref.ell_spmm_transpose_ref(
        ids, mask, ct, N, normalize=normalize), max(1, reps // 4))
    library_ms = cuda_ms(library, reps)
    # least work the function needs on these inputs: every ct row some
    # unmasked slot names read once, the plan and each listed slot's mask
    # read once (the whole mask when normalizing, for the degrees), dH
    # written once; a multiply-add per listed slot and feature (+ the divide)
    nnz = int(plan[1].numel())
    touched = int(torch.unique(r).numel())
    least_bytes = (touched * D * 4 + nnz * (8 + 4) + (N + 1) * 8 + N * D * 4
                   + (V * K * 4 if normalize else 0))
    ops = 2 * nnz * D + (V * K + V * D if normalize else 0)
    row.update(kernel="ell_spmm_transpose", case=name, normalize=normalize,
               V=V, K=K, N=N, D=D, nnz=nnz, tol=TOL, kernel_ms=kernel_ms,
               kernel_device_ms=cuda_ms(kernel, reps, queued=True),
               plain_ms=plain_ms, library_ms=library_ms,
               library_device_ms=cuda_ms(library, reps, queued=True),
               library_max_abs_err=lib_err, plan_ms=plan_ms,
               **bound(least_bytes, ops))
    if diagnose:
        row.update(transposed_ell_diagnosis(ids, mask, ct, N, plan, reps))
    emit("kernel", **row)
    return row


def transposed_ell_diagnosis(ids, mask, ct, N, plan, reps):
    """transpose_case's ``diagnose`` fields."""
    from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_transpose

    indptr, slots = plan
    counts = indptr.diff()
    owner = torch.repeat_interleave(torch.arange(N, device=ct.device), counts)
    pos = torch.arange(slots.numel(), device=ct.device) - indptr[owner]
    width = max(1, int(counts.max()))
    ids_t = torch.zeros((N, width), dtype=torch.int32, device=ct.device)
    mask_t = torch.zeros((N, width), device=ct.device)
    ids_t[owner, pos] = (slots // ids.shape[1]).int()
    mask_t[owner, pos] = mask.reshape(-1)[slots]
    del owner, pos
    got = ell_spmm_transpose(ids, mask, ct, N, normalize=False, plan=plan)
    return dict(
        weights_gather_device_ms=cuda_ms(
            lambda: torch.index_select(mask.reshape(-1), 0, slots), reps,
            queued=True),
        transposed_ell_width=width,
        transposed_ell_forward_device_ms=cuda_ms(
            lambda: ell_spmm(ids_t, mask_t, ct, normalize=False), reps,
            queued=True),
        transposed_ell_forward_bitwise_equal=bool(torch.equal(
            ell_spmm(ids_t, mask_t, ct, normalize=False), got)))


def transpose_phase(eng, device):
    """Every case of the ELL-SpMM backward: the main path's own layout at
    the layer width (256) and the chunk width (128), then the weighted,
    ragged and degenerate ones, every lane-group shape and a hub row.  The
    GAT widths are in `gat_kernel_phase`."""
    gen = torch.Generator().manual_seed(1)
    ids, mask, plan = eng._consts["ids"], eng._consts["mask"], eng._consts["plan"]
    N = eng.Vp + 1  # the gather table's rows: every vertex + the zero pad row
    rows = []
    for D, normalize in ((256, False), (256, True), (128, False)):
        ct = torch.randn((eng.Vp, D), generator=gen).to(device)
        rows.append(transpose_case(f"gcn-paper layout D={D}", ids, mask, ct,
                                   N, normalize, 10, plan=plan,
                                   diagnose=not normalize))
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
    # an odd width 4 bytes off alignment: the 4-byte path, misaligned rows
    flat = torch.randn(2048 * 257 + 1, generator=gen).to(device)
    rows.append(transpose_case("misaligned ct, D=257", ids_w, mask_w,
                               flat[1:].view(2048, 257), 3000, True, 100))
    # every lane-group shape of the shared row gather (the forward's
    # widths): each width with ct aligned (the 16-byte path where D % 4 ==
    # 0) and 4 bytes off; 40 slots a row, so a segment holds ~16 entries
    ids_g, mask_g, _ = random_ell(gen, 2048, 40, 3000, 1, 0.6, device,
                                  weighted=True)
    for D in LANE_GROUP_WIDTHS:
        flat = torch.randn(2048 * D + 1, generator=gen).to(device)
        for off in (0, 1):
            rows.append(transpose_case(
                f"lane group D={D}" + (", misaligned ct" if off else ""),
                ids_g, mask_g, flat[off:off + 2048 * D].view(2048, D), 3000,
                off == 0, 20))
    # a hub row: 10,000 unmasked slots name row 7, a segment of 313 loads of
    # 32 entries.  ct is drawn at scale 1/100, so that the hub's 10,000-term
    # sum is unit-scale, the scale the 1e-4 tolerance is set for
    for D in (64, 257):
        ids_h, mask_h, _ = random_ell(gen, 4096, 8, 3000, 1, 0.6, device)
        hub = torch.randperm(4096 * 8, generator=gen)[:10000].to(device)
        ids_h.view(-1)[hub] = 7
        mask_h.view(-1)[hub] = 1.0
        rows.append(transpose_case(
            f"hub row of 10,000 slots, D={D}", ids_h, mask_h,
            (torch.randn((4096, D), generator=gen) / 100).to(device), 3000,
            False, 100))
    return rows


def sddmm_case(name, ids, mask, Hw, a_src, a_dst, reps):
    """One SDDMM case: the forward kernel against its plain version on the
    card, the times of both, and the bound.  No single PyTorch call computes
    the masked LeakyReLU edge logits (library_ms null)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sddmm import sddmm

    (V, K), (N, D) = ids.shape, Hw.shape
    _, row = held(name, lambda: sddmm(ids, mask, Hw, a_src, a_dst),
                  lambda: ref.sddmm_ref(ids, mask, Hw, a_src, a_dst), "sddmm")
    nz = mask > 0
    nnz = int(nz.sum())
    # Hw rows the function needs: the V dst rows and every row an unmasked
    # slot names, read once; a_src, a_dst, ids, mask read once, e written once
    touched = int(torch.unique(ids[nz]).numel())
    needed = int(torch.unique(torch.cat([
        torch.arange(V, device=ids.device, dtype=torch.int32), ids[nz]])).numel())
    least_bytes = needed * D * 4 + 2 * D * 4 + V * K * 12
    ops = 2 * D * (touched + V) + 3 * nnz  # two dots; add, compare, scale
    row.update(kernel="sddmm", case=name, V=V, K=K, N=N, D=D, nnz=nnz, tol=TOL,
               kernel_ms=cuda_ms(lambda: sddmm(ids, mask, Hw, a_src, a_dst), reps),
               plain_ms=cuda_ms(lambda: ref.sddmm_ref(ids, mask, Hw, a_src,
                                                      a_dst), max(1, reps // 4)),
               library_ms=None, **bound(least_bytes, ops))
    emit("kernel", **row)
    return row


def slot_transpose_case(name, ids, mask, dz, N, reps, plan=None,
                        diagnose=False):
    """One slot-transpose case: the kernel against its plain version on the
    card, its gradient role through `ell_slot_gather` under autograd, times
    of kernel / plain / one torch.sparse.mm call with the [N, V*K] selection
    matrix, and the bound.  With ``diagnose``, what the random reads of dz
    cost: the kernel's device time over the same plan with every slot
    folded into the first 2**23 of dz (32 MB, held in the L2), and one
    torch.index_select of dz at the plan's slots."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_spmm import ell_transpose_plan
    from repro_torch.kernels.sddmm import ell_slot_gather, ell_slot_transpose

    V, K = ids.shape
    if plan is None:
        plan = ell_transpose_plan(ids, mask, N)

    def autograd():
        col = torch.zeros(N, device=dz.device, requires_grad=True)
        return torch.autograd.grad(ell_slot_gather(col, ids, mask, plan=plan),
                                   col, dz)[0]

    want, row = held(name, lambda: ell_slot_transpose(ids, mask, dz, N, plan=plan),
                     lambda: ref.ell_slot_transpose_ref(ids, mask, dz, N),
                     "ell_slot_transpose", autograd)
    flat = torch.nonzero(mask.reshape(-1) != 0).reshape(-1)
    sel = torch.sparse_coo_tensor(
        torch.stack([ids.reshape(-1)[flat].long(), flat]),
        torch.ones(flat.numel(), device=dz.device), size=(N, V * K),
        check_invariants=True).coalesce().to_sparse_csr()
    dz_col = dz.reshape(-1, 1)
    lib_err = float((torch.sparse.mm(sel, dz_col)[:, 0] - want).abs().max())
    nnz = int(plan[1].numel())

    def kernel(plan=plan):
        return ell_slot_transpose(ids, mask, dz, N, plan=plan)

    def library():
        return torch.sparse.mm(sel, dz_col)

    # the plan (slots and indptr) and dz at each listed slot read once, g
    # written once; one add per listed slot
    least_bytes = nnz * (8 + 4) + (N + 1) * 8 + N * 4
    row.update(kernel="ell_slot_transpose", case=name, V=V, K=K, N=N, nnz=nnz,
               tol=TOL, kernel_ms=cuda_ms(kernel, reps),
               kernel_device_ms=cuda_ms(kernel, reps, queued=True),
               plain_ms=cuda_ms(lambda: ref.ell_slot_transpose_ref(ids, mask,
                                                                   dz, N),
                                max(1, reps // 4)),
               library_ms=cuda_ms(library, reps),
               library_device_ms=cuda_ms(library, reps, queued=True),
               library_max_abs_err=lib_err, **bound(least_bytes, nnz))
    if diagnose:
        folded = (plan[0], plan[1] % (1 << 23))
        row.update(dz_in_l2_device_ms=cuda_ms(lambda: kernel(folded), reps,
                                              queued=True),
                   gather_device_ms=cuda_ms(lambda: torch.index_select(
                       dz.reshape(-1), 0, plan[1]), reps, queued=True))
    emit("kernel", **row)
    return row


def dw_case(name, ids, mask, ct, H, reps):
    """One case of ell_attend's weight gradient: the dw kernel against its
    plain version on the card, the same through `ell_attend` under autograd,
    times of kernel / plain / one torch.sparse.sampled_addmm call over the
    structure's CSR (which computes exactly dw on the unmasked slots), and
    the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_spmm import ell_attend, ell_attend_dw

    V, K = ids.shape
    N, D = H.shape

    def autograd():
        w = mask.clone().requires_grad_()
        return torch.autograd.grad(ell_attend(ids, w, H), w, ct)[0]

    want, row = held(name, lambda: ell_attend_dw(ids, ct, H),
                     lambda: ref.ell_attend_dw_ref(ids, ct, H), "ell_attend_dw",
                     autograd)
    nz = mask != 0
    r, _ = nz.nonzero(as_tuple=True)
    pattern = torch.sparse_coo_tensor(
        torch.stack([r, ids[nz].long()]), torch.ones(r.numel(), device=H.device),
        size=(V, N), check_invariants=True).coalesce().to_sparse_csr()
    Ht = H.t()

    def library():
        return torch.sparse.sampled_addmm(pattern, ct, Ht, beta=0.0)

    got_lib = library()
    # the library's values, row by row of its CSR, against the plain dot
    # products of the same (row, column) pairs
    rows = torch.repeat_interleave(
        torch.arange(V, device=H.device),
        got_lib.crow_indices().diff())
    cols = got_lib.col_indices()
    lib_err = 0.0
    for c0 in range(0, rows.numel(), 1 << 20):
        rr, cc = rows[c0:c0 + (1 << 20)], cols[c0:c0 + (1 << 20)]
        lib_err = max(lib_err, float(((ct[rr] * H[cc]).sum(1)
                                      - got_lib.values()[c0:c0 + (1 << 20)])
                                     .abs().max()))
    del got_lib, rows, cols
    # every H row some slot names read once (masked slots too: dw covers
    # them), ct and ids read once, dw written once; a multiply-add per slot
    # and feature
    touched = int(torch.unique(ids).numel())
    least_bytes = touched * D * 4 + V * D * 4 + V * K * 8
    row.update(kernel="ell_attend_dw", case=name, V=V, K=K, N=N, D=D,
               nnz=int(nz.sum()), tol=TOL,
               kernel_ms=cuda_ms(lambda: ell_attend_dw(ids, ct, H), reps),
               kernel_device_ms=cuda_ms(lambda: ell_attend_dw(ids, ct, H), reps,
                                        queued=True),
               plain_ms=cuda_ms(lambda: ref.ell_attend_dw_ref(ids, ct, H),
                                max(1, reps // 4)),
               library_ms=cuda_ms(library, reps),
               library_device_ms=cuda_ms(library, reps, queued=True),
               library_max_abs_err=lib_err,
               **bound(least_bytes, 2 * V * K * D))
    emit("kernel", **row)
    return row


def padded_table(gen, rows, D, device):
    """A gather table as the engine builds one: random rows and a zero pad
    row last."""
    H = torch.randn((rows, D), generator=gen)
    H[-1] = 0.0
    return H.to(device)


def gat_kernel_phase(eng, device):
    """Every case of the GAT kernels, from the main path's own layout and
    widths down to the ragged and degenerate ones, and the ELL forward and
    transpose kernels at the fused (odd) widths of the GAT exchange."""
    gen = torch.Generator().manual_seed(2)
    ids, mask, plan = eng._consts["ids"], eng._consts["mask"], eng._consts["plan"]
    V, N = eng.Vp, eng.Vp + 1  # the gather table: every vertex + the pad row
    rows = {"sddmm": [], "ell_slot_transpose": [], "ell_attend_dw": [],
            "ell_spmm": [], "ell_spmm_transpose": []}

    def attn(D):
        return tuple((torch.randn(D, generator=gen) / D ** 0.5).to(device)
                     for _ in range(2))

    # SDDMM at the layer widths (256, then the last layer's 64)
    for D in (256, 64):
        rows["sddmm"].append(sddmm_case(f"gcn-paper layout D={D}", ids, mask,
                                        padded_table(gen, N, D, device),
                                        *attn(D), 10))
    for case, (Vr, K, Nr, D, p) in {"ragged V=1003 D=37": (1003, 7, 1004, 37, 0.6),
                                    "K=1": (4096, 1, 4097, 256, 0.9),
                                    "K=100 D=257": (3000, 100, 5000, 257, 0.7)
                                    }.items():
        ids_r, mask_r, H_r = random_ell(gen, Vr, K, Nr, D, p, device)
        rows["sddmm"].append(sddmm_case(case, ids_r, mask_r, H_r, *attn(D), 100))
    ids_a, mask_a, H_a = random_ell(gen, 2048, 16, 3000, 64, 0.5, device)
    mask_a[:512] = 0.0  # all-masked rows: every logit -1e30
    rows["sddmm"].append(sddmm_case("all-masked rows", ids_a, mask_a, H_a,
                                    *attn(64), 100))
    # Hw 4 bytes off 16-byte alignment: the 4-byte path though D % 4 == 0
    flat = torch.randn(3000 * 64 + 1, generator=gen).to(device)
    rows["sddmm"].append(sddmm_case("misaligned Hw, D=64", ids_a, mask_a,
                                    flat[1:].view(3000, 64), *attn(64), 100))

    # the slot transpose over the engine's plan, then the ragged ones
    dz = torch.randn(mask.shape, generator=gen).to(device) * mask
    rows["ell_slot_transpose"].append(slot_transpose_case(
        "gcn-paper layout", ids, mask, dz, N, 10, plan=plan, diagnose=True))
    for case, (Vr, K, Nr, p) in {"ragged V=1003": (1003, 7, 502, 0.6),
                                 "K=1": (4096, 1, 4096, 0.9),
                                 "K=100 (long segments)": (3000, 100, 5000, 0.7)
                                 }.items():
        ids_r, mask_r, _ = random_ell(gen, Vr, K, Nr, 1, p, device)
        dz_r = torch.randn(mask_r.shape, generator=gen).to(device)
        rows["ell_slot_transpose"].append(slot_transpose_case(
            case, ids_r, mask_r, dz_r, Nr, 100))
    dz_a = torch.randn(mask_a.shape, generator=gen).to(device)
    rows["ell_slot_transpose"].append(slot_transpose_case(
        "all-masked rows", ids_a, mask_a, dz_a, 3000, 100))
    # a hub row: 10,000 unmasked slots name row 7, so its segment spans many
    # staged chunks.  dz is drawn at scale 1/100, so that the hub's
    # 10,000-term sum is unit-scale, the scale the 1e-4 tolerance is set for
    # (at unit dz the sum reaches ~100, where two fp32 summation orders part
    # by about 1e-4)
    ids_h, mask_h, _ = random_ell(gen, 4096, 8, 3000, 1, 0.6, device)
    hub = torch.randperm(4096 * 8, generator=gen)[:10000].to(device)
    ids_h.view(-1)[hub] = 7
    mask_h.view(-1)[hub] = 1.0
    dz_h = (torch.randn(mask_h.shape, generator=gen) / 100).to(device)
    rows["ell_slot_transpose"].append(slot_transpose_case(
        "hub row of 10,000 slots", ids_h, mask_h, dz_h, 3000, 100))

    # dw at every width the path gives it: Hw's 256 and 64 (the attend at
    # exchange_chunks 1 reads tab[:, 1:] copied), the fused 257 and 65, and
    # the chunk widths 129 and 33 at exchange_chunks 2; then 128 and 32 (the
    # kernel's lane groups of 32 and 8 at one float4 a lane)
    w = (mask * torch.rand(mask.shape, generator=gen).to(device)).contiguous()
    for D in (256, 257, 129, 64, 65, 33, 128, 32):
        ct = torch.randn((V, D), generator=gen).to(device)
        rows["ell_attend_dw"].append(dw_case(
            f"gcn-paper layout D={D}", ids, w, ct, padded_table(gen, N, D, device),
            10))
        del ct
    for case, (Vr, K, Nr, D, p) in {"ragged V=1003 D=37": (1003, 7, 502, 37, 0.6),
                                    "K=1": (4096, 1, 4096, 256, 0.9),
                                    "K=100 D=300": (3000, 100, 5000, 300, 0.7)
                                    }.items():
        ids_r, mask_r, H_r = random_ell(gen, Vr, K, Nr, D, p, device,
                                        weighted=True)
        rows["ell_attend_dw"].append(dw_case(
            case, ids_r, mask_r, torch.randn((Vr, D), generator=gen).to(device),
            H_r, 100))
    ids_w, mask_w, H_w = random_ell(gen, 2048, 16, 3000, 64, 0.5, device,
                                    weighted=True)
    mask_w[:512] = 0.0
    ct_w = torch.randn((2048, 64), generator=gen).to(device)
    rows["ell_attend_dw"].append(dw_case("all-masked rows + weighted", ids_w,
                                         mask_w, ct_w, H_w, 100))
    flat = torch.randn(2048 * 64 + 1, generator=gen).to(device)
    rows["ell_attend_dw"].append(dw_case("misaligned ct, D=64", ids_w, mask_w,
                                         flat[1:].view(2048, 64), H_w, 100))

    # the attend forward (the ELL forward, weights in the mask lane) and its
    # dH (the transpose) at every width the path gives them: the fused
    # tables' 257 and 65, the chunks' 129 and 33 at exchange_chunks 2 (all
    # on the 4-byte path), and the last layer's 64 after the `tab[:, 1:]`
    # copy at exchange_chunks 1 (their 256 is the gcn phases' weighted case)
    for D in (257, 129, 65, 33, 64):
        table = padded_table(gen, N, D, device)
        rows["ell_spmm"].append(ell_case(f"gcn-paper layout, weighted, D={D}",
                                         ids, w, table, False, 10))
        del table
        ct = torch.randn((V, D), generator=gen).to(device)
        rows["ell_spmm_transpose"].append(transpose_case(
            f"gcn-paper layout D={D}, weighted mask", ids, w, ct, N, False, 10,
            plan=plan, diagnose=True))
        del ct
    return rows


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def attention_pairs(S: int, T: int, causal: bool) -> int:
    """The (query, key) pairs the mask leaves: key k <= query q when causal."""
    if not causal:
        return S * T
    return sum(min(q + 1, T) for q in range(S))


def flash_case(name, q, k, v, causal, reps):
    """One flash-attention case: the kernel against its plain version on
    the card at the JAX tier's tolerance for the dtype, times of kernel /
    plain / one scaled_dot_product_attention call (the yardstick only: the
    port never calls it), and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, H, S, D = q.shape
    T = k.shape[2]
    tol = FLASH_TOL[q.dtype]
    scale = None
    if q.dtype == torch.bfloat16:
        def scale(want):  # |plain| + P.|V|
            return want.float().abs() + ref.flash_attention_ref(
                q, k, v.abs(), causal=causal).float()
    want, row = held(name, lambda: flash_attention(q, k, v, causal=causal),
                     lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                     "flash_attention", tol=tol, scale=scale)
    if scale is not None:
        # the same launch held to 2**-7 |plain| alone, to show what P.|V| adds
        row["excess_without_pv"] = excess(
            flash_attention(q, k, v, causal=causal), want, tol)
    if scale is not None and not causal and T > 1:
        # a kernel that drops the last key (a ragged-tail fault): the bf16
        # tolerance must reject it; the JAX tier's is shown beside it
        wrong = ref.flash_attention_ref(q, k[:, :, :-1], v[:, :, :-1], causal=False)
        row.update(wrong_variant="last key dropped",
                   wrong_variant_excess=excess(wrong, want, tol, scale(want)),
                   wrong_variant_excess_jax_tol=excess(wrong, want,
                                                       FLASH_JAX_BF16_TOL))
        check(row["wrong_variant_excess"] > 0,
              f"flash_attention {name}: the bf16 tolerance lets a kernel that "
              f"drops the last key pass ({row['wrong_variant_excess']})")
        del wrong

    def kernel():
        return flash_attention(q, k, v, causal=causal)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)

    lib_err = float((library().float() - want.float()).abs().max())
    # q, k, v read once and o written once; a multiply-add for each of
    # q.k and p.v per unmasked pair and head dim
    elem = q.element_size()
    least_bytes = elem * B * H * D * (2 * S + 2 * T)
    ops = 4 * B * H * D * attention_pairs(S, T, causal)
    rate = BF16_TENSOR_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    row.update(kernel="flash_attention", case=name, B=B, H=H, S=S, T=T, D=D,
               causal=causal, dtype=dtype_name(q.dtype),
               kernel_ms=cuda_ms(kernel, reps),
               # the per-call time again, as the median of 7 readings: the
               # host's rate of calls varies from reading to reading
               kernel_call_ms=statistics.median(cuda_ms(kernel, reps)
                                                for _ in range(7)),
               kernel_device_ms=cuda_ms(kernel, reps, queued=True),
               plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=causal), max(1, reps // 10)),
               library_ms=cuda_ms(library, reps),
               library_device_ms=cuda_ms(library, reps, queued=True),
               library_max_abs_err=lib_err,
               **bound(least_bytes, ops, rate))
    emit("kernel", **row)
    return row


def qkv(gen, B, H, kv_heads, S, T, D, dtype, device):
    """q [B,H,S,D]; k, v drawn with kv_heads heads and expanded to H, as
    the reference's grouped-query attention hands them to the kernel."""
    q = torch.randn((B, H, S, D), generator=gen, device=device)
    k, v = (torch.randn((B, kv_heads, T, D), generator=gen, device=device)
            .repeat_interleave(H // kv_heads, dim=1) for _ in range(2))
    return tuple(t.to(dtype).contiguous() for t in (q, k, v))


def attention_phase(device):
    """The kernel API's flash_attention at llama3.2-1b width (32 heads of
    dim 64, the 8 kv heads expanded) and the train_4k sequence length:
    the main path (bf16 causal, bf16 non-causal, fp32 causal) through
    `ops.flash_attention` with launches counted from 0, then every kernel
    case, counted apart."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.llama3_2_1b import CONFIG, smoke_config
    from repro_torch.kernels import ops, ref

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32
    gen = torch.Generator(device=device).manual_seed(3)
    B, H, kv, D = 1, CONFIG.num_heads, CONFIG.num_kv_heads, CONFIG.head_dim
    S = INPUT_SHAPES["train_4k"].seq_len
    main = [(torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, True)]
    inputs = {dtype: qkv(gen, B, H, kv, S, S, D, dtype, device)
              for dtype in (torch.bfloat16, torch.float32)}
    torch.cuda.synchronize()
    zero_counts()
    outs = [ops.flash_attention(*inputs[dtype], causal=causal)
            for dtype, causal in main]
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts(launches, dict(flash_attention=len(main)), "attention")
    for (dtype, causal), out in zip(main, outs):
        check(out.shape == (B, H, S, D) and out.dtype == dtype,
              f"attention {dtype} causal={causal}: {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out).all()), "attention: non-finite output")
    del outs
    rows = []
    for dtype, causal in main:
        rows.append(flash_case(f"llama3.2-1b train_4k {dtype_name(dtype)} "
                               f"causal={causal}",
                               *inputs[dtype], causal, 20))
    del inputs
    torch.cuda.empty_cache()
    # qwen1.5-32b's attention width (src/repro/configs/qwen1_5_32b.py: 40
    # heads of dim 128), the ragged, S != T and D = 32 (the smoke config's
    # head dim) cases
    small = smoke_config()
    for case, (Hc, kvc, Sc, Tc, Dc, dtype, causal) in {
            "qwen1.5-32b width D=128 S=2048": (40, 8, 2048, 2048, 128,
                                               torch.bfloat16, True),
            "D=128 S=2048 fp32": (40, 8, 2048, 2048, 128, torch.float32, False),
            "ragged S=T=1000": (H, kv, 1000, 1000, D, torch.bfloat16, True),
            "ragged S=T=1000 fp32": (H, kv, 1000, 1000, D, torch.float32, True),
            "S=512 T=1536": (H, kv, 512, 1536, D, torch.bfloat16, False),
            "S=512 T=1536 fp32": (H, kv, 512, 1536, D, torch.float32, False),
            "smoke width D=32": (small.num_heads, small.num_kv_heads, 1024, 1024,
                                 small.head_dim, torch.bfloat16, True),
            "smoke width D=32 fp32": (small.num_heads, small.num_kv_heads, 1024,
                                      1024, small.head_dim, torch.float32, False),
            # around the query and key tiles: 127 and 129 rows and keys
            "tile edges S=T=129": (H, kv, 129, 129, D, torch.bfloat16, True),
            "tile edges S=127 T=129": (H, kv, 127, 129, D, torch.bfloat16, False),
            "tile edges S=129 T=127 fp32": (H, kv, 129, 127, D, torch.float32,
                                            True),
            "tile edges S=T=127 D=128 fp32": (40, 8, 127, 127, 128,
                                              torch.float32, False),
    }.items():
        rows.append(flash_case(case, *qkv(gen, B, Hc, kvc, Sc, Tc, Dc, dtype,
                                          device), causal, 20))
    emit("attention", model=CONFIG.name, B=B, H=H, S=S, D=D,
         cases=[f"{dtype_name(dtype)} causal={causal}" for dtype, causal in main],
         launches=launches, ms={r["case"]: r["kernel_ms"] for r in rows[:3]},
         seconds=time.perf_counter() - t0)
    return rows, launches


def wkv_case(name, r, k, v, g, u, chunk, reps, tol=WKV_TOL, want=None):
    """One WKV case: the kernel against the plain per-step recurrence on the
    clipped g (no single PyTorch call computes it: library_ms null), the
    times of both, and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv_chunk import G_MIN, wkv

    B, H, S, K = r.shape

    def plain():
        return want if want is not None else ref.wkv_chunk_ref(
            r, k, v, torch.clamp(g, G_MIN, 0.0), u)

    want, row = held(name, lambda: wkv(r, k, v, g, u, chunk=chunk), plain, "wkv",
                     tol=tol)
    # r, k, v, g, u read once and y written once; per step the recurrence's
    # flops, whatever the chunk: r . state (2K^2), the decay, k (x) v and the
    # sum (3K^2), the bonus (r u k) v (4K)
    least_bytes = r.element_size() * (5 * B * H * S * K + H * K)
    ops = B * H * S * (5 * K * K + 4 * K)
    row.update(kernel="wkv", case=name, B=B, H=H, S=S, K=K, chunk=chunk,
               dtype=dtype_name(r.dtype),
               kernel_ms=cuda_ms(lambda: wkv(r, k, v, g, u, chunk=chunk), reps),
               plain_ms=cuda_ms(lambda: ref.wkv_chunk_ref(
                   r, k, v, torch.clamp(g, G_MIN, 0.0), u), 1),
               library_ms=None, **bound(least_bytes, ops))
    emit("kernel", **row)
    return want, row


def wkv_phase(device):
    """The kernel API's wkv at rwkv6-3b width (40 heads of key dim 64,
    chunk 64) over four train_4k sequences, fp32, inputs drawn as
    tests/test_kernels.py draws them: the main path through `ops.wkv` with
    launches counted from 0, then every kernel case, counted apart."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.rwkv6_3b import CONFIG
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(4)
    B, H, K, C = 4, CONFIG.ssm_heads, CONFIG.ssm_state, CONFIG.ssm_chunk
    S = INPUT_SHAPES["train_4k"].seq_len

    def draw(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    r, k, v = (draw((B, H, S, K), 0.5) for _ in range(3))
    g = -torch.exp(draw((B, H, S, K), 0.5) - 1.0)
    u = draw((H, K), 0.1)
    torch.cuda.synchronize()
    zero_counts()
    y = ops.wkv(r, k, v, g, u, chunk=C)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts(launches, dict(wkv=1), "wkv")
    check(y.shape == (B, H, S, K) and y.dtype == r.dtype, f"wkv {y.shape}")
    check(bool(torch.isfinite(y).all()), "wkv: non-finite output")
    rows = []
    want, row = wkv_case(f"rwkv6-3b train_4k x{B} chunk={C}", r, k, v, g, u, C, 10)
    rows.append(row)
    # the chunk only regroups the same sums: 16 and 32 within the tolerance
    # of the plain version, and of chunk 64's output
    for chunk in (16, 32):
        got = ops.wkv(r, k, v, g, u, chunk=chunk)
        gap = float(((got - y).abs() - WKV_TOL[1] * y.abs()).max())
        check(gap <= WKV_TOL[0], f"wkv chunk {chunk} vs {C}: {gap}")
        rows.append(wkv_case(f"chunk={chunk}", r, k, v, g, u, chunk, 10,
                             want=want)[1])
    del want, y
    # g at the clip floor everywhere: finite at chunk 64 and past the 74 at
    # which the reference's factorised form overflows
    floor = torch.full_like(g, -1.2)
    want, row = wkv_case("g = -1.2 (clip floor)", r, k, v, floor, u, C, 10)
    rows.append(row)
    rows.append(wkv_case("g = -1.2, chunk=128", r, k, v, floor, u, 128, 10,
                         want=want)[1])
    del floor, want
    rows.append(wkv_case("g below the clip floor", r, k, v, g * 8.0, u, C, 10)[1])
    rows.append(wkv_case("bf16 inputs", *(t.bfloat16() for t in (r, k, v, g, u)),
                         C, 10, tol=WKV_BF16_TOL)[1])
    emit("wkv", model=CONFIG.name, B=B, H=H, S=S, K=K, chunk=C,
         launches=launches, ms=rows[0]["kernel_ms"],
         seconds=time.perf_counter() - t0)
    return rows, launches


def release() -> None:
    """Free what earlier phases left: an engine sits in reference cycles
    (its backend and its step hold it), so its device tables go only when
    the garbage collector runs; without this a phase's peak memory could
    count an earlier phase's engine."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_name(kind: str, model: str, group: list) -> str:
    """sweep, train (gcn), <model>_sweep, <model>_train; nccl_sweep and
    nccl_train in the world-size-1 NCCL group."""
    if group:
        return f"nccl_{kind}"
    return kind if model == "gcn" else f"{model}_{kind}"


def sweep_phase(g, chunks, device, model="gcn", group=(), baseline=None):
    """The main path: SWEEPS timed layer-wise sweeps through
    serve_gnn.run_sweep at full width, kernel launches and collective calls
    counted from 0; then the reference sweep, its launches counted apart.
    ``group``: the launcher's process-group options (the engine then runs
    over the group already joined); ``baseline``: the same phase's result
    without a group, which this one must equal bit for bit."""
    from repro_torch.core.execution import collectives
    from repro_torch.core.models.gnn import init_gnn_params
    from repro_torch.launch import serve_gnn

    name = phase_name("sweep", model, group)
    release()
    t0 = time.perf_counter()
    args = serve_gnn.parse_args([
        "--device", str(device), "--exec", "broadcast", "--model", model,
        "--exchange-chunks", str(chunks), "--hidden", "256", "--layers", "3",
        *group])
    eng = serve_gnn.build_engine(args, g)
    params = init_gnn_params(model, eng.dims, torch.Generator().manual_seed(0),
                             eng.device)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.zero_calls()
    embs, walls = [], []
    for _ in range(SWEEPS):
        emb, wall = serve_gnn.run_sweep(eng, params)
        embs.append(emb)
        walls.append(wall)
    launches = read_counts()
    calls = collectives.read_calls()
    peak = torch.cuda.max_memory_allocated()
    L = len(eng.dims) - 1
    # a sweep runs the forward kernel per layer and chunk and no backward;
    # in a group an all_gather per layer and chunk, then one of the output
    check_counts(launches, dict(ell_spmm=L * chunks * SWEEPS),
                 f"{name} {model}")
    check_calls(calls, dict(all_gather=(L * chunks + 1) * SWEEPS)
                if group else {}, f"{name} {model}")
    emb = embs[-1]
    check(emb.shape == (g.num_vertices, eng.dims[-1]), f"shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite embeddings")
    bitwise = all(np.array_equal(e, embs[0]) for e in embs[1:])
    check(bitwise, "sweeps are not bitwise equal")
    zero_counts()
    ref = eng.global_embeddings(eng.infer_full_graph(params=params,
                                                     reference=True))
    ref_launches = read_counts()
    check_counts(ref_launches, reference_launches(model, L, 1, backward=False),
                 f"{model} reference sweep")
    err = float(np.max(np.abs(emb - ref)))
    check(err <= TOL, f"sweep vs reference sweep: {err} > {TOL}")
    median_s = float(np.median(walls))
    result = dict(emb=emb, median_ms=median_s * 1e3)
    extra = {}
    if baseline is not None:
        extra = compare_baseline(name, result, baseline, ("emb",))
    emit(name, model=model,
         exchange_chunks=chunks, vertices=g.num_vertices, K=eng.K,
         dims=eng.dims, sweeps=SWEEPS, walls_ms=[w * 1e3 for w in walls],
         median_ms=median_s * 1e3, vertices_per_s=g.num_vertices / median_s,
         launches=launches, reference_launches=ref_launches,
         launches_per_sweep=launches["ell_spmm"] / SWEEPS,
         collective_calls=calls, bitwise_equal_sweeps=bitwise,
         oracle_max_abs_err=err, oracle_tol=TOL,
         inference_bytes=eng.comm_stats.inference_bytes,
         max_memory_allocated=peak, setup_s=setup_s, **extra)
    add_counts(launches, ref_launches)
    return eng, params, launches, result


def train_phase(g, chunks, device, model="gcn", group=(), baseline=None):
    """The training path: TRAIN_STEPS timed steps through
    train_gnn.run_training at full width, kernel launches and collective
    calls counted from 0; then a second run from the same initial state with
    the single-device reference run (per-step loss gap <= TOL), which must
    be bitwise equal to the first in losses and in every parameter.
    ``group`` and ``baseline`` as in `sweep_phase`."""
    from repro_torch.core.execution import collectives
    from repro_torch.core.models.gnn import PARAM_KEYS
    from repro_torch.launch import train_gnn

    name = phase_name("train", model, group)
    lr = TRAIN_LR[model]
    release()
    t0 = time.perf_counter()
    args = train_gnn.parse_args([
        "--device", str(device), "--exec", "broadcast", "--protocol", "sync",
        "--model", model, "--exchange-chunks", str(chunks), "--hidden", "256",
        "--layers", "3", "--lr", str(lr), *group])
    eng = train_gnn.build_engine(args, g)  # the transpose plan included
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.zero_calls()
    run = train_gnn.run_training(eng, TRAIN_STEPS)
    launches = read_counts()
    calls = collectives.read_calls()
    peak = torch.cuda.max_memory_allocated()
    L = len(eng.dims) - 1
    step_want = step_launches(model, L, chunks, TRAIN_STEPS)
    check_counts(launches, step_want,
                 f"{name} {model}, {TRAIN_STEPS} steps")
    check_calls(calls, step_calls(model, L, chunks, TRAIN_STEPS)
                if group else {}, f"{name} {model}, {TRAIN_STEPS} steps")
    losses = run["losses"]
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"the loss did not fall at every step: {losses}")
    logits = run["logits"]
    check(tuple(logits.shape) == (eng.Vp, eng.dims[-1]), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    train_acc, test_acc = eng.accuracy(logits, "train"), eng.accuracy(logits, "test")
    params, walls = run["state"]["params"], run["walls"]
    del run, logits
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.zero_calls()
    again = train_gnn.run_training(eng, TRAIN_STEPS, oracle_check=True)
    again_launches = read_counts()
    ref_peak = torch.cuda.max_memory_allocated()
    want = dict(step_want)
    add_counts(want, reference_launches(model, L, TRAIN_STEPS, backward=True))
    check_counts(again_launches, want, f"{name} {model} with its reference")
    # the reference runs no collective
    check_calls(collectives.read_calls(), step_calls(
        model, L, chunks, TRAIN_STEPS) if group else {},
        f"{name} {model} with its reference")
    keys = PARAM_KEYS[model]
    bitwise = again["losses"] == losses and all(
        torch.equal(a[key], b[key]) for a, b in
        zip(params["layers"], again["state"]["params"]["layers"])
        for key in keys)
    check(bitwise, "two training runs from the same state differ")
    gaps = [abs(a - b) for a, b in zip(losses, again["ref_losses"])]
    check(max(gaps) <= TOL, f"step vs reference step: {gaps} > {TOL}")
    median_s = float(np.median(walls))
    result = dict(losses=losses, median_ms=median_s * 1e3, params=[
        {key: p[key].cpu() for key in keys} for p in params["layers"]])
    extra = {}
    if baseline is not None:
        extra = compare_baseline(name, result, baseline, ("losses", "params"))
    emit(name, model=model,
         exchange_chunks=chunks, vertices=g.num_vertices, K=eng.K,
         dims=eng.dims, lr=lr, steps=TRAIN_STEPS, losses=losses,
         ref_losses=again["ref_losses"], loss_gaps=gaps, oracle_tol=TOL,
         walls_ms=[w * 1e3 for w in walls],
         walls_second_run_ms=[w * 1e3 for w in again["walls"]],
         median_step_ms=median_s * 1e3, steps_per_s=1.0 / median_s,
         train_acc=train_acc, test_acc=test_acc, launches=launches,
         launches_with_reference=again_launches, collective_calls=calls,
         param_keys=list(keys), bitwise_equal_runs=bitwise,
         max_memory_allocated=peak,
         max_memory_allocated_with_reference=ref_peak, setup_s=setup_s,
         **extra)
    add_counts(launches, again_launches)
    return eng, launches, result


def trace(fn):
    """torch.profiler trace of one call of fn, after one untraced warm-up
    cycle of the profiler: each device span (start, end, name), the count
    and microseconds by kernel name, and the call's wall microseconds."""
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
    check(len(traced) == 1, "expected one traced cycle")
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
    return spans, by_name, wall_us


def profile_phase(phase, fn, kernels, **fields):
    """A trace of one call of fn (`trace`): device busy time, idle share,
    the longest idle gaps, and the kernels that took the time.  ``kernels``
    maps each kernel that must appear to its launches in one call, which the
    trace must hold exactly (a trace that lost events would understate the
    busy time).  The profiler now and then drops a kernel record from a
    trace: a trace that falls short is taken again, up to TRACE_ATTEMPTS
    times, and the phase fails if none holds every launch."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        spans, by_name, wall_us = trace(fn)
        held_launches = {kernel: sum(c for name, (c, _) in by_name.items()
                                     if kernel in name) for kernel in kernels}
        if held_launches == kernels:
            break
    check(held_launches == kernels, f"{phase}: {TRACE_ATTEMPTS} traces, the "
          f"last holds launches {held_launches}, expected {kernels}")
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]
    emit(phase, **fields, trace_attempts=attempt, traced_wall_ms=wall_us / 1e3,
         device_busy_ms=busy_us / 1e3,
         device_idle_share=max(0.0, 1.0 - busy_us / wall_us),
         longest_idle_gaps=[dict(us=g, after=a[:80], before=b[:80])
                            for g, a, b in sorted(gaps, reverse=True)[:3]],
         kernels=[dict(name=n[:120], count=c, ms=us / 1e3)
                  for n, (c, us) in top],
         other_kernels_ms=sum(us for _, (_, us) in by_name.items()) / 1e3
         - sum(us for _, (_, us) in top) / 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jsonl", help="also append every phase line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.core.graph import er_graph
    from repro_torch.kernels import build
    from repro_torch.launch import train_gnn
    from repro_torch.launch.common import join_group, leave_group

    if args.jsonl:
        os.makedirs(os.path.dirname(os.path.abspath(args.jsonl)), exist_ok=True)
        JSONL.append(args.jsonl)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build(list(SOURCES))  # one nvcc per source, all together
    emit("build", seconds=time.perf_counter() - t0, kernels=built)

    launches, rows = {}, {}
    # the kernel API's language-model kernels at model width, each driven
    # with the counts from 0, then their kernel cases
    rows["flash_attention"], n = attention_phase(device)
    add_counts(launches, n)
    rows["wkv"], n = wkv_phase(device)
    add_counts(launches, n)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    g = er_graph(CONFIG.num_vertices, avg_degree=CONFIG.avg_degree,
                 feature_dim=CONFIG.feature_dim,
                 num_classes=CONFIG.num_classes, seed=0)
    emit("graph", generator="er_graph", vertices=g.num_vertices,
         edges=g.num_edges, seconds=time.perf_counter() - t0)

    baselines = {}  # the no-group results the NCCL phases must equal
    for model in MODELS:
        for chunks in (1, 2):
            eng, params, n, result = sweep_phase(g, chunks, device, model)
            add_counts(launches, n)
            if model in NCCL_MODELS and chunks == NCCL_CHUNKS:
                baselines["sweep", model] = result
            if chunks == 1:
                L = len(eng.dims) - 1
                # kernel cases at the main path's own layout, counted apart
                if model == "gcn":
                    rows.update(ell_spmm=kernel_phase(eng, device),
                                ell_spmm_transpose=transpose_phase(eng, device))
                    profile_phase("profile",
                                  lambda: eng.infer_full_graph(params=params),
                                  {"ell_spmm_kernel": L}, exchange_chunks=1)
                else:
                    for name, extra in gat_kernel_phase(eng, device).items():
                        rows[name] = rows.get(name, []) + extra
            del eng, params
            torch.cuda.empty_cache()
    for model in MODELS:
        for chunks in (1, 2):
            eng, n, result = train_phase(g, chunks, device, model)
            add_counts(launches, n)
            if model in NCCL_MODELS and chunks == NCCL_CHUNKS:
                baselines["train", model] = result
            if chunks == 1 or model == "gat":
                step, state = eng.make_step(), eng.init_state()
                L = len(eng.dims) - 1
                expect = {f"{name}_kernel": count for name, count in
                          step_launches(model, L, chunks, 1).items()}
                profile_phase("train_profile" if model == "gcn"
                              else f"{model}_train_profile",
                              lambda: step(state), expect,
                              exchange_chunks=chunks)
                del step, state
            del eng
            torch.cuda.empty_cache()
    # the same paths over a world-size-1 NCCL group, joined through the
    # launchers' group options: the all_gather, its reduce-scatter and the
    # all_reduce run on the card; bitwise equal to the runs without a group
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    group = ["--world-size", "1", "--rank", "0", "--init-method",
             f"file://{rendezvous}/rendezvous"]
    group_args = train_gnn.parse_args(["--device", "cuda", *group])
    join_group(group_args)
    try:
        emit("nccl_group", backend=torch.distributed.get_backend(),
             world_size=torch.distributed.get_world_size(),
             note="one rank on one card: the collectives are checked, not "
                  "timed as wire transfers")
        for model in NCCL_MODELS:
            eng, _, n, _ = sweep_phase(g, NCCL_CHUNKS, device, model, group,
                                       baselines["sweep", model])
            add_counts(launches, n)
            del eng
            eng, n, _ = train_phase(g, NCCL_CHUNKS, device, model, group,
                                    baselines["train", model])
            add_counts(launches, n)
            del eng
            torch.cuda.empty_cache()
    finally:
        leave_group(group_args)
        shutil.rmtree(rendezvous, ignore_errors=True)
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    summary = []
    for name, (source, replaces) in KERNELS.items():
        kernel_rows = rows[name]
        main_row = kernel_rows[0]  # the main path's own shape and width
        summary.append(dict(
            name=name, route="cuda", source=SOURCES[source],
            replaces=replaces, launches=launches[name],
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
