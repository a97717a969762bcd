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
counted from 0 around each drive; a configuration's sweep and training
step share one engine, built through the training launcher's options (its
layout and transpose plans take seconds of host work).  These run the
broadcast exchange over the hash partition (at one rank every partitioner
gives part 0, and metis_like's host loops would take minutes at 2**20
vertices).  Then gcn and
gat at exchange_chunks 2 under the p2p halo exchange, the engine's default
(phases `p2p_sweep`, `p2p_train`, and one traced step each,
`p2p_train_profile`): at one rank the p2p table is the broadcast table
with one unread halo row, so each must equal the same model's broadcast
phase bit for bit.  Then gcn and gat under the ring (`ring_sweep`,
`ring_train`, `gat_ring_sweep`, `gat_ring_train`, and one traced gat step,
`gat_ring_train_profile`; the ring ignores exchange_chunks): at one rank
its one round reads the rank's own block with the broadcast kernels, so
each must equal the broadcast phase at exchange_chunks 1 bit for bit.  Then
gcn at the p2p settings under the three historical-embedding protocols
(`async_train`, one per protocol): at one rank no row is a boundary row, so
each must equal `p2p_train` bit for bit, each step's history must be the
reference step's from the same state within 1e-4, the ages its, and no row
pushed.  Last, gcn and gat
once more inside a world-size-1 NCCL group joined through the launchers'
group options, broadcast at exchange_chunks 2, p2p at 2 and the ring
(phases `nccl_sweep`, `nccl_train`, `nccl_p2p_sweep`, `nccl_p2p_train`,
`nccl_ring_sweep`, `nccl_ring_train`): the all_gather, its reduce-scatter,
the all_to_all and the all_reduce run on the card (the ring issues no
rotation at one rank), every collective call is counted, and the results
must equal the runs without a group bit for bit (one rank: the collectives
are copies on the card, no wire time).  Then the replica families at
the same width, the partition families the survey sets beside edge cut:
gcn and gat under the cartesian2d vertex cut, p2p at exchange_chunks 2,
broadcast at 1 and the ring (phases `vc_p2p_sweep`, `vc_p2p_train`,
`vc_broadcast_*`, `vc_ring_*`, `gat_vc_*`, and one traced gat step,
`gat_vc_train_profile`), under the PowerLyra hybrid cut at p2p, chunks 2,
the default hub threshold (`hybrid_p2p_*`, `gat_hybrid_p2p_*`), and the
vertex cut's p2p once more in the world-size-1 NCCL group (`nccl_vc_p2p_*`,
bitwise equal to the runs without a group).  At one rank the replica
combine reads one replica a vertex, so each replica phase is also held to
the same model's edge-cut phase of this run (the family anchor: losses and
sweep within 1e-4; gcn's bit for bit, gat's not, its stabilizer is floored
at 0).  Last, the sampled mini-batch step at the same width (MB_SAMPLERS:
node-wise batch 64 with fanouts 15, 10, 5, layer-wise 4096 a layer,
subgraph 1024 roots and walks of 4; lr MB_LR; MB_STEPS batches): gcn
node-wise under p2p through `run_epoch_minibatch` (phase `mb_node_p2p`, with the epoch's
sample, extract and train seconds, and a second `sample_minibatch(0)`
equal array for array) and one traced step of it (`mb_train_profile`);
sage, gin and gat over the same batches (`mb_node_sage`, `mb_node_gin`,
`mb_node_gat`) and gcn in a world-size-1 NCCL group (`nccl_mb_node_p2p`,
bitwise equal to `mb_node_p2p`, its all_to_all and all_reduce calls
counted); the pipelined epoch over the same traffic with the prefetch
thread (`mb_node_pipelined`) and the pool of sampling processes over a
shared-memory ring (`mb_node_process`, then a second epoch on the same
pool, its LRU serving every batch, then a steady epoch, the LRU emptied,
and the pool closed with no segment left), each bitwise equal to
`mb_node_p2p` (losses, params, CommStats), with its StageTimes beside
`pipelined_wall_model`; gcn under broadcast and the ring
(`mb_node_broadcast`, `mb_node_ring`: MB_BASELINE_STEPS each, bitwise
equal to `mb_node_p2p`'s first at one rank), layer-wise and subgraph under p2p
(`mb_layer_p2p`, `mb_subgraph_p2p`); and `serve_gnn`'s path (`mb_serve`:
a node-wise engine trains, then sweeps, bitwise equal to a full-graph
engine's sweep of the same params).  Each mini-batch phase runs twice
from the same state (bitwise equal), each step of the second run beside
the reference step from the same state (loss and target logits within
1e-4), with the ELL forward's launches (p2p's K = 1 send gather, a chunk and an
installment a step; none in the reference) counted exactly.  Streaming
ingest and trainable features: right after the graph, `stream_ingest`
(host only) builds the edge-cut layout for 4 hash parts from the graph
as 16 chunks of 2**20 edges and holds it array for array to the
in-memory layout; after the protocol phases, `trainable_train` (gcn, p2p
at chunks 2, 5 steps, layer-0 rows learnable, row-sparse AdamW at
embed_eps TRAINABLE_EMBED_EPS) and `trainable_vc_train` (the cartesian2d
vertex cut, 3 steps) hold each step to the reference step from the same
state (loss, logits, the embed, emb_m and emb_v tables, emb_t exact), a
rerun bitwise, the store unchanged, with the row AdamW's own ms, one
traced step, the trained sweep against the reference sweep and (edge
cut) the `publish_embeddings` handoff to a frozen engine bit for bit;
before `mb_serve`, `mb_trainable` (node-wise gcn, p2p, the static_degree
cache, MB_TRAINABLE_STEPS batches) the same with the fetch's K = 1
forward and transpose launches counted per gather and the untouched rows
frozen.  Then the
query-serving latency tier on serve_gnn's node-wise engine at the same
width (QUERY_SAMPLER: batch 16, fanouts 15, 10, 5; the static_degree
cache at 1024 rows; seeded params): `query_stream` runs
`serve_gnn.run_query_stream` (a warm-up and QUERY_STREAM queries of
QUERY_TARGETS targets) and one flush of QUERY_FLUSH_REQUESTS overlapping
requests through `GNNQueryEngine`, with qps, p50 and p99 ms, each round's
host build and synchronized serve ms and the ELL forward's launches
counted exactly (no other kernel); a second `GNNQueryEngine` over the
same engine replays it bit for bit, its first QUERY_REF_ROUNDS rounds
each within 1e-4 of `reference_round`, one round shape throughout.
`traced` enables the run-wide telemetry on that engine: TRACED_STEPS
pipelined (thread) steps and a coalesced flush held to the reference's
trace contract (exchange-span bytes equal to `CommStats.total()`, the
``comm.*`` counters to their fields, every step's spans, two lanes, the
run summary JSON, the Chrome trace read back), then the full-graph p2p
step timed with the telemetry off, on, on, off: the traced median within
TRACED_OVERHEAD of the untraced one.  Last, `autotune_validate`: the
autotuner enumerates, chooses and validates a plan on an SBM graph of
AUTOTUNE_GRAPH's size at k = 1, its dryrun on the card (every
prediction 0 bytes, every balance 1.0; the four-rank proof is the CPU
tier).  Each phase prints one JSON line; the next-to-last lines
are the per-kernel summary and the card's name and power limit from
nvidia-smi, and the last line is {"ok": true, "device": {...}}; with
``--jsonl PATH`` every phase line is also appended to PATH.  Any failed check
raises, so the script exits non-zero and prints no result.  It needs a CUDA
card and the repository's `src/` beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
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
# the full-graph training phases' steps: 5 until PR 30, cut to 3 to make
# room for the latency tier's phases (each step is held to its reference
# step, about 0.5 s a step at this width)
TRAIN_STEPS = 3
# the loss falls at every step at this width: gcn overshoots from lr 0.3;
# gat fell at every step from 0.05 to 10 on the CPU at this width (2**14
# vertices) and diverged at 20; on the CPU at 2**14 vertices sage fell at
# every step from 0.05 to 0.3 and rose at 1.0, gin fell from 0.05 to 3.0,
# most in 5 steps at 0.1; at 0.1 both fell at every step on the H100 at
# this width (sage 4.51 to 3.65, gin 4.28 to 4.08)
TRAIN_LR = {"gcn": 0.1, "sage": 0.1, "gin": 0.1, "gat": 1.0}
MODELS = ("gcn", "sage", "gin", "gat")
# the models and exchange_chunks the world-size-1 NCCL group runs; the ring
# runs the same models and ignores exchange_chunks
NCCL_MODELS, NCCL_CHUNKS = ("gcn", "gat"), 2
# the sampled mini-batch phases: 3 steps (5 until the latency tier's
# phases needed the room: each node-wise batch costs 5-6 s of host work in
# every phase that samples it; 1 for the broadcast and ring phases, held to
# the p2p phase's first; 1 training step before mb_serve's sweep; 2, 2
# and 2 before PR 30).  Node-wise: DGL's GraphSAGE fan_out 5,10,15 written
# target layer first, as `fanouts` are, its batch of 1000 cut to 64 (dense
# padded blocks: caps [67584, 11264, 1024, 64], a first block of
# 11264 x 67584 fp32, 3.04 GB; at 1000 targets about 740 GB).  Layer-wise:
# 4096 vertices a layer, batch 512; subgraph: 1024 roots, walks of 4.
MB_STEPS, MB_BASELINE_STEPS, MB_SERVE_STEPS = 3, 1, 1
# the pipelined phases: the reference driver's defaults (two batches
# ahead; two sampling processes, a 3.09 GB ring slot each at node-wise)
MB_PREFETCH_DEPTH, MB_SAMPLE_WORKERS = 2, 2
SHM_RATE_BYTES = 1 << 29  # the array `shm_rates` moves (512 MiB)
# every model's mini-batch lr: each step draws a new batch, so the loss
# need not fall; on the CPU at 4096 vertices gat's rose to 136 at lr 1.0
MB_LR = 0.1
MB_SAMPLERS = {
    "node_wise": ["--batch-size", "64", "--fanouts", "15,10,5"],
    "layer_wise": ["--batch-size", "512", "--layer-sizes", "4096,4096,4096"],
    "subgraph": ["--batch-size", "1024", "--walk-length", "4"],
}
# streaming ingest: the edge stream's chunk and the parts it is shuffled to
STREAM_CHUNK, STREAM_PARTS = 1 << 20, 4
# the trainable-feature phases: steps of the edge-cut and vertex-cut
# full-graph phases, batches of the mini-batch one and its cache capacity
TRAINABLE_STEPS, TRAINABLE_VC_STEPS = 5, 3
# the full-graph trainable phases' AdamW eps.  Their reference step sums
# in another order, so a pre-activation within rounding of 0 can take the
# other side of a ReLU there and move a layer-0 gradient entry by a finite
# amount (~7e-7 at 4096 vertices on the CPU, where the step is within
# 1e-10 of a float64 reference); AdamW maps a gradient entry g to about
# lr * g / (|g| + eps), which at the default eps 1e-8 turns such a gap into
# up to 2 * lr on the table.  At 1e-3 a gradient gap of d moves the table
# by at most lr * d / eps, so the table is held to the reference within
# TOL like the moments are
TRAINABLE_EMBED_EPS = 1e-3
MB_TRAINABLE_STEPS, MB_TRAINABLE_CACHE = 1, 32  # 2 batches until PR 30
# the latency tier (`query_stream`, `traced`): serve_gnn's node-wise gcn
# engine, p2p at chunks 1, the mini-batch cells' fan-outs at batch 16 (a
# first block of 2816 x 16896 fp32, 190 MB: at the cells' batch 64 it is
# 3.04 GB and 5.4 s of host work a round, which a latency stream cannot
# pay), the static_degree cache at 1024 rows, the seeded initial params.
# The stream: a warm-up, QUERY_STREAM single-request queries of
# QUERY_TARGETS targets, then one flush of QUERY_FLUSH_REQUESTS requests of
# QUERY_TARGETS targets drawn from QUERY_FLUSH_POOL vertices (so they
# overlap); the first QUERY_REF_ROUNDS rounds are held to the reference
# round
QUERY_SAMPLER = ["--batch-size", "16", "--fanouts", "15,10,5"]
QUERY_CACHE = 1024
QUERY_STREAM, QUERY_TARGETS = 64, 8
QUERY_FLUSH_REQUESTS, QUERY_FLUSH_POOL = 16, 64
QUERY_REF_ROUNDS = 4
# `traced`: pipelined (thread) steps and the full-graph steps timed with
# the telemetry on and off; the traced median may exceed the untraced one
# by TRACED_OVERHEAD at most (the reference's `bench_gnn --telemetry`
# contract)
TRACED_STEPS, TRACED_TRAIN_STEPS, TRACED_OVERHEAD = 3, 5, 0.05
# `autotune_validate`: the autotuner on a graph a planner would score in
# seconds, at k = 1
AUTOTUNE_GRAPH = dict(num_vertices=4096, num_blocks=8, p_in=0.02,
                      p_out=0.001, seed=0)
AUTOTUNE_HIDDEN = 64
# the historical-embedding protocols, each run with gcn at the p2p phases'
# settings
ASYNC_PROTOCOLS = ("epoch_fixed", "epoch_adaptive", "variation")
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
# the kernel a profile trace counts for each wrapper's launch, where it is
# not <wrapper>_kernel
TRACE_NAMES = {"sddmm": "sddmm_slot_kernel"}
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
WKV_TILE = 32  # steps a tile of the wkv kernel (csrc/wkv_chunk.cu kTile)


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


def step_launches(model: str, L: int, C: int, T: int, sends: int = 0) -> dict:
    """Launches of T training steps.  gcn: the forward per layer and chunk,
    the transpose for layers 1.. (layer 0 aggregates the constant features).
    gat: the attend forward, its transpose and its dw per layer and chunk
    (layer 0's Hw depends on w), and one slot transpose per layer for the
    attention column's gather (chunk 0 only).  sage and gin launch gcn's.
    p2p adds ``sends`` send gathers (the forward at K = 1, one per
    installment) to every exchange, and their transposes wherever the
    table's transpose runs."""
    per = 1 + sends
    if model != "gat":
        return dict(ell_spmm=L * C * per * T,
                    ell_spmm_transpose=(L - 1) * C * per * T)
    return dict(ell_spmm=L * C * per * T, ell_spmm_transpose=L * C * per * T,
                ell_attend_dw=L * C * T, ell_slot_transpose=L * T)


def replica_launches(eng, T: int, backward: bool) -> dict:
    """Launches of T replica-family steps (``backward``) or sweeps.  A
    layer: the owned-edge partial (the forward, and for gat the SDDMM and
    the attend), then, with replicas, the combine: broadcast the forward
    over rep_ids per chunk; the ring one single-slot gather per round (one
    round at k = 1, unchunked); p2p per chunk the B1 phase-1 send gathers,
    the masters' forward over gather_ids, the B2 phase-2 send gathers and
    the single-slot scatter gather.  gat's max combine adds p2p's B1 + B2
    send gathers (unchunked; broadcast and the ring gather it plainly) and
    no backward.  Each forward whose table needs a gradient (not layer 0's
    constant features for gcn, sage, gin) has its transpose; gat's SDDMM
    its slot transpose, its attend the dw."""
    c, lay = eng.cfg, eng.playout
    L = len(eng.dims) - 1
    B1 = B2 = 0
    if c.execution == "p2p" and lay.sync_active:
        B1, B2 = (lay._vc_plan[key].shape[1] for key in ("send1", "send2"))
    C = 1 if c.execution == "ring" else c.exchange_chunks
    combine = {"broadcast": C, "ring": 1, "p2p": C * (B1 + B2 + 2)}[
        c.execution] if lay.sync_active else 0
    check(not lay.halo_active, f"{eng.k} rank(s): a halo at one rank")
    if c.model != "gat":
        return dict(ell_spmm=L * (1 + combine) * T,
                    ell_spmm_transpose=(L - 1) * (1 + combine) * T
                    if backward else 0)
    max_sends = B1 + B2
    return dict(ell_spmm=L * (1 + combine + max_sends) * T, sddmm=L * T,
                ell_spmm_transpose=L * (1 + combine) * T if backward else 0,
                ell_attend_dw=L * T if backward else 0,
                ell_slot_transpose=L * T if backward else 0)


def replica_calls(eng, T: int, train: bool) -> dict:
    """Collective calls of T replica-family steps (``train``; then the
    all_gather of the last logits) or T sweeps (each then the all_gather
    of its output rows) in a process group, at one rank: p2p per layer
    and chunk the combine's B1 + B2 all_to_all installments (gat adds its
    max combine's, unchunked), and their reverse all_to_alls in the
    backward wherever the combine's input needs a gradient; broadcast an
    all_gather per layer and chunk (gat one more for the max) and a
    reduce-scatter per layer and chunk in the backward; the ring no
    rotation at k = 1.  One all_reduce a step."""
    c, lay = eng.cfg, eng.playout
    L = len(eng.dims) - 1
    grad_layers = L if c.model == "gat" else L - 1
    gat = int(c.model == "gat")
    if c.execution == "ring" or not lay.sync_active:
        fwd, bwd, key, back = 0, 0, "all_gather", "reduce_scatter"
    elif c.execution == "p2p":
        per = sum(lay._vc_plan[key].shape[1] for key in ("send1", "send2"))
        fwd = L * per * (c.exchange_chunks + gat)
        bwd = grad_layers * per * c.exchange_chunks
        key = back = "all_to_all"
    else:
        fwd = L * (c.exchange_chunks + gat)
        bwd = grad_layers * c.exchange_chunks
        key, back = "all_gather", "reduce_scatter"
    if not train:
        out = {key: fwd * T}
        out["all_gather"] = out.get("all_gather", 0) + T
        return out
    out = {key: fwd * T}
    out[back] = out.get(back, 0) + bwd * T
    out["all_gather"] = out.get("all_gather", 0) + 1
    out["all_reduce"] = T
    return out


def anchor_fields(name: str, result: dict, edge: dict, key: str) -> dict:
    """The family anchor: at one rank the replica phase computes the global
    GNN, so its ``key`` ("emb" of a sweep, "losses" of a training run)
    must be within TOL of the same model's edge-cut phase of this run; the
    gap is reported, and whether it is 0.0."""
    a, b = np.asarray(result[key]), np.asarray(edge[key])
    gap = float(np.max(np.abs(a - b)))
    check(gap <= TOL, f"{name}: {key} {gap} from the edge-cut phase > {TOL}")
    return dict(anchor_gap=gap, anchor_bitwise=gap == 0.0,
                anchor_tol=TOL)


def check_calls(got: dict, want: dict, what: str) -> None:
    want = {name: want.get(name, 0) for name in got}
    check(got == want, f"{what}: collective calls {got}, expected {want}")


def step_calls(model: str, L: int, C: int, T: int, installments: int = 0,
               execution: str = "broadcast", k: int = 1) -> dict:
    """Collective calls of T training steps in a process group, then the
    all_gather of the last logits.  broadcast: an all_gather per layer and
    chunk, a reduce-scatter (its backward) per layer and chunk whose table
    needs a gradient (as the transpose: not layer 0's constant features,
    but gat's Hw).  p2p: an all_to_all per layer, chunk and installment,
    and its reverse all_to_all wherever broadcast reduce-scatters.  ring:
    k - 1 rotations a layer and k - 1 reverse rotations wherever broadcast
    reduce-scatters (none at k = 1).  All: one flat all_reduce of the loss,
    the rows pushed and the gradients a step."""
    grad_layers = L if model == "gat" else L - 1
    if execution == "ring":
        return dict(ppermute=(L + grad_layers) * (k - 1) * T, all_gather=1,
                    all_reduce=T)
    if installments:
        return dict(all_to_all=(L + grad_layers) * C * installments * T,
                    all_gather=1, all_reduce=T)
    return dict(all_gather=L * C * T + 1, reduce_scatter=grad_layers * C * T,
                all_reduce=T)


def compare_baseline(name: str, result: dict, baseline: dict, keys,
                     against: str = "no_group") -> dict:
    """The phase's result against the same phase without a process group
    (``against`` "no_group"), under broadcast ("broadcast": at one rank the
    p2p table is the broadcast table with one unread halo row, and the ring
    reads the rank's own block in one round) or under sync ("sync": at one
    rank no row is a boundary row, so a protocol reads every row fresh):
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
              f"{name}: {key} differs from the {against} run")
    out = {f"bitwise_equal_to_{against}": True,
           f"{against}_median_ms": baseline["median_ms"]}
    if against == "no_group":
        out["timing_note"] = ("world-size-1 NCCL group: each collective is a "
                              "copy on the card, no wire time")
    return out


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


def wkv_case(name, r, k, v, g, u, chunk, reps, tol=WKV_TOL, want=None,
             plain_ms=None):
    """One WKV case: the kernel against the plain per-step recurrence on the
    clipped g (no single PyTorch call computes it: library_ms null), the
    times of both (the plain version's from the one call that checks the
    kernel), and the bound.  ``want`` and ``plain_ms``, where given, are the
    plain version's output and time on these same inputs from an earlier
    case (the chunk reaches only the kernel).  Returns the plain
    output, the row (emitted by `wkv_phase` once the trace has given its
    device time) and the call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv_chunk import G_MIN, wkv

    B, H, S, K = r.shape
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def plain():  # timed: the recurrence takes about 0.4 s at S = 4096
        if want is not None:
            return want
        events[0].record()
        out = ref.wkv_chunk_ref(r, k, v, torch.clamp(g, G_MIN, 0.0), u)
        events[1].record()
        return out

    def kernel():
        return wkv(r, k, v, g, u, chunk=chunk)

    given = want is not None
    want, row = held(name, kernel, plain, "wkv", tol=tol)
    if not given:
        plain_ms = events[0].elapsed_time(events[1])
    # r, k, v, g, u read once and y written once; per step the recurrence's
    # flops, whatever the chunk: r . state (2K^2), the decay, k (x) v and the
    # sum (3K^2), the bonus (r u k) v (4K)
    least_bytes = r.element_size() * (5 * B * H * S * K + H * K)
    ops = B * H * S * (5 * K * K + 4 * K)
    kernel_ms = cuda_ms(kernel, reps)
    row.update(kernel="wkv", case=name, B=B, H=H, S=S, K=K, chunk=chunk,
               dtype=dtype_name(r.dtype), kernel_ms=kernel_ms,
               # the kernel walks S in tiles of WKV_TILE steps, whatever the
               # chunk: the time a CTA spends on one
               tile_us=kernel_ms * 1e3 / -(-S // WKV_TILE),
               plain_ms=plain_ms, library_ms=None, **bound(least_bytes, ops))
    return want, row, kernel


def wkv_device_ms(calls) -> list:
    """Each call's kernel time on the device from one profiler trace of all
    of them in turn (`trace`), taken again up to TRACE_ATTEMPTS times until
    it holds one wkv kernel a call."""
    for _ in range(TRACE_ATTEMPTS):
        spans, _, _ = trace(lambda: [call() for call in calls])
        ms = [(t - s) / 1e3 for s, t, name in sorted(spans)
              if "wkv_chunk_kernel" in name]
        if len(ms) == len(calls):
            return ms
    check(False, f"wkv: {TRACE_ATTEMPTS} traces, the last holds {len(ms)} "
          f"kernels for {len(calls)} calls")


def wkv_phase(device):
    """The kernel API's wkv at rwkv6-3b width (40 heads of key dim 64,
    chunk 64) over four train_4k sequences, fp32, inputs drawn as
    tests/test_kernels.py draws them: the main path through `ops.wkv` with
    launches counted from 0, then every kernel case, counted apart, each
    row with its device time from one profiler trace of them all."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.rwkv6_3b import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv_chunk import kernel_resources

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
    cases = []  # (row, call)
    want, row, call = wkv_case(f"rwkv6-3b train_4k x{B} chunk={C}", r, k, v, g,
                               u, C, 10)
    cases.append((row, call))
    # the chunk no longer reaches the kernel's arithmetic: 16 and 32 equal
    # chunk 64's output bit for bit (and so sit within the tolerance of the
    # plain version), and so do chunks past the previous kernel's 128
    for chunk in (16, 32, 256, S):
        got = ops.wkv(r, k, v, g, u, chunk=chunk)
        gap = float(((got - y).abs() - WKV_TOL[1] * y.abs()).max())
        check(gap <= WKV_TOL[0], f"wkv chunk {chunk} vs {C}: {gap}")
        check(torch.equal(got, y), f"wkv chunk {chunk}: not bitwise chunk {C}'s")
        del got
        cases.append(wkv_case(f"chunk={chunk}", r, k, v, g, u, chunk, 10,
                              want=want, plain_ms=row["plain_ms"])[1:])
    del want, y
    # g at the clip floor everywhere: finite at chunk 64, past the 74 at
    # which the reference's factorised form overflows, and at one chunk
    floor = torch.full_like(g, -1.2)
    want, row, call = wkv_case("g = -1.2 (clip floor)", r, k, v, floor, u, C, 10)
    cases.append((row, call))
    for chunk in (128, S):
        cases.append(wkv_case(f"g = -1.2, chunk={chunk}", r, k, v, floor, u,
                              chunk, 10, want=want,
                              plain_ms=row["plain_ms"])[1:])
    del want
    cases.append(wkv_case("g below the clip floor", r, k, v, g * 8.0, u, C,
                          10)[1:])
    cases.append(wkv_case("bf16 inputs", *(t.bfloat16() for t in (r, k, v, g, u)),
                          C, 10, tol=WKV_BF16_TOL)[1:])
    # a ragged last tile: 1000 steps, 31 tiles and 8 steps, one chunk
    cases.append(wkv_case("S=1000 chunk=1000", *(t[:, :, :1000].contiguous()
                                                 for t in (r, k, v, g)), u,
                          1000, 10)[1:])
    # narrower keys at the same B, H, S: the walk's cost with less arithmetic
    # a tile (a tenth of K = 64's at K = 16)
    for Kn in (32, 16):
        cases.append(wkv_case(f"K={Kn}", *(t[..., :Kn].contiguous()
                                           for t in (r, k, v, g)),
                              u[:, :Kn].contiguous(), C, 10)[1:])
    rows = [row for row, _ in cases]
    for row, ms in zip(rows, wkv_device_ms([call for _, call in cases])):
        row["kernel_device_ms"] = ms
        emit("kernel", **row)
    emit("wkv", model=CONFIG.name, B=B, H=H, S=S, K=K, chunk=C,
         launches=launches, ms=rows[0]["kernel_ms"],
         device_ms=rows[0]["kernel_device_ms"], tile=WKV_TILE,
         resources={dtype_name(dt): kernel_resources(K, dt)
                    for dt in (torch.float32, torch.bfloat16)},
         seconds=time.perf_counter() - t0)
    return rows, launches


def release() -> None:
    """Free what earlier phases left: an engine sits in reference cycles
    (its backend and its step hold it), so its device tables go only when
    the garbage collector runs; without this a phase's peak memory could
    count an earlier phase's engine."""
    gc.collect()
    torch.cuda.empty_cache()


def build_engine(g, chunks, device, model="gcn", group=(),
                 execution="broadcast", protocol="sync", family="edge_cut"):
    """One configuration's engine at full width through the training
    launcher's options (lr TRAIN_LR; the hash partition: every partitioner
    gives part 0 at one rank, and metis_like's host loops would take minutes
    at 2**20 vertices), after the earlier engines are released.  The
    configuration's sweep and training phases share it (its layout and
    transpose plans take a few seconds of host work to build).  ``group``:
    the launcher's process-group options (the engine then runs over the
    group already joined).  ``family``: the launcher's partition family
    (the vertex cut its default cartesian2d, the hybrid cut its default
    hub threshold, the masters from the hash partition).  Returns (engine,
    setup seconds)."""
    from repro_torch.launch import train_gnn

    release()
    t0 = time.perf_counter()
    args = train_gnn.parse_args([
        "--device", str(device), "--exec", execution, "--partitioner", "hash",
        "--protocol", protocol, "--model", model, "--exchange-chunks",
        str(chunks), "--hidden", "256", "--layers", "3", "--lr",
        str(TRAIN_LR[model]), "--partition-family", family, *group])
    eng = train_gnn.build_engine(args, g)  # the transpose plans included
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def phase_name(kind: str, eng) -> str:
    """sweep, train (gcn), <model>_sweep, <model>_train; p2p_sweep and
    p2p_train under p2p; ring_sweep, ring_train (gcn) and <model>_ring_sweep,
    <model>_ring_train under the ring; nccl_sweep and nccl_train
    (nccl_p2p_sweep, nccl_p2p_train, nccl_ring_sweep, nccl_ring_train) in
    the world-size-1 NCCL group; async_train under a historical-embedding
    protocol; under the replica families vc_<execution>_<kind> (vertex
    cut) and hybrid_<execution>_<kind>, with the model first for gat and
    nccl_ first in the group."""
    from repro_torch.core.execution import collectives

    model, execution = eng.cfg.model, eng.cfg.execution
    group = collectives.group_active()
    family = eng.cfg.partition_family
    if family != "edge_cut":
        tag = f"{'vc' if family == 'vertex_cut' else family}_{execution}"
        return (f"nccl_{tag}_{kind}" if group else
                f"{tag}_{kind}" if model == "gcn" else
                f"{model}_{tag}_{kind}")
    if eng.cfg.protocol != "sync":
        return f"async_{kind}"
    if execution == "ring":
        if group:
            return f"nccl_ring_{kind}"
        return f"ring_{kind}" if model == "gcn" else f"{model}_ring_{kind}"
    if execution == "p2p":
        return f"nccl_p2p_{kind}" if group else f"p2p_{kind}"
    if group:
        return f"nccl_{kind}"
    return kind if model == "gcn" else f"{model}_{kind}"


def p2p_fields(eng) -> dict:
    """What a p2p phase reports of its plan: the installments' widths, the
    gather table's rows and the halo rows a pass ships (none at one
    rank).  A replica phase (any execution) reports its layout instead:
    the slots a rank holds, the ELL width, the most replicas of a vertex,
    the replica rows a layer ships, and the hybrid cut's hub threshold,
    hubs and halo rows."""
    lay = eng.playout
    if eng.cfg.partition_family != "edge_cut":
        out = dict(nv=lay.nv, Kc=lay.K, Rm=lay.layout.Rm,
                   replication_factor=lay.layout.replication_factor(),
                   replica_rows_per_layer=lay._vc_rows_per_layer,
                   sync_active=bool(lay.sync_active),
                   table_rows=lay.table_rows)
        if eng.cfg.partition_family == "hybrid":
            out.update(hub_threshold=lay.cut.threshold,
                       hubs=int(lay.cut.hub.sum()), halo_rows=lay.halo_rows,
                       halo_active=bool(lay.halo_active))
        return out
    if eng.cfg.execution != "p2p":
        return {}
    return dict(p2p_widths=lay.p2p_widths, table_rows=lay.table_rows,
                halo_rows=lay._halo_rows)


def sweep_phase(eng, setup_s, g, baseline=None, against="no_group",
                edge=None):
    """The main path: SWEEPS timed layer-wise sweeps through
    serve_gnn.run_sweep at full width on the engine `build_engine` made
    (broadcast, p2p or the ring, which ignores exchange_chunks), kernel
    launches and collective calls counted from 0; then the reference
    sweep, its launches counted apart.  ``baseline``: a result this one must
    equal bit for bit, the same phase without a group (``against``
    "no_group") or under broadcast ("broadcast").  ``edge``: a replica
    phase's edge-cut counterpart (`anchor_fields`)."""
    from repro_torch.core.execution import collectives
    from repro_torch.core.models.gnn import init_gnn_params
    from repro_torch.launch import serve_gnn

    model, chunks = eng.cfg.model, eng.cfg.exchange_chunks
    execution, group = eng.cfg.execution, collectives.group_active()
    name = phase_name("sweep", eng)
    t0 = time.perf_counter()
    params = init_gnn_params(model, eng.dims, torch.Generator().manual_seed(0),
                             eng.device)
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
    # a sweep runs the forward kernel per layer and chunk (p2p: and one
    # send gather per installment; the ring: per layer and round, one round
    # at k = 1) and no backward; in a group an all_gather per layer and
    # chunk (p2p: an all_to_all per layer, chunk and installment; the ring:
    # k - 1 rotations a layer, none at k = 1), then one all_gather of the
    # output
    replica = eng.cfg.partition_family != "edge_cut"
    B = (len(eng.playout.p2p_widths) if execution == "p2p" and not replica
         else 0)
    C = 1 if execution == "ring" else chunks  # the ring: one round at k = 1
    check(eng.k == 1, f"{name}: {eng.k} ranks on one card")
    check_counts(launches, replica_launches(eng, SWEEPS, backward=False)
                 if replica else dict(ell_spmm=L * C * (1 + B) * SWEEPS),
                 f"{name} {model}")
    if replica:
        calls_want = replica_calls(eng, SWEEPS, train=False)
    elif execution == "ring":
        calls_want = dict(ppermute=L * (eng.k - 1) * SWEEPS, all_gather=SWEEPS)
    elif B:
        calls_want = dict(all_to_all=L * chunks * B * SWEEPS, all_gather=SWEEPS)
    else:
        calls_want = dict(all_gather=(L * chunks + 1) * SWEEPS)
    check_calls(calls, calls_want if group else {}, f"{name} {model}")
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
    extra = p2p_fields(eng)
    if baseline is not None:
        extra.update(compare_baseline(name, result, baseline, ("emb",),
                                      against))
    if edge is not None:
        extra.update(anchor_fields(name, result, edge, "emb"))
    emit(name, model=model, execution=execution,
         exchange_chunks=chunks, vertices=g.num_vertices, K=eng.K,
         dims=eng.dims, sweeps=SWEEPS, walls_ms=[w * 1e3 for w in walls],
         median_ms=median_s * 1e3, vertices_per_s=g.num_vertices / median_s,
         launches=launches, reference_launches=ref_launches,
         launches_per_sweep=launches["ell_spmm"] / SWEEPS,
         replica_sync_bytes=eng.comm_stats.replica_sync_bytes,
         collective_calls=calls, bitwise_equal_sweeps=bitwise,
         oracle_max_abs_err=err, oracle_tol=TOL,
         inference_bytes=eng.comm_stats.inference_bytes,
         max_memory_allocated=peak, setup_s=setup_s,
         seconds=time.perf_counter() - t0, **extra)
    add_counts(launches, ref_launches)
    return params, launches, result


def train_phase(eng, setup_s, g, baseline=None, against="no_group",
                edge=None):
    """The training path: TRAIN_STEPS timed steps through
    train_gnn.run_training at full width on the engine `build_engine` made
    (lr TRAIN_LR), kernel launches and collective calls counted from 0;
    then a second run from the same initial state with the single-device
    reference run (per-step loss gap <= TOL), which must be bitwise equal to
    the first in losses and in every parameter.  ``baseline`` and
    ``against`` as in `sweep_phase` ("sync": a protocol against the same
    phase under sync), ``edge`` as in `sweep_phase`.  Under a
    historical-embedding protocol the state also
    carries each layer's history and the ages, and the second run is
    `forced_run`: both runs must hold the same bits, each step's history
    within TOL of the reference step's from the same state, the ages equal
    to its, and no step may push a row (one rank: no boundary row)."""
    from repro_torch.core.execution import collectives
    from repro_torch.core.models.gnn import PARAM_KEYS
    from repro_torch.launch import train_gnn

    c = eng.cfg
    model, chunks, execution, protocol, lr = (
        c.model, c.exchange_chunks, c.execution, c.protocol, c.lr)
    group = collectives.group_active()
    name = phase_name("train", eng)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.zero_calls()
    run = train_gnn.run_training(eng, TRAIN_STEPS)
    launches = read_counts()
    calls = collectives.read_calls()
    peak = torch.cuda.max_memory_allocated()
    L = len(eng.dims) - 1
    replica = c.partition_family != "edge_cut"
    B = (len(eng.playout.p2p_widths) if execution == "p2p" and not replica
         else 0)
    C = 1 if execution == "ring" else chunks  # the ring: one round at k = 1
    check(eng.k == 1, f"{name}: {eng.k} ranks on one card")
    if replica:
        step_want = replica_launches(eng, TRAIN_STEPS, backward=True)
        calls_want = replica_calls(eng, TRAIN_STEPS, train=True)
    else:
        step_want = step_launches(model, L, C, TRAIN_STEPS, sends=B)
        calls_want = step_calls(model, L, chunks, TRAIN_STEPS,
                                installments=B, execution=execution, k=eng.k)
    check_counts(launches, step_want,
                 f"{name} {model}, {TRAIN_STEPS} steps")
    check_calls(calls, calls_want if group else {},
                f"{name} {model}, {TRAIN_STEPS} steps")
    losses = run["losses"]
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"the loss did not fall at every step: {losses}")
    logits = run["logits"]
    check(tuple(logits.shape) == (eng.Vp, eng.dims[-1]), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    train_acc, test_acc = eng.accuracy(logits, "train"), eng.accuracy(logits, "test")
    params, walls = run["state"]["params"], run["walls"]
    hist, pushed = run["state"].get("hist"), run["rows_pushed"]
    age = run["state"].get("age")
    del run, logits
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.zero_calls()
    again = (forced_run(eng, TRAIN_STEPS) if protocol != "sync" else
             train_gnn.run_training(eng, TRAIN_STEPS, oracle_check=True))
    again_launches = read_counts()
    ref_peak = torch.cuda.max_memory_allocated()
    want = dict(step_want)
    add_counts(want, reference_launches(model, L, TRAIN_STEPS, backward=True))
    check_counts(again_launches, want, f"{name} {model} with its reference")
    # the reference runs no collective
    check_calls(collectives.read_calls(), calls_want if group else {},
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
    result = dict(losses=losses, median_ms=median_s * 1e3, peak=peak, params=[
        {key: p[key].cpu() for key in keys} for p in params["layers"]])
    extra = p2p_fields(eng)
    if protocol != "sync":
        extra.update(history_fields(eng, hist, age, pushed, again))
    if baseline is not None:
        extra.update(compare_baseline(name, result, baseline,
                                      ("losses", "params"), against))
    if edge is not None:
        extra.update(anchor_fields(name, result, edge, "losses"))
    emit(name, model=model, execution=execution,
         exchange_chunks=chunks, vertices=g.num_vertices, K=eng.K,
         dims=eng.dims, lr=lr, steps=TRAIN_STEPS, losses=losses,
         ref_losses=again["ref_losses"], loss_gaps=gaps, oracle_tol=TOL,
         walls_ms=[w * 1e3 for w in walls],
         walls_second_run_ms=[w * 1e3 for w in again["walls"]],
         median_step_ms=median_s * 1e3, steps_per_s=1.0 / median_s,
         train_acc=train_acc, test_acc=test_acc, launches=launches,
         replica_sync_bytes=eng.comm_stats.replica_sync_bytes,
         launches_with_reference=again_launches, collective_calls=calls,
         param_keys=list(keys), bitwise_equal_runs=bitwise,
         max_memory_allocated=peak,
         max_memory_allocated_with_reference=ref_peak, setup_s=setup_s,
         seconds=time.perf_counter() - t0, **extra)
    add_counts(launches, again_launches)
    return launches, result


def forced_run(eng, steps: int) -> dict:
    """A protocol phase's second run: ``steps`` timed steps from
    `init_state()`, and beside each the reference step from the same state
    (the run's rows gathered: history [Vp, d] a layer, ages [L, k]), so each
    step's history is held to the reference step's on equal inputs (two
    runs left to themselves drift apart in every layer's rows, as the sync
    step's logits do).  Returns `run_training`'s keys with ``oracle_check``
    and, per step, each layer's largest history gap and whether the ages
    are the reference's."""
    step, ref_step = eng.make_step(), eng.make_reference_step()
    state = eng.init_state()
    out = dict(losses=[], rows_pushed=[], walls=[], ref_losses=[],
               ref_rows_pushed=[], history_gaps=[], ages_equal=[])
    for _ in range(steps):
        ref_in = dict(params=state["params"], step=state["step"],
                      hist=tuple(eng.gather_rows(h) for h in state["hist"]),
                      age=eng.gather_rows(state["age"][None]).t())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, _ = step(state)
        out["losses"].append(float(metrics["loss"]))
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["rows_pushed"].append(float(metrics["rows_pushed"]))
        ref, ref_metrics, _ = ref_step(ref_in)
        out["ref_losses"].append(float(ref_metrics["loss"]))
        out["ref_rows_pushed"].append(float(ref_metrics["rows_pushed"]))
        out["history_gaps"].append(
            [float((eng.gather_rows(h) - r).abs().max())
             for h, r in zip(state["hist"], ref["hist"])])
        out["ages_equal"].append(
            torch.equal(state["age"], ref["age"][:, eng.rank]))
    out["state"] = state
    return out


def history_fields(eng, hist, age, pushed, again) -> dict:
    """A protocol run's history checks: the first and the second run's
    history and ages bitwise equal, each step's history within TOL of the
    reference step's from the same state and the ages equal to its
    (`forced_run`), and no row pushed in any step of either run or of the
    reference (one rank: the boundary set is empty)."""
    state = again["state"]
    check(all(torch.equal(a, b) for a, b in zip(hist, state["hist"]))
          and torch.equal(age, state["age"]),
          "two protocol runs' histories differ")
    gaps = again["history_gaps"]
    check(max(max(g) for g in gaps) <= TOL,
          f"history vs the reference step's: {gaps} > {TOL}")
    check(all(again["ages_equal"]), f"ages {age.tolist()} differ from the "
          "reference step's")
    every = pushed + again["rows_pushed"] + again["ref_rows_pushed"]
    check(every == [0.0] * len(every), f"rows pushed at one rank: {every}")
    return dict(history_gaps=gaps, ages=age.tolist(), rows_pushed=pushed,
                history_bytes=sum(h.numel() * h.element_size() for h in hist))


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


# ---------------------------------------------------------------------------
# streaming ingest and the trainable-feature phases
# ---------------------------------------------------------------------------


def proc_rss_gb() -> float:
    """The process's resident set now, GB (/proc/self/statm)."""
    return proc_memory_gb()["rss_gb"]


def stream_ingest_phase(g) -> None:
    """Host only: `build_streaming_layout` over the graph as a stream of
    STREAM_CHUNK-edge chunks, owner-shuffled to STREAM_PARTS hash parts,
    held array for array to the port's in-memory `EdgeCutLayout` built
    whole for the same parts (broadcast: no exchange plan past the global
    ids); its seconds, its self-reported peak transient bytes against the
    layout's bytes, and the host's resident set around each build."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.partition.edge_cut import hash_partition
    from repro_torch.core.partition.layout_api import EdgeCutLayout
    from repro_torch.core.partition.streaming import (
        GraphEdgeChunks,
        build_streaming_layout,
    )

    k = STREAM_PARTS
    part = hash_partition(g, k)
    rss0 = proc_rss_gb()
    t0 = time.perf_counter()
    lay = build_streaming_layout(
        GraphEdgeChunks(g, STREAM_CHUNK), part.assignment, k, g.num_vertices,
        features=g.features, labels=g.labels, train_mask=g.train_mask,
        test_mask=g.test_mask)
    stream_s = time.perf_counter() - t0
    rss1 = proc_rss_gb()
    t0 = time.perf_counter()
    mem = EdgeCutLayout(g, k, EngineConfig(execution="broadcast",
                                           partitioner="hash"),
                        partition=part)
    memory_s = time.perf_counter() - t0
    rss2 = proc_rss_gb()
    pairs = dict(new_of_old=(lay.new_of_old, mem.new_of_old),
                 ids=(lay.ids, mem.ids_global), mask=(lay.mask, mem.mask),
                 deg=(lay.deg, mem.deg),
                 X=(lay.X.reshape(lay.Vp, -1), mem.store.flat()),
                 y=(lay.y, mem.y), train_w=(lay.train_w, mem.train_w),
                 test_w=(lay.test_w, mem.test_w),
                 emb_touched=(lay.emb_touched, mem.emb_touched),
                 bmask=(lay.bmask, mem.bmask))
    check((lay.nb, lay.Vp, lay.K) == (mem.nb, mem.Vp, mem.K),
          f"stream_ingest: (nb, Vp, K) {(lay.nb, lay.Vp, lay.K)} vs "
          f"{(mem.nb, mem.Vp, mem.K)}")
    for name, (a, b) in pairs.items():
        check(a.shape == b.shape and np.array_equal(a, b),
              f"stream_ingest: {name} differs from the in-memory layout")
    chunks = -(-g.num_edges // STREAM_CHUNK)
    emit("stream_ingest", vertices=g.num_vertices, edges=g.num_edges,
         parts=k, chunk_edges=STREAM_CHUNK, chunks=chunks, nb=lay.nb,
         K=lay.K, seconds=stream_s, edges_per_s=g.num_edges / stream_s,
         in_memory_layout_s=memory_s,
         peak_transient_bytes=lay.peak_transient_bytes,
         layout_bytes=lay.layout_bytes,
         peak_over_layout=lay.peak_transient_bytes / lay.layout_bytes,
         edge_list_bytes=g.num_edges * 16,
         equal_arrays=sorted(pairs), host_rss_gb_before=rss0,
         host_rss_gb_after_stream=rss1, host_rss_gb_after_in_memory=rss2,
         host_max_rss_gb=host_rss_gb(),
         note="host numpy only: no device work")


def trainable_engine(g, device, family="edge_cut", **extra):
    """A trainable-features engine at full width at the training
    launcher's settings (gcn, p2p at NCCL_CHUNKS, the hash partition, lr
    TRAIN_LR; the launchers have no trainable option, as the reference's
    have none, so the config is built here) and embed_eps
    TRAINABLE_EMBED_EPS, after the earlier engines are released.  Returns
    (engine, setup seconds)."""
    from repro_torch.core.engine import DistGNNEngine, EngineConfig

    release()
    t0 = time.perf_counter()
    cfg = EngineConfig(execution="p2p", partitioner="hash", model="gcn",
                       exchange_chunks=NCCL_CHUNKS, hidden=256, num_layers=3,
                       lr=TRAIN_LR["gcn"], partition_family=family,
                       trainable_features=True,
                       embed_eps=TRAINABLE_EMBED_EPS, **extra)
    eng = DistGNNEngine(g, cfg, device=device)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def timed_steps(step, state, inputs):
    """``step`` from ``state`` once per entry of ``inputs`` (its extra
    arguments: ``()`` for a full-graph step, ``(batch,)`` for a mini-batch
    one), each timed on the host clock ending in a synchronize.  Returns
    (final state, losses, walls)."""
    st, losses, walls = state, [], []
    for args in inputs:
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        st, metrics, _ = step(st, *args)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - s0)
    return st, losses, walls


def held_to_reference(name, step, ref_step, state, inputs):
    """`timed_steps` with, beside each step, the reference step from the
    same state: the loss, the logits and the embed, emb_m and emb_v tables
    within TOL, emb_t equal.  Returns (final state, losses, walls, the
    gaps per step, the worst gap of each)."""
    st, losses, walls = state, [], []
    gaps = {key: [] for key in ("loss", "logits", "embed", "emb_m", "emb_v")}
    for args in inputs:
        ref, ref_metrics, ref_logits = ref_step(st, *args)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        st, metrics, logits = step(st, *args)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - s0)
        gaps["loss"].append(abs(losses[-1] - float(ref_metrics["loss"])))
        gaps["logits"].append(float((logits - ref_logits).abs().max()))
        for key in ("embed", "emb_m", "emb_v"):
            gaps[key].append(float((st[key] - ref[key]).abs().max()))
        check(torch.equal(st["emb_t"], ref["emb_t"]),
              f"{name}: emb_t differs from the reference step's")
        del ref, ref_logits, logits
    worst = {key: max(v) for key, v in gaps.items()}
    check(max(worst.values()) <= TOL,
          f"{name}: step vs reference step from the same state: {worst}")
    return st, losses, walls, gaps, worst


def trainable_launches(eng, T: int) -> dict:
    """Launches of T trainable full-graph steps (gcn): the frozen step's
    (`step_launches`, `replica_launches`) and the transposes of layer 0's
    gathers, which now feed the embedding gradient; under a replica family
    also the two combines of the update (the gradient's and the masters'
    delta), forward only."""
    c, L = eng.cfg, len(eng.dims) - 1
    check(c.model == "gcn", f"trainable phases run gcn, not {c.model}")
    if c.partition_family != "edge_cut":
        want = replica_launches(eng, T, backward=True)
        per = want["ell_spmm"] // (L * T)  # a layer: 1 + the combine's
        want["ell_spmm_transpose"] += per * T
        want["ell_spmm"] += 2 * (per - 1) * T
        return want
    B = len(eng.playout.p2p_widths) if c.execution == "p2p" else 0
    C = 1 if c.execution == "ring" else c.exchange_chunks
    want = step_launches(c.model, L, C, T, sends=B)
    want["ell_spmm_transpose"] += C * (1 + B) * T
    return want


def trainable_phase(eng, setup_s, g, steps, p2p_train=None) -> dict:
    """The trainable full-graph step at full width (`trainable_train`
    under the edge cut, `trainable_vc_train` under the vertex cut):
    ``steps`` timed steps from `init_state()`, launches counted exactly
    (`trainable_launches`); a second run from the same state with, beside
    each step, the reference step from the same state: loss, logits and
    the embed, emb_m and emb_v tables within TOL, emb_t equal, and the run
    bitwise equal to the first; the table moved, the pad rows and the rows
    whose gradient was 0 at every step frozen bit for bit with zero
    moments, the store unchanged.  Then the row AdamW alone
    (`_embed_update_full`) timed on the final state, one traced step, the
    sweep over the trained state against the reference sweep, and under
    the edge cut the `publish_embeddings` handoff: a frozen engine on the
    published table sweeps the same bits.  ``p2p_train``: that phase's
    result, whose median step ms is reported beside this one's."""
    from repro_torch.core.engine import EMBED_KEYS, DistGNNEngine
    from repro_torch.core.models.gnn import PARAM_KEYS

    c = eng.cfg
    name = ("trainable_train" if c.partition_family == "edge_cut"
            else "trainable_vc_train")
    keys = PARAM_KEYS[c.model]
    t0 = time.perf_counter()
    step, ref_step = eng.make_step(), eng.make_reference_step()
    state = eng.init_state()
    embed0 = state["embed"].clone()
    store_host0 = eng.store.flat().copy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    final, losses, walls = timed_steps(step, state, [()] * steps)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = trainable_launches(eng, steps)
    check_counts(launches, want, f"{name}, {steps} steps")
    check(bool(np.isfinite(losses).all()), f"{name}: losses {losses}")
    zero_counts()
    st, again, walls2, gaps, worst = held_to_reference(
        name, step, ref_step, state, [()] * steps)
    check_counts(read_counts(), want, f"{name} with its reference")
    bitwise = again == losses and all(
        torch.equal(final[key], st[key]) for key in EMBED_KEYS) and all(
        torch.equal(a[key], b[key]) for a, b in
        zip(final["params"]["layers"], st["params"]["layers"])
        for key in keys)
    check(bitwise, f"{name}: two runs from the same state differ")
    del st
    touched = eng._consts["emb_touched"] > 0
    moved = int((final["embed"] != embed0).any(1).sum())
    check(moved > 0, f"{name}: the embedding table did not move")
    pads = ~touched
    check(torch.equal(final["embed"][pads], embed0[pads]) and not (
        final["emb_m"][pads].any() or final["emb_v"][pads].any()
        or final["emb_t"][pads].any()), f"{name}: a pad row changed")
    zero_grad = (final["emb_m"] == 0).all(1) & touched
    check(torch.equal(final["embed"][zero_grad], embed0[zero_grad]),
          f"{name}: a row with no gradient moved")
    check(torch.equal(eng.store.device_table(), embed0)
          and np.array_equal(eng.store.flat(), store_host0),
          f"{name}: training wrote the store")
    # the row AdamW alone, on the final state (the update of the step)
    grad = torch.randn(final["embed"].shape, device=eng.device,
                       generator=torch.Generator(eng.device).manual_seed(0))
    with torch.no_grad():
        adamw_ms = cuda_ms(lambda: eng._embed_update_full(final, grad), 3)
    del grad
    kernels = {TRACE_NAMES.get(n, f"{n}_kernel"): k
               for n, k in trainable_launches(eng, 1).items() if k}
    profile_phase(f"{name}_profile", lambda: step(state), kernels,
                  model=c.model, family=c.partition_family,
                  execution=c.execution, exchange_chunks=c.exchange_chunks)
    zero_counts()
    H = eng.infer_full_graph(final)
    sweep_launches = read_counts()
    H_ref = eng.infer_full_graph(final, reference=True)
    sweep_gap = float((H - H_ref).abs().max())
    check(sweep_gap <= TOL, f"{name}: sweep over the trained table vs the "
          f"reference sweep: {sweep_gap} > {TOL}")
    del H_ref
    extra = {}
    if c.partition_family == "edge_cut":
        eng.publish_embeddings(final)
        check(torch.equal(eng.store.device_table(), final["embed"]),
              f"{name}: publish_embeddings did not write the trained rows")
        s0 = time.perf_counter()
        frozen = DistGNNEngine(g, dataclasses.replace(
            c, trainable_features=False), device=eng.device)
        frozen.store.update_rows(np.arange(frozen.store.num_rows),
                                 eng.store.flat())
        H_serve = frozen.infer_full_graph(params=final["params"])
        check(torch.equal(H_serve, H), f"{name}: the frozen engine's sweep "
              "of the published table differs from the trained sweep")
        extra.update(publish_handoff_bitwise=True,
                     frozen_engine_s=time.perf_counter() - s0)
        del frozen, H_serve
    if p2p_train is not None:
        extra.update(p2p_train_median_ms=p2p_train["median_ms"],
                     p2p_train_max_memory_allocated=p2p_train["peak"])
    median_s = float(np.median(walls))
    table_bytes = final["embed"].numel() * 4
    emit(name, model=c.model, family=c.partition_family,
         execution=c.execution, exchange_chunks=c.exchange_chunks,
         vertices=g.num_vertices, dims=eng.dims, lr=c.lr, embed_lr=c.embed_lr,
         steps=steps, losses=losses, gaps=gaps, worst_gaps=worst,
         oracle_tol=TOL, walls_ms=[w * 1e3 for w in walls],
         walls_second_run_ms=[w * 1e3 for w in walls2],
         median_step_ms=median_s * 1e3, row_adamw_ms=adamw_ms,
         row_adamw_share=adamw_ms / (median_s * 1e3), launches=launches,
         bitwise_equal_runs=bitwise, rows_moved=moved,
         pad_rows=int(pads.sum()), zero_gradient_rows=int(zero_grad.sum()),
         embed_grad_bytes_per_step=eng._emb_bytes_per_step,
         table_bytes=table_bytes, state_table_bytes=3 * table_bytes,
         max_memory_allocated=peak, sweep_launches=sweep_launches,
         sweep_gap=sweep_gap, setup_s=setup_s,
         seconds=time.perf_counter() - t0, **extra)
    return launches


def mb_trainable_phase(g, device) -> dict:
    """The trainable mini-batch step at full width (`mb_trainable`): gcn
    node-wise under p2p with the static_degree cache (at one rank the
    cache holds no row: every row is the rank's own), the sampler settings
    of MB_SAMPLERS, MB_TRAINABLE_STEPS batches.  Timed steps with the
    launches counted exactly (per step and feature chunk the fetch's K = 1
    ELL forwards, the send gathers and the table gather, and their
    transposes); a second run with the reference step from the same state
    beside each step (loss, logits, embed, emb_m, emb_v within TOL, emb_t
    equal), bitwise equal to the first; one traced step; the rows no
    batch touched frozen bit for bit with zero moments; the store
    unchanged."""
    from repro_torch.core.engine import EMBED_KEYS, DistGNNEngine, EngineConfig
    from repro_torch.launch import train_gnn
    from repro_torch.launch.common import per_layer

    release()
    t0 = time.perf_counter()
    # the launcher's options as `build_mb_engine` passes them, then the
    # config with trainable features (the launchers have no such option)
    args = train_gnn.parse_args([
        "--device", str(device), "--exec", "p2p", "--partitioner", "hash",
        "--hidden", "256", "--layers", "3", "--lr", str(MB_LR),
        "--batching", "node_wise", *MB_SAMPLERS["node_wise"], "--cache",
        "static_degree", "--cache-capacity", str(MB_TRAINABLE_CACHE)])
    eng = DistGNNEngine(g, EngineConfig(
        execution=args.exec, partitioner=args.partitioner, model=args.model,
        exchange_chunks=args.exchange_chunks, hidden=args.hidden,
        num_layers=args.layers, lr=args.lr, batching=args.batching,
        batch_size=args.batch_size,
        fanouts=per_layer(args.fanouts, 4, args.layers),
        cache_policy=args.cache, cache_capacity=args.cache_capacity,
        trainable_features=True), device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    s0 = time.perf_counter()
    batches = [eng.sample_minibatch(i) for i in range(MB_TRAINABLE_STEPS)]
    sample_s = time.perf_counter() - s0
    step, ref_step = (eng.make_minibatch_step(),
                      eng.make_reference_minibatch_step())
    state = eng.init_minibatch_state()
    embed0 = state["embed"].clone()
    touched = torch.zeros(eng.nb, dtype=torch.bool, device=eng.device)
    for b in batches:
        ids = b["emb_ids"]
        touched[ids[ids < eng.nb]] = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    inputs = [(b,) for b in batches]
    final, losses, walls = timed_steps(step, state, inputs)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    C, B = eng.cfg.exchange_chunks, len(eng.fcap_widths)
    per = C * (B + 1) * len(batches)
    want = dict(ell_spmm=per, ell_spmm_transpose=per)
    check_counts(launches, want, "mb_trainable")
    profile_phase("mb_trainable_profile", lambda: step(state, batches[0]),
                  {"ell_spmm_kernel": C * (B + 1),
                   "ell_spmm_transpose_kernel": C * (B + 1)},
                  model="gcn", batching="node_wise", execution="p2p",
                  exchange_chunks=C)
    zero_counts()
    st, again, walls2, gaps, worst = held_to_reference(
        "mb_trainable", step, ref_step, state, inputs)
    check_counts(read_counts(), want, "mb_trainable with its reference")
    bitwise = again == losses and all(torch.equal(final[key], st[key])
                                      for key in EMBED_KEYS)
    check(bitwise, "mb_trainable: two runs from the same state differ")
    check(torch.equal(final["emb_t"] > 0, touched),
          "mb_trainable: the updated rows are not the batches' touched rows")
    frozen = ~touched
    check(torch.equal(final["embed"][frozen], embed0[frozen]) and not (
        final["emb_m"][frozen].any() or final["emb_v"][frozen].any()),
        "mb_trainable: an untouched row changed")
    moved = int((final["embed"] != embed0).any(1).sum())
    check(moved > 0, "mb_trainable: the table did not move")
    check(torch.equal(eng.store.device_table(), embed0),
          "mb_trainable: training wrote the store")
    emit("mb_trainable", model="gcn", execution="p2p", batching="node_wise",
         cache=eng.cfg.cache_policy, cache_capacity=eng.cfg.cache_capacity,
         overlay_rows=int(eng._has_overlay), vertices=g.num_vertices,
         dims=eng.dims, lr=eng.cfg.lr, embed_lr=eng.cfg.embed_lr,
         caps=list(eng.caps), fcap_widths=eng.fcap_widths, tcap=eng.tcap,
         steps=len(batches), losses=losses, gaps=gaps, worst_gaps=worst,
         oracle_tol=TOL, walls_ms=[w * 1e3 for w in walls],
         walls_second_run_ms=[w * 1e3 for w in walls2],
         median_step_ms=float(np.median(walls)) * 1e3, launches=launches,
         launches_per_step_and_gather=1, bitwise_equal_runs=bitwise,
         touched_rows=int(touched.sum()), rows_moved=moved,
         embed_grad_bytes=eng.comm_stats.embed_grad_bytes,
         max_memory_allocated=peak, sample_extract_s=sample_s,
         setup_s=setup_s, seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# the sampled mini-batch phases
# ---------------------------------------------------------------------------


def build_mb_engine(g, device, model, execution, batching, group=(),
                    extra=()):
    """One mini-batch configuration's engine at full width through the
    training launcher's options (lr MB_LR, the hash partition, the
    sampler settings of MB_SAMPLERS, then ``extra``), after the earlier
    engines are released.  Returns (engine, setup seconds)."""
    from repro_torch.launch import train_gnn

    release()
    t0 = time.perf_counter()
    args = train_gnn.parse_args([
        "--device", str(device), "--exec", execution, "--partitioner", "hash",
        "--model", model, "--hidden", "256", "--layers", "3", "--lr",
        str(MB_LR), "--batching", batching, *MB_SAMPLERS[batching], *group,
        *extra])
    eng = train_gnn.build_engine(args, g)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def mb_phase_name(eng) -> str:
    """mb_node_<execution> (gcn), mb_node_<model> (p2p), mb_layer_p2p,
    mb_subgraph_p2p; nccl_ first in a process group."""
    from repro_torch.core.execution import collectives

    c = eng.cfg
    short = {"node_wise": "node", "layer_wise": "layer",
             "subgraph": "subgraph"}[c.batching]
    tag = c.execution if c.model == "gcn" else c.model
    name = f"mb_{short}_{tag}"
    return f"nccl_{name}" if collectives.group_active() else name


def mb_launches(eng, steps: int) -> dict:
    """Kernel launches of `steps` mini-batch steps: p2p's frontier fetch
    gathers its send rows by the ELL forward at K = 1, one launch a feature
    chunk and an installment; broadcast and the ring gather by
    `index_select`, and the dense blocks are cuBLAS products: no kernel.
    The reference step launches none."""
    if eng.cfg.execution != "p2p":
        return {}
    return dict(ell_spmm=eng.cfg.exchange_chunks * len(eng.fcap_widths)
                * steps)


def mb_calls(eng, steps: int) -> dict:
    """Collective calls of `steps` mini-batch steps in a process group: per
    feature chunk an all_gather (broadcast) or an all_to_all an installment
    (p2p), k - 1 rotations (the ring, none at k = 1), and one all_reduce a
    step; the fetch has no backward.  The reference calls none."""
    c = eng.cfg
    out = dict(all_reduce=steps)
    if c.execution == "p2p":
        out["all_to_all"] = c.exchange_chunks * len(eng.fcap_widths) * steps
    elif c.execution == "broadcast":
        out["all_gather"] = c.exchange_chunks * steps
    else:
        out["ppermute"] = (eng.k - 1) * steps
    return out


def host_rss_gb() -> float:
    """The process's largest resident set so far, GB (Linux: KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def param_copies(params, keys) -> list:
    return [{key: p[key].cpu() for key in keys} for p in params["layers"]]


def minibatch_phase(eng, setup_s, batches=None, baseline=None,
                    steps=MB_STEPS, resample=False) -> dict:
    """A mini-batch phase at full width.  Without ``batches``: the epoch
    through `run_epoch_minibatch(steps, "conventional")`, which samples,
    extracts and uploads each batch (the batches are kept for the checks
    and later phases), with its StageTimes; with ``resample`` a second
    `sample_minibatch(0)` must equal the first array for array.  With
    ``batches``: `steps` timed steps of `make_minibatch_step` over them (the
    batch arrays do not depend on the model).  Kernel launches and, in a
    group, collective calls counted from 0 around the run (`mb_launches`,
    `mb_calls`).  Then a second run from the same initial state, timed step
    by step, with the reference step from the same state on the same batch
    beside each: bitwise equal to the first run (losses and params), each
    step's loss and target logits within TOL of the reference's, and the
    reference launching nothing.  ``baseline``: a phase whose first steps
    this one must equal bit for bit (losses and params after as many
    steps).  Returns (result, launches); the result holds the epoch's
    batches under "batches"."""
    from repro_torch.core.execution import collectives
    from repro_torch.core.models.gnn import PARAM_KEYS

    c = eng.cfg
    keys = PARAM_KEYS[c.model]
    name = mb_phase_name(eng)
    group = collectives.group_active()
    t0 = time.perf_counter()
    check(eng.k == 1, f"{name}: {eng.k} ranks on one card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' kept batches
    zero_counts()
    collectives.zero_calls()
    stage, walls, captured = None, None, batches is None
    if captured:
        made = []
        make = eng._make_batch

        def capture(mbs, step=None):
            made.append(make(mbs, step=step))
            return made[-1]
        eng._make_batch = capture
        try:
            state, losses, times = eng.run_epoch_minibatch(steps)
        finally:
            del eng._make_batch
        batches = made
        stage = dict(sample_s=times.sample, extract_s=times.extract,
                     train_s=times.train, wall_s=times.wall)
    else:
        step, state, losses, walls = (eng.make_minibatch_step(),
                                      eng.init_minibatch_state(), [], [])
        for b in batches[:steps]:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            state, metrics, _ = step(state, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - s0)
    launches = read_counts()
    calls = collectives.read_calls()
    peak = torch.cuda.max_memory_allocated()
    check_counts(launches, mb_launches(eng, steps), name)
    check_calls(calls, mb_calls(eng, steps) if group else {}, name)
    check(bool(np.isfinite(losses).all()), f"{name}: losses {losses}")
    comm = dict(pull_bytes=eng.comm_stats.pull_bytes,
                cache_hit_bytes=eng.comm_stats.cache_hit_bytes)
    # the second run, with the reference step from the same state beside
    # each step
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.zero_calls()
    step, ref_step = eng.make_minibatch_step(), eng.make_reference_minibatch_step()
    st = eng.init_minibatch_state()
    again, walls2, gaps, logit_gaps, by_step = [], [], [], [], []
    for b in batches[:steps]:
        _, ref_metrics, ref_logits = ref_step(st, b)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        st, metrics, logits = step(st, b)
        again.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls2.append(time.perf_counter() - s0)
        gaps.append(abs(again[-1] - float(ref_metrics["loss"])))
        check(tuple(logits.shape) == tuple(ref_logits.shape)
              == (1, eng.caps[-1], eng.dims[-1]), f"{name}: logits "
              f"{tuple(logits.shape)}, reference {tuple(ref_logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{name}: logits")
        logit_gaps.append(float((logits - ref_logits).abs().max()))
        by_step.append(param_copies(st["params"], keys))
        del ref_logits, logits
    ref_peak = torch.cuda.max_memory_allocated()
    check_counts(read_counts(), mb_launches(eng, steps),
                 f"{name} with its reference")
    check_calls(collectives.read_calls(), mb_calls(eng, steps) if group
                else {}, f"{name} with its reference")
    bitwise = again == losses and all(
        torch.equal(a[key], b[key]) for a, b in
        zip(state["params"]["layers"], st["params"]["layers"]) for key in keys)
    check(bitwise, f"{name}: two runs from the same state differ")
    check(max(gaps) <= TOL and max(logit_gaps) <= TOL,
          f"{name}: step vs reference step: loss gaps {gaps}, logits "
          f"{logit_gaps} > {TOL}")
    extra = dict(stage or {})
    if resample:
        zero_counts()
        s0 = time.perf_counter()
        resampled = eng.sample_minibatch(0)["arrays"]
        extra["resample_s"] = time.perf_counter() - s0
        first = batches[0]["arrays"]
        check(resampled.keys() == first.keys() and all(
            np.array_equal(resampled[key], first[key]) for key in first),
            f"{name}: a second sample_minibatch(0) differs")
        check_counts(read_counts(), {}, f"{name} sampling")
        extra["resample_equal"] = True
        del resampled
    median_s = float(np.median(walls2))
    result = dict(losses=losses, params=by_step[-1], by_step=by_step,
                  median_ms=median_s * 1e3, comm=comm)
    if captured:  # kept for later phases only when asked for
        result["batches"] = batches
        result["wall_s"] = stage["wall_s"]
    if baseline is not None:
        n = len(losses)
        same = (losses == baseline["losses"][:n] and all(
            torch.equal(a[key], b[key]) for a, b in
            zip(result["params"], baseline["by_step"][n - 1]) for key in a))
        check(same, f"{name}: differs from {baseline['name']}'s first {n} "
              "steps")
        extra.update({f"bitwise_equal_to_{baseline['name']}": True,
                      f"{baseline['name']}_median_ms": baseline["median_ms"]})
    result["name"] = name
    arrays = batches[0]["arrays"]
    emit(name, model=c.model, execution=c.execution, batching=c.batching,
         exchange_chunks=c.exchange_chunks, vertices=eng.g.num_vertices,
         dims=eng.dims, lr=c.lr, batch_size=c.batch_size,
         fanouts=list(c.fanouts), layer_sizes=list(c.layer_sizes),
         walk_length=c.walk_length, caps=list(eng.caps), fcap=eng.fcap,
         fcap_widths=eng.fcap_widths, steps=steps,
         frontier_occupancy=int((arrays["frontier"] < eng.Vp).sum()),
         first_block_bytes=int(arrays["adj0"][0].nbytes),
         losses=losses, ref_loss_gaps=gaps, ref_logit_gaps=logit_gaps,
         oracle_tol=TOL, walls_ms=None if walls is None else
         [w * 1e3 for w in walls], walls_second_run_ms=[w * 1e3 for w in walls2],
         median_step_ms=median_s * 1e3, launches=launches,
         collective_calls=calls, bitwise_equal_runs=bitwise,
         max_memory_allocated=peak,
         max_memory_allocated_with_reference=ref_peak,
         memory_allocated_at_start=held, host_max_rss_gb=host_rss_gb(),
         setup_s=setup_s, **comm,
         seconds=time.perf_counter() - t0, **extra)
    return result, launches


def proc_memory_gb(pid="self") -> dict:
    """A process's resident set now, GB (/proc/<pid>/statm: a worker's
    own, which the parent's getrusage does not see), and its peak where
    /proc/<pid>/status reports one (VmHWM; None where it does not)."""
    with open(f"/proc/{pid}/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    peak = None
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                peak = int(line.split()[1]) * 1024 / 1e9
    return dict(rss_gb=rss, peak_gb=peak)


def host_memory() -> dict:
    """The shared-memory mount and the host's memory, as `df -B1 /dev/shm`
    and `free -g` print them."""
    return {name: subprocess.run(cmd, capture_output=True, text=True,
                                 check=True).stdout.strip()
            for name, cmd in (("df_dev_shm", ["df", "-B1", "/dev/shm"]),
                              ("free_g", ["free", "-g"]))}


def shm_rates(nbytes: int) -> dict:
    """GB/s of writing an ``nbytes`` array into a fresh shared-memory
    segment (every page faulted in on first touch, as a ring slot's first
    write in each worker is), into the same segment again, and into fresh
    anonymous memory (the trainer's copy out of a slot, the LRU's copy):
    what moving a batch through the ring costs a byte on this host."""
    from repro_torch.core.sampling.proc_prefetch import _ShmArena

    src = np.ones(nbytes // 4, np.float32)
    arena = _ShmArena()
    try:
        view = np.ndarray(src.shape, src.dtype,
                          buffer=arena.create(nbytes, "rate").buf)
        out = {}
        for key in ("shm_first_write", "shm_rewrite"):
            s0 = time.perf_counter()
            np.copyto(view, src)
            out[f"{key}_gb_s"] = nbytes / 1e9 / (time.perf_counter() - s0)
        s0 = time.perf_counter()
        view.copy()
        out["anon_copy_gb_s"] = nbytes / 1e9 / (time.perf_counter() - s0)
        del view
    finally:
        arena.close()
    return out


def record_arrivals(eng, into: list):
    """Wrap the engine's `_finish_batch` (the process mode's take-in on the
    trainer thread) to record, per batch, when it arrived, how long the
    take-in (the upload) took, and the pool's metadata: the worker, the
    seconds it waited for a ring slot, its sample and extract seconds."""
    take = eng._finish_batch

    def finish(arrays, meta, step=None):
        s0 = time.perf_counter()
        batch = take(arrays, meta, step=step)
        pm = meta.get("_pool", {})
        into.append(dict(t=s0, upload_s=time.perf_counter() - s0,
                         worker=pm.get("worker"),
                         stall_s=pm.get("stall_seconds", 0.0),
                         sample_s=meta.get("sample_seconds"),
                         extract_s=meta.get("extract_seconds")))
        return batch
    eng._finish_batch = finish


def check_pipelined(name, state, losses, comm, baseline, keys) -> None:
    """A pipelined epoch against the blocking phase it repeats: the losses
    and the final params bit for bit, the CommStats bytes equal."""
    params = param_copies(state["params"], keys)
    same = losses == baseline["losses"] and all(
        torch.equal(a[key], b[key])
        for a, b in zip(params, baseline["params"]) for key in a)
    check(same, f"{name}: differs from {baseline['name']} (losses {losses}, "
          f"{baseline['name']} {baseline['losses']})")
    check(comm == baseline["comm"], f"{name}: CommStats {comm}, "
          f"{baseline['name']} {baseline['comm']}")


def pipelined_phase(g, device, baseline, mode):
    """The pipelined schedule at full width over ``baseline``'s traffic
    (`mb_node_p2p`: gcn, p2p, node-wise, the sampler settings of
    MB_SAMPLERS): a fresh engine runs `run_epoch_minibatch(MB_STEPS,
    "pipelined")` with the prefetch thread (``mode`` "thread": phase
    mb_node_pipelined) or with the pool of MB_SAMPLE_WORKERS sampling
    processes over a ring of MB_PREFETCH_DEPTH shared-memory slots
    ("process": mb_node_process).  The losses,
    final params and CommStats bytes must equal ``baseline``'s bit for bit
    and the ELL forward's launches `mb_launches`.  Reports the StageTimes,
    busy / wall, `pipelined_wall_model` beside the measured wall, peak
    device memory and host memory.  Process mode also times the pool's
    start-up (`_ensure_proc_pool`: the graph shared, the workers started),
    reports the slot bytes, `/dev/shm` and free RAM read before it, each
    worker's resident set and each batch's arrival (`record_arrivals`);
    then a second epoch on the same pool, whose LRU serves every batch
    (producer seconds 0), and a steady epoch with the LRU emptied (the
    workers write slots they have written before), each bitwise equal
    again, with `shm_rates`; then `close_prefetch_pool()`, after which
    none of this process's segments is left in /dev/shm.  Returns the
    launches."""
    from repro_torch.core.execution.minibatch_pipeline import (
        pipelined_wall_model,
    )
    from repro_torch.core.models.gnn import PARAM_KEYS
    from repro_torch.core.sampling import proc_prefetch

    name = f"mb_node_{'pipelined' if mode == 'thread' else 'process'}"
    keys = PARAM_KEYS["gcn"]
    eng, setup_s = build_mb_engine(
        g, device, "gcn", "p2p", "node_wise", extra=[
            "--schedule", "pipelined", "--prefetch-mode", mode,
            "--prefetch-depth", str(MB_PREFETCH_DEPTH),
            "--num-sample-workers", str(MB_SAMPLE_WORKERS)])
    t0 = time.perf_counter()
    extra = dict(prefetch_depth=eng.cfg.prefetch_depth)
    launches = {}

    def epoch(what, arrivals=None):
        """One pipelined epoch, its launches counted from 0 and added to
        the phase's, held bit for bit to ``baseline``; returns its
        StageTimes."""
        if arrivals is not None:
            record_arrivals(eng, arrivals)
        zero_counts()
        start = time.perf_counter()
        try:
            state, losses, times = eng.run_epoch_minibatch(
                MB_STEPS, "pipelined", prefetch_mode=mode)
        finally:
            eng.__dict__.pop("_finish_batch", None)
        for a in arrivals or ():  # seconds into the epoch
            a["t"] -= start
        n = read_counts()
        check_counts(n, mb_launches(eng, MB_STEPS), what)
        add_counts(launches, n)
        comm = dict(pull_bytes=eng.comm_stats.pull_bytes,
                    cache_hit_bytes=eng.comm_stats.cache_hit_bytes)
        check_pipelined(what, state, losses, comm, baseline, keys)
        extra.setdefault("losses", losses)
        extra.setdefault("comm", comm)
        return times

    def lanes(prefix, times):
        return {f"{prefix}sample_s": times.sample,
                f"{prefix}extract_s": times.extract,
                f"{prefix}train_s": times.train, f"{prefix}wall_s": times.wall,
                f"{prefix}busy_over_wall": times.busy() / times.wall,
                f"{prefix}wall_model_s": pipelined_wall_model(times,
                                                              MB_STEPS)}

    if mode == "process":
        extra.update(host_memory(), num_sample_workers=MB_SAMPLE_WORKERS,
                     shm_free_bytes=proc_prefetch.shm_free_bytes(),
                     graph_shm_bytes=proc_prefetch.graph_shm_nbytes(eng.g))
        s0 = time.perf_counter()
        pool = eng._ensure_proc_pool(eng.cfg.prefetch_depth)
        extra.update(pool_startup_s=time.perf_counter() - s0,
                     slot_bytes=pool.slot_nbytes,
                     ring_bytes=pool.slot_nbytes * pool.depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    arrivals = [] if mode == "process" else None
    times = epoch(name, arrivals)
    peak = torch.cuda.max_memory_allocated()
    extra.update(lanes("", times), wall_per_batch_s=times.wall / MB_STEPS,
                 producer_per_batch_s=(times.sample + times.extract)
                 / MB_STEPS,
                 **{f"{baseline['name']}_wall_s": baseline.get("wall_s"),
                    f"bitwise_equal_to_{baseline['name']}": True})
    if mode == "process":
        extra.update(arrivals=arrivals, workers_memory=[
            proc_memory_gb(p.pid) for p in pool._procs])
        lru = epoch(f"{name} second epoch")
        check(eng._proc_pool is pool and pool.alive and pool.workers_alive,
              f"{name}: the second epoch did not reuse the pool")
        check(lru.sample == 0.0 and lru.extract == 0.0,
              f"{name}: the second epoch's producer seconds {lru.sample}, "
              f"{lru.extract} (the LRU serves it)")
        # the steady state: the LRU emptied, the workers produce again
        # into ring slots every one of them has written before
        pool._cache.clear()
        steady_arrivals = []
        steady = epoch(f"{name} steady epoch", steady_arrivals)
        check(eng._proc_pool is pool and steady.sample > 0,
              f"{name}: the steady epoch did not run on the pool's workers")
        extra.update(second_epoch_wall_s=lru.wall,
                     second_epoch_train_s=lru.train,
                     second_epoch_bitwise_equal=True,
                     **lanes("steady_", steady),
                     steady_arrivals=steady_arrivals,
                     steady_bitwise_equal=True, **shm_rates(SHM_RATE_BYTES))
        mark = f"-{os.getpid():x}-"
        eng.close_prefetch_pool()
        left = [f for f in os.listdir(proc_prefetch.SHM_DIR)
                if f.startswith(proc_prefetch.SHM_PREFIX) and mark in f]
        check(not left and not pool.alive,
              f"{name}: segments left after close_prefetch_pool: {left}")
        extra["segments_left"] = 0
    comm = extra.pop("comm")
    emit(name, model="gcn", execution="p2p", batching="node_wise",
         prefetch_mode=mode, steps=MB_STEPS, launches=launches,
         max_memory_allocated=peak, memory_allocated_at_start=held,
         host_max_rss_gb=host_rss_gb(), host_memory_now=proc_memory_gb(),
         setup_s=setup_s, **comm, seconds=time.perf_counter() - t0, **extra)
    return launches


def mb_serve_phase(g, device):
    """`serve_gnn`'s path at full width: a node_wise engine (the sampler
    settings of the node-wise phases; serve's own lr and cache) trains
    MB_SERVE_STEPS steps through `serve_gnn.train_params`, then one
    layer-wise sweep of the trained params through `serve_gnn.run_sweep`,
    its launches counted; the same sweep on a full-graph engine
    (`build_engine`, p2p) must give the same bits."""
    from repro_torch.launch import serve_gnn

    release()
    t0 = time.perf_counter()
    args = serve_gnn.parse_args([
        "--device", str(device), "--exec", "p2p", "--partitioner", "hash",
        "--hidden", "256", "--layers", "3", "--train-steps",
        str(MB_SERVE_STEPS), *MB_SAMPLERS["node_wise"]])
    eng = serve_gnn.build_engine(args, g)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_counts()
    trained = serve_gnn.train_params(eng, args.train_steps)
    train_launches = read_counts()
    check_counts(train_launches, mb_launches(eng, args.train_steps),
                 "mb_serve training")
    params = trained["params"]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    emb, wall = serve_gnn.run_sweep(eng, params)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L = len(eng.dims) - 1
    B = len(eng.playout.p2p_widths)
    want = dict(ell_spmm=L * eng.cfg.exchange_chunks * (1 + B))
    check_counts(launches, want, "mb_serve sweep")
    check(emb.shape == (g.num_vertices, eng.dims[-1])
          and bool(np.isfinite(emb).all()), f"mb_serve sweep {emb.shape}")
    full, full_setup_s = build_engine(g, eng.cfg.exchange_chunks, device,
                                      "gcn", execution="p2p")
    full_emb, full_wall = serve_gnn.run_sweep(full, params)
    check(np.array_equal(emb, full_emb),
          "mb_serve: the mini-batch engine's sweep differs from the "
          "full-graph engine's")
    emit("mb_serve", model=eng.cfg.model, execution=eng.cfg.execution,
         batching=eng.cfg.batching, cache=eng.cfg.cache_policy,
         cache_capacity=eng.cfg.cache_capacity, lr=eng.cfg.lr,
         train_steps=args.train_steps, losses=trained["losses"],
         train_launches=train_launches, sweep_ms=wall * 1e3,
         full_graph_sweep_ms=full_wall * 1e3, launches=launches,
         bitwise_equal_to_full_graph_sweep=True, max_memory_allocated=peak,
         setup_s=setup_s, full_graph_setup_s=full_setup_s,
         seconds=time.perf_counter() - t0)
    add = dict(train_launches)
    add_counts(add, launches)
    return add


def minibatch_phases(g, device) -> dict:
    """Every mini-batch phase; returns their kernel launches.  gcn node-wise
    under p2p first (`mb_node_p2p`, the epoch, its batches kept) and one
    traced step of it (`mb_train_profile`); sage, gin and gat over the same
    batches; the same in a world-size-1 NCCL group (`nccl_mb_node_p2p`,
    bitwise equal to `mb_node_p2p`); then, the batches released, the
    pipelined epoch over `mb_node_p2p`'s traffic with the prefetch thread
    (`mb_node_pipelined`) and the sampling-process pool (`mb_node_process`),
    each bitwise equal to `mb_node_p2p`; gcn node-wise under broadcast and
    the ring (MB_BASELINE_STEPS each, bitwise equal to `mb_node_p2p`'s first
    at one rank), layer-wise and subgraph under p2p, `mb_trainable` and `mb_serve`."""
    from repro_torch.launch import train_gnn
    from repro_torch.launch.common import join_group, leave_group

    total = {}
    eng, setup_s = build_mb_engine(g, device, "gcn", "p2p", "node_wise")
    node, n = minibatch_phase(eng, setup_s, resample=True)
    add_counts(total, n)
    batches = node.pop("batches")
    step, state = eng.make_minibatch_step(), eng.init_minibatch_state()
    profile_phase("mb_train_profile", lambda: step(state, batches[0]),
                  {"ell_spmm_kernel": mb_launches(eng, 1)["ell_spmm"]},
                  model="gcn", batching="node_wise", execution="p2p",
                  exchange_chunks=eng.cfg.exchange_chunks)
    del eng, step, state
    for model in ("sage", "gin", "gat"):
        eng, setup_s = build_mb_engine(g, device, model, "p2p", "node_wise")
        _, n = minibatch_phase(eng, setup_s, batches=batches)
        add_counts(total, n)
        del eng
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl_mb_")
    group = ["--world-size", "1", "--rank", "0", "--init-method",
             f"file://{rendezvous}/rendezvous"]
    group_args = train_gnn.parse_args(["--device", str(device), *group])
    join_group(group_args)
    try:
        eng, setup_s = build_mb_engine(g, device, "gcn", "p2p", "node_wise",
                                       group)
        _, n = minibatch_phase(eng, setup_s, batches=batches, baseline=node)
        add_counts(total, n)
        del eng
    finally:
        release()
        leave_group(group_args)
        shutil.rmtree(rendezvous, ignore_errors=True)
    del batches
    # the pipelined schedules over mb_node_p2p's traffic: the prefetch
    # thread, then the sampling-process pool
    for mode in ("thread", "process"):
        add_counts(total, pipelined_phase(g, device, node, mode))
    for execution in ("broadcast", "ring"):
        eng, setup_s = build_mb_engine(g, device, "gcn", execution,
                                       "node_wise")
        res, n = minibatch_phase(eng, setup_s, baseline=node,
                                 steps=MB_BASELINE_STEPS)
        add_counts(total, n)
        del eng, res  # and the phase's batches with it
    for batching in ("layer_wise", "subgraph"):
        eng, setup_s = build_mb_engine(g, device, "gcn", "p2p", batching)
        res, n = minibatch_phase(eng, setup_s, resample=True)
        add_counts(total, n)
        del eng, res
    add_counts(total, mb_trainable_phase(g, device))
    add_counts(total, mb_serve_phase(g, device))
    release()
    return total


# ---------------------------------------------------------------------------
# the query-serving latency tier, the run-wide telemetry and the autotuner
# ---------------------------------------------------------------------------


def query_engine(g, device):
    """serve_gnn's node-wise engine for the latency tier at full width
    (`serve_gnn.build_engine`: p2p, the hash partition, QUERY_SAMPLER, the
    static_degree cache at QUERY_CACHE rows) and its seeded initial params
    (`train_params` at 0 steps).  Returns (engine, params, the launcher's
    args, setup seconds)."""
    from repro_torch.launch import serve_gnn

    release()
    t0 = time.perf_counter()
    args = serve_gnn.parse_args([
        "--device", str(device), "--exec", "p2p", "--partitioner", "hash",
        "--hidden", "256", "--layers", "3", *QUERY_SAMPLER, "--cache",
        "static_degree", "--cache-capacity", str(QUERY_CACHE),
        "--train-steps", "0", "--queries", str(QUERY_STREAM),
        "--targets-per-query", str(QUERY_TARGETS)])
    eng = serve_gnn.build_engine(args, g)
    params = serve_gnn.train_params(eng, 0)["params"]
    torch.cuda.synchronize()
    return eng, params, args, time.perf_counter() - t0


def serve_stream(qe, args, ref_gaps=None) -> dict:
    """The latency stream on ``qe``: `serve_gnn.run_query_stream` (a
    warm-up, then args.queries single-request queries), then one flush of
    QUERY_FLUSH_REQUESTS overlapping requests.  Every answer is kept in
    order; each round's host build seconds and its serve seconds (the
    round, then a synchronize) are recorded.  With ``ref_gaps`` the first
    QUERY_REF_ROUNDS rounds are each held to `reference_round` on the same
    batch (their gaps appended; the replay's, whose latency is not
    reported)."""
    from repro_torch.launch import serve_gnn

    answers, builds, serves = [], [], []
    query, build, serve = qe.query, qe.build_round, qe.serve_round

    def timed_query(targets):
        answers.append(query(targets))
        return answers[-1]

    def timed_build(round_targets):
        s0 = time.perf_counter()
        batch = build(round_targets)
        builds.append(time.perf_counter() - s0)
        return batch

    def timed_serve(batch):
        s0 = time.perf_counter()
        out = serve(batch)
        torch.cuda.synchronize()
        serves.append(time.perf_counter() - s0)
        if ref_gaps is not None and len(ref_gaps) < QUERY_REF_ROUNDS:
            ref = qe.reference_round(batch)
            check(ref.shape == out.shape and bool(torch.isfinite(out).all()),
                  f"serve round {tuple(out.shape)}, reference "
                  f"{tuple(ref.shape)}")
            ref_gaps.append(float((out - ref).abs().max()))
        return out

    qe.query, qe.build_round, qe.serve_round = (timed_query, timed_build,
                                                timed_serve)
    try:
        stats = serve_gnn.run_query_stream(
            qe, num_queries=args.queries,
            targets_per_query=args.targets_per_query)
        stream = dict(qps=stats.qps(), p50_ms=stats.percentile_ms(50),
                      p99_ms=stats.percentile_ms(99), rounds=stats.rounds,
                      latencies_ms=[t * 1e3 for t in stats.latencies_s])
        rng = np.random.default_rng(1)
        pool = rng.choice(qe.engine.g.num_vertices, QUERY_FLUSH_POOL,
                          replace=False)
        requests = [rng.choice(pool, args.targets_per_query, replace=False)
                    for _ in range(QUERY_FLUSH_REQUESTS)]
        rids = [qe.submit(r) for r in requests]
        rounds0 = qe.stats.rounds
        s0 = time.perf_counter()
        flushed = qe.flush()
        flush_s = time.perf_counter() - s0
        answers.extend(flushed[r] for r in rids)
    finally:
        for name in ("query", "build_round", "serve_round"):
            qe.__dict__.pop(name, None)
    stream.update(
        flush_requests=len(requests),
        flush_targets_requested=sum(len(r) for r in requests),
        flush_targets_unique=len({int(v) for r in requests for v in r}),
        flush_rounds=qe.stats.rounds - rounds0, flush_ms=flush_s * 1e3)
    return dict(answers=answers, builds=builds, serves=serves, stream=stream)


def query_stream_phase(eng, params, args, setup_s) -> dict:
    """The latency tier at full width: `GNNQueryEngine` over the node-wise
    engine (`query_engine`), the stream and the flush (`serve_stream`),
    the ELL forward's launches counted exactly (p2p's K = 1 send gather, a
    chunk and an installment a round, `mb_launches`) and no other kernel.
    Then a second `GNNQueryEngine` over the same engine replays the same
    stream and flush: its answers must equal the first's bit for bit, and
    its first QUERY_REF_ROUNDS rounds are each held to `reference_round`
    on the same batch within TOL.  Every round must have one shape
    signature (`round_shapes`).  Returns the first run's launches."""
    from repro_torch.core.serving import GNNQueryEngine

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    qe = GNNQueryEngine(eng, params)
    run = serve_stream(qe, args)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rounds = qe.stats.rounds
    check_counts(launches, mb_launches(eng, rounds), "query_stream")
    check(qe.round_shapes() == 1,
          f"query_stream: {qe.round_shapes()} round shapes")
    check(all(a.shape == (args.targets_per_query, eng.dims[-1])
              and np.isfinite(a).all() for a in run["answers"]),
          "query_stream: answers")
    first_s = time.perf_counter() - t0
    # the replay: the same stream on a second query engine, bit for bit,
    # its first rounds held to the reference round
    s0 = time.perf_counter()
    zero_counts()
    gaps = []
    qe2 = GNNQueryEngine(eng, params)
    replay = serve_stream(qe2, args, ref_gaps=gaps)
    check_counts(read_counts(), mb_launches(eng, qe2.stats.rounds),
                 "query_stream replay with its reference rounds")
    bitwise = len(replay["answers"]) == len(run["answers"]) and all(
        np.array_equal(a, b) for a, b in zip(run["answers"],
                                             replay["answers"]))
    check(bitwise, "query_stream: a second GNNQueryEngine over the same "
          "stream answers differently")
    check(len(gaps) == QUERY_REF_ROUNDS and max(gaps) <= TOL,
          f"query_stream: rounds vs reference_round {gaps} > {TOL}")
    check(qe2.round_shapes() == 1, "query_stream replay: round shapes")
    c = eng.cfg
    emit("query_stream", model=c.model, execution=c.execution,
         batching=c.batching, exchange_chunks=c.exchange_chunks,
         vertices=eng.g.num_vertices, dims=eng.dims,
         batch_size=c.batch_size, fanouts=list(c.fanouts),
         caps=list(eng.caps), fcap_widths=eng.fcap_widths,
         cache=c.cache_policy, cache_capacity=c.cache_capacity,
         first_block_bytes=int(eng.caps[1]) * int(eng.caps[0]) * 4,
         queries=args.queries, targets_per_query=args.targets_per_query,
         **run["stream"], round_shapes=qe.round_shapes(),
         build_ms_mean=float(np.mean(run["builds"])) * 1e3,
         build_ms_median=float(np.median(run["builds"])) * 1e3,
         serve_ms_mean=float(np.mean(run["serves"])) * 1e3,
         serve_ms_median=float(np.median(run["serves"])) * 1e3,
         launches=launches, ref_round_gaps=gaps, oracle_tol=TOL,
         bitwise_equal_replay=bitwise, max_memory_allocated=peak,
         setup_s=setup_s, stream_seconds=first_s,
         replay_seconds=time.perf_counter() - s0,
         seconds=time.perf_counter() - t0)
    return launches


def traced_phase(eng) -> dict:
    """The run-wide telemetry on the latency tier's engine: enabled, then
    TRACED_STEPS pipelined (thread) mini-batch steps and one coalesced
    flush of two overlapping requests, held to the reference's trace
    contract (`tests/test_telemetry.py`): the exchange spans' bytes equal
    `CommStats.total()`, every CommStats field its ``comm.*`` counter,
    every step has its sample, extract and train spans, two or more
    lanes, the run summary is JSON, and the Chrome trace written to a
    temporary directory reads back.  Then the full-graph p2p training
    step (`train_gnn.run_training`, TRACED_TRAIN_STEPS steps) four times,
    the telemetry off, on, on, off: the losses bit for bit the same, and
    the traced median step within TRACED_OVERHEAD of the untraced one.
    Launches counted exactly.  Returns them."""
    from repro_torch.core.serving import GNNQueryEngine
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.launch import train_gnn

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    tel = eng.enable_telemetry()
    state, losses, times = eng.run_epoch_minibatch(
        TRACED_STEPS, "pipelined", prefetch_mode="thread")
    check(bool(np.isfinite(losses).all()), f"traced: losses {losses}")
    qe = GNNQueryEngine(eng, state["params"])
    requests = ([1, 2, 3], [3, 4])
    rids = [qe.submit(r) for r in requests]
    answers = qe.flush()
    check(all(answers[r].shape == (len(q), eng.dims[-1])
              for r, q in zip(rids, requests)), "traced: flush answers")
    launches = read_counts()
    check_counts(launches, mb_launches(eng, TRACED_STEPS + qe.stats.rounds),
                 "traced mini-batch steps and flush")
    spans = tel.trace.spans()
    exch = sum(s.labels["bytes"] for s in spans if s.name == "exchange")
    check(exch == eng.comm_stats.total(),
          f"traced: exchange spans {exch} B, CommStats {eng.comm_stats.total()}")
    for name, value in dataclasses.asdict(eng.comm_stats).items():
        got = tel.metrics.counter_total("comm." + name)
        check(got == value, f"traced: comm.{name} {got}, CommStats {value}")
    for stage in ("sample", "extract", "train"):
        steps = {s.labels.get("step") for s in spans if s.name == stage}
        check(set(range(TRACED_STEPS)) <= steps, f"traced: {stage} {steps}")
    chrome = tel.chrome_trace()
    lanes = len({e["tid"] for e in chrome["traceEvents"] if e["ph"] == "X"})
    check(lanes >= 2, f"traced: {lanes} lane(s)")
    hist = tel.histogram("serve.flush_latency_s")
    check(hist.count == 1 and tel.metrics.counter_total("serve.queries")
          == len(requests), "traced: serving counters")
    summary = json.loads(json.dumps(tel.run_summary()))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        tel.write_chrome_trace(path)
        tel.write_step_log(path + ".steps.jsonl")
        with open(path) as f:
            check(json.load(f) == chrome, "traced: the Chrome trace file")
        with open(path + ".steps.jsonl") as f:
            logged = len(f.read().splitlines())
        trace_bytes = os.path.getsize(path)
    # the full-graph step with the telemetry off and on, interleaved
    off = Telemetry(enabled=False)
    runs, walls = [], {False: [], True: []}
    zero_counts()
    for traced in (False, True, True, False):
        eng.telemetry = tel if traced else off
        res = train_gnn.run_training(eng, TRACED_TRAIN_STEPS)
        runs.append(res["losses"])
        walls[traced] += res["walls"]
    eng.telemetry = tel
    train_launches = read_counts()
    B = len(eng.playout.p2p_widths)
    check_counts(train_launches, step_launches(
        "gcn", len(eng.dims) - 1, 1, 4 * TRACED_TRAIN_STEPS, sends=B),
        "traced full-graph steps")
    check(all(r == runs[0] for r in runs),
          "traced: the traced and untraced steps' losses differ")
    untraced_ms = float(np.median(walls[False])) * 1e3
    traced_ms = float(np.median(walls[True])) * 1e3
    check(traced_ms <= untraced_ms * (1.0 + TRACED_OVERHEAD),
          f"traced: median step {traced_ms:.3f} ms traced vs "
          f"{untraced_ms:.3f} ms untraced (> {TRACED_OVERHEAD:.0%})")
    peak = torch.cuda.max_memory_allocated()
    add_counts(launches, train_launches)
    emit("traced", model=eng.cfg.model, execution=eng.cfg.execution,
         batching=eng.cfg.batching, steps=TRACED_STEPS, losses=losses,
         stage_s=dict(sample=times.sample, extract=times.extract,
                      train=times.train, wall=times.wall),
         spans=summary["spans"]["count"],
         span_seconds=summary["spans"]["seconds_by_name"], lanes=lanes,
         exchange_span_bytes=exch, comm_total=eng.comm_stats.total(),
         flush_latency=dict(count=hist.count, p50_s=hist.percentile(50.0),
                            p99_s=hist.percentile(99.0),
                            buckets=list(hist.buckets),
                            counts=list(hist.counts)),
         imbalance=sorted(summary["imbalance"]["metrics"]),
         steps_logged=logged, trace_bytes=trace_bytes,
         train_steps=TRACED_TRAIN_STEPS,
         untraced_walls_ms=[w * 1e3 for w in walls[False]],
         traced_walls_ms=[w * 1e3 for w in walls[True]],
         untraced_median_ms=untraced_ms, traced_median_ms=traced_ms,
         traced_over_untraced=traced_ms / untraced_ms,
         overhead_limit=TRACED_OVERHEAD, launches=launches,
         max_memory_allocated=peak, seconds=time.perf_counter() - t0)
    return launches


def serving_phases(g, device) -> dict:
    """`query_stream` then `traced`, on one latency-tier engine; returns
    their launches."""
    eng, params, args, setup_s = query_engine(g, device)
    total = {}
    add_counts(total, query_stream_phase(eng, params, args, setup_s))
    add_counts(total, traced_phase(eng))
    del eng, params
    release()
    return total


def autotune_validate_phase(device) -> dict:
    """`autotune` (enumerate, choose, validate) on an SBM graph of
    AUTOTUNE_GRAPH's size at k = 1, its dryrun on the card.  At one rank
    every prediction is 0 bytes and every balance 1.0: the phase proves
    that the path runs (the 4-rank proof is the CPU tier).  The dryrun's
    launches are counted exactly against the chosen plan's steps.
    Returns them."""
    from repro_torch.core.engine import DistGNNEngine
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.partition.autotune import autotune

    release()
    t0 = time.perf_counter()
    g = sbm_graph(**AUTOTUNE_GRAPH)
    dims = [g.features.shape[1], AUTOTUNE_HIDDEN, int(g.labels.max()) + 1]
    zero_counts()
    plan, report = autotune(g, 1, dims, "gcn", device=device)
    launches = read_counts()
    tuned_s = time.perf_counter() - t0
    val = report["validation"]
    check(report["chosen"] == plan.label() and len(report["candidates"]) >= 12,
          f"autotune_validate: chose {report['chosen']} of "
          f"{len(report['candidates'])}")
    check(val["ratio"] == 1.0 and val["measured_bytes"]
          == val["predicted_bytes"] == 0, f"autotune_validate: {val}")
    check(all(b["measured"] == b["claimed"] == 1.0
              for b in val["balance"].values()),
          f"autotune_validate: balance {val['balance']}")
    eng = DistGNNEngine(g, cfg=plan.engine_config(), device=device)
    c = eng.cfg
    if c.partition_family == "edge_cut":
        want = step_launches(
            c.model, len(eng.dims) - 1,
            1 if c.execution == "ring" else c.exchange_chunks, val["steps"],
            sends=len(eng.playout.p2p_widths) if c.execution == "p2p" else 0)
    else:
        want = replica_launches(eng, val["steps"], backward=True)
    check_counts(launches, want, "autotune_validate dryrun")
    emit("autotune_validate", vertices=g.num_vertices, edges=g.num_edges,
         dims=dims, graph=report["graph"], chosen=report["chosen"],
         candidates=len(report["candidates"]), validation=val,
         launches=launches, autotune_s=tuned_s,
         seconds=time.perf_counter() - t0)
    del eng
    release()
    return launches


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
    # the edge-cut layout built from a chunked edge stream (host only)
    stream_ingest_phase(g)

    def configuration(chunks, model, execution="broadcast", group=(),
                      baseline=(None, None), against="no_group",
                      family="edge_cut", edge=(None, None)):
        """One configuration's sweep and training phases on one engine;
        ``baseline`` the (sweep, train) results they must equal, ``edge``
        the edge-cut ones a replica family's must be within TOL of."""
        eng, setup_s = build_engine(g, chunks, device, model, group, execution,
                                    family=family)
        params, n, swept = sweep_phase(eng, setup_s, g, baseline[0], against,
                                       edge[0])
        add_counts(launches, n)
        n, trained = train_phase(eng, setup_s, g, baseline[1], against,
                                 edge[1])
        add_counts(launches, n)
        return eng, params, (swept, trained)

    def profile_step(phase, eng, **fields):
        """One traced training step of the engine (`profile_phase`), which
        must hold the step's launches."""
        c = eng.cfg
        step, state = eng.make_step(), eng.init_state()
        if c.partition_family != "edge_cut":
            want = replica_launches(eng, 1, backward=True)
        else:
            B = len(eng.playout.p2p_widths) if c.execution == "p2p" else 0
            C = 1 if c.execution == "ring" else c.exchange_chunks
            want = step_launches(c.model, len(eng.dims) - 1, C, 1, sends=B)
        # the trace names each kernel; the SDDMM wrapper launches two, a
        # row-dots pass and the slot pass: count the slot pass
        expect = {TRACE_NAMES.get(name, f"{name}_kernel"): count
                  for name, count in want.items() if count}
        profile_phase(phase, lambda: step(state), expect,
                      exchange_chunks=c.exchange_chunks, **fields)

    # the results later phases must equal bit for bit: the broadcast
    # phases (the ring's and p2p's at one rank), the no-group phases (the
    # NCCL phases') and p2p_train (the protocols' at one rank)
    baselines = {}
    for model in MODELS:
        for chunks in (1, 2):
            eng, params, result = configuration(chunks, model)
            if model in NCCL_MODELS:
                baselines[model, chunks] = result
            if chunks == 1 and model == "gcn":
                # kernel cases at the main path's own layout, counted apart
                rows.update(ell_spmm=kernel_phase(eng, device),
                            ell_spmm_transpose=transpose_phase(eng, device))
                profile_phase("profile",
                              lambda: eng.infer_full_graph(params=params),
                              {"ell_spmm_kernel": len(eng.dims) - 1},
                              exchange_chunks=1)
            elif chunks == 1:
                for name, extra in gat_kernel_phase(eng, device).items():
                    rows[name] = rows.get(name, []) + extra
            if chunks == 1 or model == "gat":
                profile_step("train_profile" if model == "gcn"
                             else f"{model}_train_profile", eng)
            del eng, params
    # the p2p halo exchange (the default engine) at one rank: its table is
    # the broadcast table with one unread halo row, so each phase must equal
    # the same model's broadcast phase bit for bit
    for model in NCCL_MODELS:
        eng, _, baselines["p2p", model] = configuration(
            NCCL_CHUNKS, model, "p2p", baseline=baselines[model, NCCL_CHUNKS],
            against="broadcast")
        profile_step("p2p_train_profile", eng, model=model)
        del eng
    # the ring at one rank: one round over the rank's own block with the
    # broadcast path's kernels, so each phase must equal the same model's
    # broadcast phase at chunks 1 bit for bit (the ring ignores chunks)
    for model in NCCL_MODELS:
        eng, _, baselines["ring", model] = configuration(
            1, model, "ring", baseline=baselines[model, 1],
            against="broadcast")
        if model == "gat":  # the trace holds the attend's block copy
            profile_step("gat_ring_train_profile", eng, model=model)
        del eng
    # the historical-embedding protocols, gcn at the p2p phases' settings:
    # at one rank no row is a boundary row, so every row reads fresh and
    # each must equal p2p_train bit for bit; the history (2.4 GB) and the
    # ages are held to the reference step's
    for protocol in ASYNC_PROTOCOLS:
        eng, setup_s = build_engine(g, NCCL_CHUNKS, device, "gcn",
                                    execution="p2p", protocol=protocol)
        n, _ = train_phase(eng, setup_s, g, baselines["p2p", "gcn"][1],
                           against="sync")
        add_counts(launches, n)
        del eng
    # trainable features (layer-0 rows learnable, the row-sparse AdamW):
    # gcn at the p2p phases' settings under the edge cut, then under the
    # cartesian2d vertex cut (the gradient's and the delta's combines),
    # each step held to the reference step from the same state
    eng, setup_s = trainable_engine(g, device)
    add_counts(launches, trainable_phase(eng, setup_s, g, TRAINABLE_STEPS,
                                         baselines["p2p", "gcn"][1]))
    del eng
    eng, setup_s = trainable_engine(g, device, family="vertex_cut")
    add_counts(launches, trainable_phase(eng, setup_s, g,
                                         TRAINABLE_VC_STEPS))
    del eng
    # the replica families at one rank: gcn and gat under the cartesian2d
    # vertex cut (p2p at chunks 2, broadcast at 1, the ring) and the hybrid
    # cut (p2p at chunks 2), each held to the same model's edge-cut phase
    # of this run (the family anchor)
    edge_of = {"p2p": lambda m: baselines["p2p", m],
               "broadcast": lambda m: baselines[m, 1],
               "ring": lambda m: baselines["ring", m]}
    for family, execution, chunks in (("vertex_cut", "p2p", NCCL_CHUNKS),
                                      ("vertex_cut", "broadcast", 1),
                                      ("vertex_cut", "ring", 1),
                                      ("hybrid", "p2p", NCCL_CHUNKS)):
        for model in NCCL_MODELS:
            eng, _, result = configuration(
                chunks, model, execution, family=family,
                edge=edge_of[execution](model))
            if family == "vertex_cut" and execution == "p2p":
                baselines["vc", model] = result
                if model == "gat":  # the max pass and the combine's cost
                    profile_step("gat_vc_train_profile", eng, model=model)
            del eng
    # the same paths over a world-size-1 NCCL group, joined through the
    # launchers' group options: the all_gather, its reduce-scatter, the
    # all_to_all and the all_reduce run on the card (the ring issues no
    # rotation at one rank); bitwise equal to the runs without a group
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
            for execution, chunks, baseline in (
                    ("broadcast", NCCL_CHUNKS, baselines[model, NCCL_CHUNKS]),
                    ("p2p", NCCL_CHUNKS, baselines["p2p", model]),
                    ("ring", 1, baselines["ring", model])):
                eng, _, _ = configuration(chunks, model, execution, group,
                                          baseline)
                del eng
            # the vertex cut's p2p combine: its all_to_all installments
            eng, _, _ = configuration(NCCL_CHUNKS, model, "p2p", group,
                                      baselines["vc", model],
                                      family="vertex_cut")
            del eng
    finally:
        release()
        leave_group(group_args)
        shutil.rmtree(rendezvous, ignore_errors=True)
    # the sampled mini-batch step at the same width, after the full-graph
    # phases: its kept batches would count in their peaks
    add_counts(launches, minibatch_phases(g, device))
    # the query-serving latency tier and the run-wide telemetry on one
    # node-wise engine, then the autotuner's validated plan
    add_counts(launches, serving_phases(g, device))
    add_counts(launches, autotune_validate_phase(device))
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
