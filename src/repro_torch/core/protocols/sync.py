"""Synchronous communication protocols' cost model (the port's copy of
`repro/core/protocols/sync.py`, survey §7.1): bytes and messages a layer
for broadcast, selective P2P, pipeline (ring overlap), remote partial
aggregation and shared memory, number for number the reference's.

The collective programs themselves are the SpMM execution models
(`core/execution/spmm_models.py`) and the engine's exchanges; this module
is the protocol-level cost model the benchmarks and the trainers share.
`remote_partial_aggregation_cost` counts over the CSR at once (the
reference loops over every vertex); the count is the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.partition.edge_cut import Partition
from repro_torch.core.partition.vertex_cut import edge_endpoints

FEAT_BYTES = 4


@dataclasses.dataclass
class ProtocolCost:
    protocol: str
    bytes_per_layer: int
    messages_per_layer: int


def broadcast_cost(g: Graph, part: Partition, hidden_dim: int) -> ProtocolCost:
    """Every worker broadcasts its full H block to all others (CAGNET 1D):
    bytes = (k-1) * |V_i| * D summed over i."""
    k = part.num_parts
    sizes = np.bincount(part.assignment, minlength=k)
    total = int(((k - 1) * sizes).sum()) * hidden_dim * FEAT_BYTES
    return ProtocolCost("broadcast", total, k * (k - 1))


def p2p_cost(g: Graph, part: Partition, hidden_dim: int) -> ProtocolCost:
    """Only boundary vertices cross the wire (ParallelGCN/DistGNN)."""
    total_rows = part.communication_volume(g)
    msgs = 0
    for i in range(part.num_parts):
        bnd = part.boundary_vertices(g, i)
        msgs += len(np.unique(part.assignment[bnd])) if len(bnd) else 0
    return ProtocolCost("p2p", total_rows * hidden_dim * FEAT_BYTES, msgs)


def pipeline_cost(g: Graph, part: Partition, hidden_dim: int,
                  num_chunks: int = 4) -> ProtocolCost:
    """Pipeline = P2P bytes in num_chunks stages whose communication
    overlaps the previous chunk's partial aggregation (G3/SAR): the same
    volume, its latency hidden; reports the volume and the stage count."""
    base = p2p_cost(g, part, hidden_dim)
    return ProtocolCost("pipeline", base.bytes_per_layer,
                        base.messages_per_layer * num_chunks)


def remote_partial_aggregation_cost(g: Graph, part: Partition,
                                    hidden_dim: int) -> ProtocolCost:
    """DeepGalois/DistGNN cd-0: aggregate remote chunks at the OWNER, ship
    one partial sum per (vertex, remote worker) pair instead of every
    neighbor: a vertex whose in-neighbors have n distinct owners adds
    max(0, n - 1) pairs."""
    k = part.num_parts
    src, dst = edge_endpoints(g)
    pairs = np.unique(dst * k + part.assignment.astype(np.int64)[src])
    per_vertex = np.bincount(pairs // k, minlength=g.num_vertices)
    total = int(np.maximum(per_vertex - 1, 0).sum())
    return ProtocolCost("remote_partial_agg", total * hidden_dim * FEAT_BYTES,
                        total)


def shared_memory_cost(g: Graph, part: Partition, hidden_dim: int,
                       pcie_ratio: float = 0.25) -> ProtocolCost:
    """ROC/NeuGraph: all embeddings live in host memory; every layer
    streams each partition's working set over PCIe: bytes = the full
    frontier, no network, scaled by the relative bandwidth."""
    total = g.num_vertices * hidden_dim * FEAT_BYTES
    return ProtocolCost("shared_memory", int(total / max(pcie_ratio, 1e-9)),
                        part.num_parts)


PROTOCOL_COSTS = {
    "broadcast": broadcast_cost,
    "p2p": p2p_cost,
    "pipeline": pipeline_cost,
    "remote_partial_agg": remote_partial_aggregation_cost,
    "shared_memory": shared_memory_cost,
}
