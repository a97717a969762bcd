"""Graph and feature partitioning (survey §4): the edge cuts, the vertex
cuts and their layouts, the cost models and the feature shardings.

Exports resolve LAZILY (PEP 562): the process-pool sampling workers import
numpy-only submodules of this package and must not import torch just for
touching ``repro_torch.core.partition``.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "bgl_score": "repro_torch.core.partition.cost_models",
    "bytegnn_score": "repro_torch.core.partition.cost_models",
    "edge_cut_halo_bytes_per_step": "repro_torch.core.partition.cost_models",
    "pagraph_score": "repro_torch.core.partition.cost_models",
    "replica_sync_bytes_per_step": "repro_torch.core.partition.cost_models",
    "PARTITIONERS": "repro_torch.core.partition.edge_cut",
    "Partition": "repro_torch.core.partition.edge_cut",
    "block_partition": "repro_torch.core.partition.edge_cut",
    "hash_partition": "repro_torch.core.partition.edge_cut",
    "ldg_partition": "repro_torch.core.partition.edge_cut",
    "metis_like_partition": "repro_torch.core.partition.edge_cut",
    "range_partition": "repro_torch.core.partition.edge_cut",
    "range_partition_by_cost": "repro_torch.core.partition.edge_cut",
    "FeatureShards": "repro_torch.core.partition.feature_partition",
    "column_partition": "repro_torch.core.partition.feature_partition",
    "replicated": "repro_torch.core.partition.feature_partition",
    "row_partition": "repro_torch.core.partition.feature_partition",
    "row_partition_with_halo": "repro_torch.core.partition.feature_partition",
    "twod_partition": "repro_torch.core.partition.feature_partition",
    "VERTEX_CUTS": "repro_torch.core.partition.vertex_cut",
    "VertexCut": "repro_torch.core.partition.vertex_cut",
    "cartesian_2d_vertex_cut": "repro_torch.core.partition.vertex_cut",
    "edge_endpoints": "repro_torch.core.partition.vertex_cut",
    "grid_for": "repro_torch.core.partition.vertex_cut",
    "libra_vertex_cut": "repro_torch.core.partition.vertex_cut",
    "random_vertex_cut": "repro_torch.core.partition.vertex_cut",
    "VertexCutLayout": "repro_torch.core.partition.vertex_layout",
    "build_vertex_layout": "repro_torch.core.partition.vertex_layout",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


if TYPE_CHECKING:  # static analyzers see the eager imports
    from repro_torch.core.partition.cost_models import (  # noqa: F401
        bgl_score,
        bytegnn_score,
        edge_cut_halo_bytes_per_step,
        pagraph_score,
        replica_sync_bytes_per_step,
    )
    from repro_torch.core.partition.edge_cut import (  # noqa: F401
        PARTITIONERS,
        Partition,
        block_partition,
        hash_partition,
        ldg_partition,
        metis_like_partition,
        range_partition,
        range_partition_by_cost,
    )
    from repro_torch.core.partition.feature_partition import (  # noqa: F401
        FeatureShards,
        column_partition,
        replicated,
        row_partition,
        row_partition_with_halo,
        twod_partition,
    )
    from repro_torch.core.partition.vertex_cut import (  # noqa: F401
        VERTEX_CUTS,
        VertexCut,
        cartesian_2d_vertex_cut,
        edge_endpoints,
        grid_for,
        libra_vertex_cut,
        random_vertex_cut,
    )
    from repro_torch.core.partition.vertex_layout import (  # noqa: F401
        VertexCutLayout,
        build_vertex_layout,
    )
