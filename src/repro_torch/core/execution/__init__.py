"""Execution models (survey §6): chunked aggregation, replica sync, the SpMM
models over a process grid, the bucketed and chunked exchange, the
collectives and the mini-batch stage schedules.

Exports resolve LAZILY (PEP 562): most submodules here import torch, but
the process-pool sampling workers import the numpy-only `bucketing`
submodule of this package and must not import torch just for touching
``repro_torch.core.execution``.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "one_shot_aggregate": "repro_torch.core.execution.chunk",
    "parallel_chunk_aggregate": "repro_torch.core.execution.chunk",
    "sequential_chunk_aggregate": "repro_torch.core.execution.chunk",
    "REPLICA_EXECUTIONS": "repro_torch.core.execution.replica_sync",
    "build_replica_sync_plan": "repro_torch.core.execution.replica_sync",
    "reference_combine": "repro_torch.core.execution.replica_sync",
    "replica_combine": "repro_torch.core.execution.replica_sync",
    "SCHEDULES": "repro_torch.core.execution.minibatch_pipeline",
    "PullPushPlan": "repro_torch.core.execution.minibatch_pipeline",
    "StageTimes": "repro_torch.core.execution.minibatch_pipeline",
    "p3_plan": "repro_torch.core.execution.minibatch_pipeline",
    "pipelined_wall_model": "repro_torch.core.execution.minibatch_pipeline",
    "run_conventional": "repro_torch.core.execution.minibatch_pipeline",
    "run_factored": "repro_torch.core.execution.minibatch_pipeline",
    "run_operator_parallel": "repro_torch.core.execution.minibatch_pipeline",
    "run_pipelined": "repro_torch.core.execution.minibatch_pipeline",
    "run_pipelined_process": "repro_torch.core.execution.minibatch_pipeline",
    "bucketed_all_to_all": "repro_torch.core.execution.pipeline_exchange",
    "bucketed_cap_widths": "repro_torch.core.execution.bucketing",
    "bucketed_send_table": "repro_torch.core.execution.bucketing",
    "halo_slot": "repro_torch.core.execution.bucketing",
    "chunked_overlap": "repro_torch.core.execution.pipeline_exchange",
    "feature_chunks": "repro_torch.core.execution.pipeline_exchange",
    "SPMM_MODELS": "repro_torch.core.execution.spmm_models",
    "ProcessGrid": "repro_torch.core.execution.spmm_models",
    "p2p_plan": "repro_torch.core.execution.spmm_models",
    "process_grid": "repro_torch.core.execution.spmm_models",
    "spmm_15d": "repro_torch.core.execution.spmm_models",
    "spmm_1d_broadcast": "repro_torch.core.execution.spmm_models",
    "spmm_1d_p2p": "repro_torch.core.execution.spmm_models",
    "spmm_1d_ring": "repro_torch.core.execution.spmm_models",
    "spmm_2d_summa": "repro_torch.core.execution.spmm_models",
    "spmm_replicated": "repro_torch.core.execution.spmm_models",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


if TYPE_CHECKING:  # static analyzers see the eager imports
    from repro_torch.core.execution.bucketing import (  # noqa: F401
        bucketed_cap_widths,
        bucketed_send_table,
        halo_slot,
    )
    from repro_torch.core.execution.chunk import (  # noqa: F401
        one_shot_aggregate,
        parallel_chunk_aggregate,
        sequential_chunk_aggregate,
    )
    from repro_torch.core.execution.minibatch_pipeline import (  # noqa: F401
        SCHEDULES,
        PullPushPlan,
        StageTimes,
        p3_plan,
        pipelined_wall_model,
        run_conventional,
        run_factored,
        run_operator_parallel,
        run_pipelined,
        run_pipelined_process,
    )
    from repro_torch.core.execution.pipeline_exchange import (  # noqa: F401
        bucketed_all_to_all,
        chunked_overlap,
        feature_chunks,
    )
    from repro_torch.core.execution.replica_sync import (  # noqa: F401
        REPLICA_EXECUTIONS,
        build_replica_sync_plan,
        reference_combine,
        replica_combine,
    )
    from repro_torch.core.execution.spmm_models import (  # noqa: F401
        SPMM_MODELS,
        ProcessGrid,
        p2p_plan,
        process_grid,
        spmm_15d,
        spmm_1d_broadcast,
        spmm_1d_p2p,
        spmm_1d_ring,
        spmm_2d_summa,
        spmm_replicated,
    )
