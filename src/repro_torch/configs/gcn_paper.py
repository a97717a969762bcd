"""gcn-paper — the survey's own workload: a multi-layer GCN on a large graph.

The same numbers as `repro/configs/gcn_paper.py`: the full-graph production
workload (ogbn-papers100M-like scale on a synthetic graph).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNWorkloadConfig:
    name: str = "gcn-paper"
    num_vertices: int = 1_048_576  # 2**20
    avg_degree: int = 16
    feature_dim: int = 256
    hidden_dim: int = 256
    num_classes: int = 64
    num_layers: int = 3
    model: str = "gcn"  # gcn | sage | gat | gin
    execution_model: str = "spmm_1d"
    protocol: str = "broadcast"
    partition: str = "ldg"


CONFIG = GNNWorkloadConfig()


def smoke_config() -> GNNWorkloadConfig:
    return GNNWorkloadConfig(
        name="gcn-paper-smoke",
        num_vertices=256,
        avg_degree=8,
        feature_dim=32,
        hidden_dim=32,
        num_classes=8,
        num_layers=2,
    )
