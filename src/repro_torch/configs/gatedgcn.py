"""gatedgcn [gnn] — arXiv:2003.00982 (benchmark-GNNs GatedGCN).

16 layers, d_hidden=70, gated aggregator with edge-feature state.
"""
from ..models.gnn import GNNConfig

SKIPS: dict = {}


def config() -> GNNConfig:
    return GNNConfig(name="gatedgcn", kind="gatedgcn", n_layers=16,
                     d_hidden=70, aggregator="gated")


def smoke_config() -> GNNConfig:
    return GNNConfig(name="gatedgcn-smoke", kind="gatedgcn", n_layers=3,
                     d_hidden=8, aggregator="gated")
