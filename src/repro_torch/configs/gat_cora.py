"""gat-cora [gnn] — arXiv:1710.10903 (paper config for Cora).

2 layers, d_hidden=8, 8 heads, attention aggregator.
"""
from ..models.gnn import GNNConfig

SKIPS: dict = {}


def config() -> GNNConfig:
    return GNNConfig(name="gat-cora", kind="gat", n_layers=2, d_hidden=8,
                     n_heads=8, aggregator="attn")


def smoke_config() -> GNNConfig:
    return GNNConfig(name="gat-cora-smoke", kind="gat", n_layers=2,
                     d_hidden=4, n_heads=2, aggregator="attn")
