"""graphsage-reddit [gnn] — arXiv:1706.02216 (Reddit config).

2 layers, d_hidden=128, mean aggregator, neighbor sample sizes 25-10.
"""
from ..models.gnn import GNNConfig

SKIPS: dict = {}


def config() -> GNNConfig:
    return GNNConfig(name="graphsage-reddit", kind="sage", n_layers=2,
                     d_hidden=128, aggregator="mean", sample_sizes=(25, 10))


def smoke_config() -> GNNConfig:
    return GNNConfig(name="graphsage-smoke", kind="sage", n_layers=2,
                     d_hidden=16, aggregator="mean", sample_sizes=(4, 3))
