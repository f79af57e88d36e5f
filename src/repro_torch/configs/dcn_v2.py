"""dcn-v2 [recsys] — arXiv:2008.13535.

13 dense + 26 sparse features, embed_dim=16, 3 full-rank cross layers,
MLP 1024-1024-512.  Table sizes follow the Criteo-1TB cardinality profile
(a few 10M-row hash buckets, a tail of small vocabularies) — the sparse
lookup over ~76M total rows is the hot path the EmbeddingBag kernel serves.
"""
from ..models.recsys import RecsysConfig

SKIPS: dict = {}

# 26 per-feature vocabulary sizes (Criteo-like skew, largest first)
_TABLE_SIZES = (
    10_000_000, 10_000_000, 10_000_000, 8_000_000, 6_000_000, 5_000_000,
    4_000_000, 3_000_000, 2_000_000, 1_500_000, 1_000_000, 800_000,
    600_000, 400_000, 300_000, 200_000, 100_000, 50_000, 20_000, 10_000,
    4_000, 2_000, 1_000, 500, 200, 100,
)


def config() -> RecsysConfig:
    return RecsysConfig(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                        n_cross_layers=3, mlp=(1024, 1024, 512),
                        table_sizes=_TABLE_SIZES)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(name="dcn-v2-smoke", n_dense=13, n_sparse=26,
                        embed_dim=8, n_cross_layers=2, mlp=(64, 32),
                        table_sizes=tuple([256] * 26))
