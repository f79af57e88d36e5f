"""graphcast [gnn] — arXiv:2212.12794 (encoder-processor-decoder mesh GNN).

16 processor layers, d_hidden=512, mesh_refinement=6, sum aggregator,
n_vars=227.  For the generic assigned shapes the provided graph plays the
*grid* role and a synthetic coarse mesh (1 mesh node per ``mesh_ratio``
grid nodes, matching GraphCast's ~1M grid / 40k mesh ratio) is derived
deterministically from the shape — see the reference's launch/specs.py.
"""
from ..models.gnn import GNNConfig

SKIPS: dict = {}


def config() -> GNNConfig:
    return GNNConfig(name="graphcast", kind="graphcast", n_layers=16,
                     d_hidden=512, aggregator="sum", mesh_refinement=6,
                     n_vars=227, mesh_ratio=25)


def smoke_config() -> GNNConfig:
    return GNNConfig(name="graphcast-smoke", kind="graphcast", n_layers=2,
                     d_hidden=16, aggregator="sum", mesh_refinement=2,
                     n_vars=8, mesh_ratio=4)
