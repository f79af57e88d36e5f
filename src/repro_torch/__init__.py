"""TIMEST in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro`` (which stays the reference).  It
imports neither ``jax`` nor ``repro``.  One estimate::

    from repro_torch import estimate, get_motif, powerlaw_temporal_graph
    g = powerlaw_temporal_graph(n=150, m=2000, time_span=40000, seed=11)
    res = estimate(g, get_motif("M5-3"), delta=3000, k=1024, chunk=256)

Many related queries share one resident ``Session`` (``repro_torch.api``)
or one ``estimate_many`` call; ``count_exact`` is the exact oracle.

Entry points run on the card (``device="cuda"``) and raise without one;
pass ``device="cpu"`` to run the plain torch versions of the kernels.
"""
from .api import EstimateConfig, Request, Session
from .core.batch import BatchPlanner, estimate_many
from .core.estimator import (EstimateResult, choose_tree, estimate,
                             unbias_estimate)
from .core.exact import count_exact
from .core.graph import TemporalGraph
from .core.motif import MOTIFS, TemporalMotif, get_motif
from .core.weights import Weights, preprocess
from .graphs import (er_temporal_graph, fintxn_temporal_graph,
                     load_edge_list, powerlaw_temporal_graph, save_edge_list)

__all__ = ["BatchPlanner", "EstimateConfig", "EstimateResult", "MOTIFS",
           "Request", "Session", "TemporalGraph", "TemporalMotif", "Weights",
           "choose_tree", "count_exact", "er_temporal_graph", "estimate",
           "estimate_many", "fintxn_temporal_graph", "get_motif",
           "load_edge_list", "powerlaw_temporal_graph", "preprocess",
           "save_edge_list", "unbias_estimate"]
