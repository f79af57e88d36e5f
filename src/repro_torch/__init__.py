"""TIMEST in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro`` (which stays the reference).  It
imports neither ``jax`` nor ``repro``.  One estimate::

    from repro_torch import estimate, get_motif, powerlaw_temporal_graph
    g = powerlaw_temporal_graph(n=150, m=2000, time_span=40000, seed=11)
    res = estimate(g, get_motif("M5-3"), delta=3000, k=1024, chunk=256)

Entry points run on the card (``device="cuda"``) and raise without one;
pass ``device="cpu"`` to run the plain torch versions of the kernels.
"""
from .core.estimator import (EstimateResult, choose_tree, estimate,
                             unbias_estimate)
from .core.graph import TemporalGraph
from .core.motif import MOTIFS, TemporalMotif, get_motif
from .core.weights import Weights, preprocess
from .graphs import (er_temporal_graph, fintxn_temporal_graph,
                     powerlaw_temporal_graph)

__all__ = ["EstimateResult", "MOTIFS", "TemporalGraph", "TemporalMotif",
           "Weights", "choose_tree", "er_temporal_graph", "estimate",
           "fintxn_temporal_graph", "get_motif", "powerlaw_temporal_graph",
           "preprocess", "unbias_estimate"]
