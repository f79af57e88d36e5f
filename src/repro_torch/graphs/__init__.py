"""Temporal graph sources: synthetic generators (own copy of
``repro.graphs.synth``) and edge-list files (``repro.graphs.loader``)."""
from .loader import iter_edge_batches, load_edge_list, save_edge_list
from .synth import (er_temporal_graph, fintxn_temporal_graph,
                    powerlaw_temporal_graph)

__all__ = ["er_temporal_graph", "fintxn_temporal_graph",
           "iter_edge_batches", "load_edge_list", "powerlaw_temporal_graph",
           "save_edge_list"]
