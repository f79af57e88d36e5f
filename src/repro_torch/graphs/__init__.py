"""Temporal graph sources: synthetic generators (own copy of
``repro.graphs.synth``) and edge-list files (``repro.graphs.loader``);
the GNN minibatch ``NeighborSampler`` (``repro.graphs.neighbor_sampler``)."""
from .loader import iter_edge_batches, load_edge_list, save_edge_list
from .neighbor_sampler import NeighborSampler
from .synth import (er_temporal_graph, fintxn_temporal_graph,
                    powerlaw_temporal_graph)

__all__ = ["NeighborSampler", "er_temporal_graph", "fintxn_temporal_graph",
           "iter_edge_batches", "load_edge_list", "powerlaw_temporal_graph",
           "save_edge_list"]
