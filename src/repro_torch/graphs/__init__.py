"""Synthetic temporal graph generators (own copy of ``repro.graphs.synth``)."""
from .synth import (er_temporal_graph, fintxn_temporal_graph,
                    powerlaw_temporal_graph)

__all__ = ["er_temporal_graph", "fintxn_temporal_graph",
           "powerlaw_temporal_graph"]
