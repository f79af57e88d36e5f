"""``graph_build_s``: the program's ``TemporalGraph.from_edges`` and
``device_arrays`` on the generated edges, device synced (host clock)."""


def read(ctx):
    return getattr(ctx, "graph_build_s", None)
