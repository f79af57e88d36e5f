"""``kernels_per_lane_chunk.samples``: device operations in the profiled
slice (kernels, copies, fills) over the lane-chunks its cohort windows
ran: each ``engine.dispatch`` span's chunks times its jobs (one seed a
batch, so each job of a cohort is one count lane)."""


def read(ctx):
    s = ctx.slice
    if s is None or not s.device:
        return None
    lane_chunks = sum(a["n"] * a["jobs"] for t0, _, name, a in ctx.spans()
                      if name == "engine.dispatch"
                      and s.host_t0 <= t0 <= s.host_t0 + s.wall_s)
    return len(s.device) / lane_chunks if lane_chunks else None
