"""``device_idle.samples``: the share of the profiled slice (host clock,
ending in a device sync) in which no device operation ran: 1 - the
union of the device intervals over the slice's length."""


def read(ctx):
    s = ctx.slice
    return None if s is None or not s.device else 100.0 * s.idle_share
