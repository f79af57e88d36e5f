"""``tree_sampler_roofline.samples``: the tree-sampler kernel's share of
its memory roofline over the profiled slice: the bytes its function
must move on the chunks it drew (``yardstick.bytes.sampler_bytes`` on
the reference's re-derivation of the same chunks) at the card's
published HBM rate, over the kernel's own device time.  Nothing when
the slice's launches and the re-derived chunks do not pair up."""
from bench.yardstick.peaks import HBM_BYTES_PER_S


def read(ctx):
    s = ctx.slice
    if s is None:
        return None
    k = s.kernels("tree_sampler")
    if not k or len(k) != getattr(ctx, "sampler_launches", -1):
        return None
    busy = sum(e - b for b, e, _ in k) / 1e9
    return 100.0 * ctx.sampler_bytes / HBM_BYTES_PER_S / busy
