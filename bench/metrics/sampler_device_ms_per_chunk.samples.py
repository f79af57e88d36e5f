"""``sampler_device_ms_per_chunk.samples``: the tree sampler's device
time a chunk, from the program's ``sampler.draw`` spans (the launch,
between two CUDA timing events on its stream): their mean ``device_ms``
over the window's chunks outside the profiled slice."""
from bench.yardstick import stages


def read(ctx):
    return stages.mean(stages.window_device_ms(ctx, "sampler.draw"))
