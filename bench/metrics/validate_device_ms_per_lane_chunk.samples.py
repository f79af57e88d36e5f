"""``validate_device_ms_per_lane_chunk.samples``: validation's device
time a lane-chunk, from the program's ``validate.lane`` spans (one count
lane's torch ops and sums on one chunk, between two CUDA timing
events): their mean ``device_ms`` over the window's lane-chunks outside
the profiled slice."""
from bench.yardstick import stages


def read(ctx):
    return stages.mean(stages.window_device_ms(ctx, "validate.lane"))
