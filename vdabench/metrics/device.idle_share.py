"""Share of the profiled span with nothing running on the device, in %.

Read as ``device.idle_share.infer`` (moves ``frames_per_s``),
``device.idle_share.short`` (``clip_latency_p90_s``) and
``device.idle_share.train`` (``train_step_ms``).
"""
from vdabench import readers


def read(ctx):
    return readers.idle_share(ctx)
