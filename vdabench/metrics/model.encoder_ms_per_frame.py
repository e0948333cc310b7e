"""Device ms of the encoder per frame encoded (CUDA events around ``encode``).

Read as ``model.encoder_ms_per_frame`` (moves ``frames_per_s``)
and ``model.encoder_ms_per_frame.short``
(``clip_latency_p90_s``).
"""
from vdabench import readers


def read(ctx):
    return readers.encoder_ms_per_frame(ctx)
