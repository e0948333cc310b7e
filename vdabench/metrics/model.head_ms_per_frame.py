"""Device ms of the head per frame delivered (CUDA events from forward hooks on ``model.head``).

Read as ``model.head_ms_per_frame`` (moves ``frames_per_s``) and ``model.head_ms_per_frame.short``
(``clip_latency_p90_s``).
"""
from vdabench import readers


def read(ctx):
    return readers.head_ms_per_frame(ctx)
