"""The window's model FLOPs over its time, as a share of the bf16 peak, in %.

Read as ``mfu.infer`` (moves ``frames_per_s``) and ``mfu.short``
(``clip_latency_p90_s``); the train step's is ``mfu.train.py``.
"""
from vdabench import readers


def read(ctx):
    return readers.mfu_infer(ctx)
