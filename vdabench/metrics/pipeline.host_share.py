"""Share of the clips' wall time outside the pipeline's chunks (``window_forward`` spans), in %.

Read as ``pipeline.host_share`` (moves ``frames_per_s``) and ``pipeline.host_share.short``
(``clip_latency_p90_s``).
"""
from vdabench import readers


def read(ctx):
    return readers.host_share(ctx)
