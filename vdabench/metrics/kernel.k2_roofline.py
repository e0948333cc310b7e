"""K2's forward (``csrc/temporal_attention.cu``) against its roofline, in %.

Read as ``kernel.k2_roofline`` (moves ``frames_per_s``) and ``kernel.k2_roofline.short``
(``clip_latency_p90_s``).
"""
from vdabench import readers

PATTERNS = ("temporal_bf16",)


def read(ctx):
    return readers.k2_roofline(ctx, PATTERNS)
