"""K1 (``csrc/spatial_attention.cu``) against its roofline, in %.

Read as ``kernel.k1_roofline`` (moves ``frames_per_s``) and ``kernel.k1_roofline.short``
(``clip_latency_p90_s``).
"""
from vdabench import readers

PATTERNS = ("attention_bf16<64, false",)


def read(ctx):
    return readers.k1_roofline(ctx, PATTERNS)
