"""Share of the fused SwiGLU's gate calls that ran as kernel K8: the
counter ``fused`` of the span ``vda.encoder.swiglu`` over the span's
count, in %, from the totals of the window's ``collect_timings=True``
calls (``utils/profiling.py::totals``). Read in a traced run on the card,
where it should read 100 on the bf16 path; None where the program keeps
no such span or counter.

Read as ``model.encoder_swiglu_fused_share`` (moves ``frames_per_s``).
"""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    if ctx.profile is None or not hasattr(profiling, "totals"):
        return None
    row = profiling.totals().get("vda.encoder.swiglu")
    if not row or not row["count"] or "fused" not in row["counters"]:
        return None
    return 100.0 * row["counters"]["fused"] / row["count"]
