"""Share of the output head's calls whose full-resolution tail ran as
kernel K7: the counter ``fused`` of the span ``vda.head.output`` over the
span's count, in %, from the totals of the window's
``collect_timings=True`` calls (``utils/profiling.py::totals``). Read in a
traced run on the card; None where the program keeps no such counter.

Read as ``model.head_output_fused_share`` (moves ``frames_per_s``) and
``model.head_output_fused_share.short`` (``clip_latency_p90_s``).
"""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    if ctx.profile is None or not hasattr(profiling, "totals"):
        return None
    row = profiling.totals().get("vda.head.output")
    if not row or not row["count"] or "fused" not in row["counters"]:
        return None
    return 100.0 * row["counters"]["fused"] / row["count"]
