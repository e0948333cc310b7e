"""Host ms of the pipeline's own work per frame delivered: the self time
of the spans ``vda.clip`` and ``vda.pipeline.*`` other than
``vda.pipeline.wait`` (a block on the device), from the totals of the
window's ``collect_timings=True`` calls (``utils/profiling.py::totals``),
over the frames of their ``vda.clip``. Read in a traced run on the card,
beside the trace whose gaps it explains; None where the program keeps no
totals.

Read as ``pipeline.host_ms_per_frame`` (moves ``frames_per_s``) and
``pipeline.host_ms_per_frame.short`` (``clip_latency_p90_s``).
"""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    if ctx.profile is None or not hasattr(profiling, "totals"):
        return None
    spans = profiling.totals()
    frames = spans.get("vda.clip", {}).get("counters", {}).get("frames", 0)
    if not frames:
        return None
    host = sum(row["self_s"] for name, row in spans.items()
               if name == "vda.clip" or (name.startswith("vda.pipeline.")
                                         and name != "vda.pipeline.wait"))
    return 1e3 * host / frames
