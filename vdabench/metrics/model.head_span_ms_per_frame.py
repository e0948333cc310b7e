"""Device ms of the head per frame delivered: the span ``vda.head``'s
CUDA-event intervals over the ``frames`` of ``vda.clip``, from the totals
of the window's ``collect_timings=True`` calls
(``utils/profiling.py::totals``). Read in a traced run on the card; None
where the program keeps no totals.

Read as ``model.head_span_ms_per_frame`` (moves ``frames_per_s``) and
``model.head_span_ms_per_frame.short`` (``clip_latency_p90_s``).
"""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    if ctx.profile is None or not hasattr(profiling, "totals"):
        return None
    spans = profiling.totals()
    head = spans.get("vda.head", {}).get("device_s", 0.0)
    frames = spans.get("vda.clip", {}).get("counters", {}).get("frames", 0)
    return 1e3 * head / frames if frames and head > 0 else None
