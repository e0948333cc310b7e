"""Device ms of the encoder per frame encoded: the span ``vda.encoder``'s
CUDA-event intervals over its ``frames``, from the totals of the window's
``collect_timings=True`` calls (``utils/profiling.py::totals``). Read in a
traced run on the card; None where the program keeps no totals.

Read as ``model.encoder_span_ms_per_frame`` (moves ``frames_per_s``) and
``model.encoder_span_ms_per_frame.short`` (``clip_latency_p90_s``).
"""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    if ctx.profile is None or not hasattr(profiling, "totals"):
        return None
    enc = profiling.totals().get("vda.encoder")
    frames = enc["counters"].get("frames", 0) if enc else 0
    return 1e3 * enc["device_s"] / frames if frames and enc["device_s"] > 0 else None
