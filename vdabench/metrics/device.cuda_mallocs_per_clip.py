"""``cudaMalloc`` calls of PyTorch's caching allocator per clip: the counter
``cuda_mallocs`` of the span ``vda.clip`` over its count, from the totals
of the window's ``collect_timings=True`` calls
(``utils/profiling.py::totals``, which also split it by span). Read in a
traced run on the card; None where the program keeps no such counter.

Read as ``device.cuda_mallocs_per_clip`` (moves ``frames_per_s``) and
``device.cuda_mallocs_per_clip.short`` (``clip_latency_p90_s``).
"""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    if ctx.profile is None or not hasattr(profiling, "totals"):
        return None
    clip = profiling.totals().get("vda.clip")
    if not clip or "cuda_mallocs" not in clip["counters"]:
        return None
    return clip["counters"]["cuda_mallocs"] / clip["count"]
