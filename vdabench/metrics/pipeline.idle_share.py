"""Share of the profiled span in which the device idles while the host runs
the pipeline's own Python, in %: the idle gaps whose innermost host event
(the one ``vdabench/trace.py`` names a gap after) is the program's range
``vda.clip`` or a ``vda.pipeline.*`` range, over the span; a gap under an
ATen op or a CUDA call inside those ranges is not counted. None where the
program opens no range (``utils/profiling.py::span``).

Read as ``pipeline.idle_share`` (moves ``frames_per_s``) and
``pipeline.idle_share.short`` (``clip_latency_p90_s``).
"""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    prof = ctx.profile
    if prof is None or prof.window_s <= 0 or not hasattr(profiling, "span"):
        return None
    idle = sum(s for name, s in prof.gaps.items()
               if name == "vda.clip" or name.startswith("vda.pipeline."))
    return 100.0 * idle / prof.window_s
