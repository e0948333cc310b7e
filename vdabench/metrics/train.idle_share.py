"""Share of the profiled span in which the device idles while the host runs
the program's own Python between its ops, in %: the idle gaps whose
innermost host event (the one ``vdabench/trace.py`` names a gap after) is
one of the program's ranges (``vda.`` and a dot: the train step's stages,
the encoder's and the head's; not the custom ops' ``vda::``), over the
span. A gap under an ATen op, a launch or the optimizer's step is named
after that event and is not counted here, although it lies inside the
step's ranges; ``device.idle_share.train`` counts every gap. None where the
program opens no range (``utils/profiling.py::span``). It moves
``train_step_ms``."""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    prof = ctx.profile
    if prof is None or prof.window_s <= 0 or not hasattr(profiling, "span"):
        return None
    idle = sum(s for name, s in prof.gaps.items() if name.startswith("vda."))
    return 100.0 * idle / prof.window_s
