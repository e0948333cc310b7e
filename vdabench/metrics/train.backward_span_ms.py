"""Device ms per train step of the span ``vda.train.backward`` (CUDA events
around ``loss.backward()``), from the totals of the window's steps, which
``train_step(phase=...)`` collects (``utils/profiling.py::totals``). Read in
a traced run on the card; None where the program keeps no totals. It
moves ``train_step_ms``."""


def read(ctx):
    from video_depth_anything_torch.utils import profiling

    if ctx.profile is None or not hasattr(profiling, "totals"):
        return None
    bwd = profiling.totals().get("vda.train.backward")
    return 1e3 * bwd["device_s"] / bwd["count"] if bwd and bwd["device_s"] > 0 else None
