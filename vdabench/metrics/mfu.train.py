"""Model FLOPs of the window's train steps over the window's time, as a
share of the card's bf16 peak, in %: per step the encoder's forward on
every frame, the head's forward and its backward (FlopCounterMode on the
reference, ``counts.model_flops(train=True)``), however the program
computes them. It moves ``train_step_ms``."""


def read(ctx):
    if not ctx.steps or not ctx.window_s:
        return None
    tr = ctx.traffic
    s = tr["size"]
    f = ctx.counts.model_flops(ctx.config, (s, s), tr["clip_len"], train=True)
    per_step = tr["batch"] * (tr["clip_len"] * f["encoder"] + f["head"] + f["head_backward"])
    return 100.0 * ctx.steps * per_step / ctx.window_s / ctx.counts.PEAK_FLOPS
