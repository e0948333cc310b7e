"""Device ms per train step from ``train_step``'s ``phase("backward")`` to
its ``phase("optimizer")`` (CUDA events), the mean over the window's
steps. It moves ``train_step_ms``."""


def read(ctx):
    return getattr(ctx, "backward_ms", None) or None
