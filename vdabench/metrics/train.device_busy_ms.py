"""Device-busy ms per train step: the union of kernel and copy time of the
profiled span (torch.profiler) over its steps. The step's wall time
(``train_step_ms``) is paced by the host; this is the device's share of
it, which host jitter does not move. It moves ``train_step_ms``."""


def read(ctx):
    prof = ctx.profile
    steps = prof.calls.get("steps", 0) if prof is not None else 0
    return 1e3 * prof.busy_s / steps if steps and prof.busy_s > 0 else None
