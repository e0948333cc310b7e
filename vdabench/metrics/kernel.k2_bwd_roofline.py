"""The K2 backward (``csrc/temporal_attention_backward.cu``) against its
roofline, in %: the bound of dq, dk and dv for every step of the profiled
span (two attention blocks in each of the four motion modules, one launch
each, ``counts.k2_backward``) over the backward kernel's profiler time.
It moves ``train_step_ms``."""

PATTERNS = ("temporal_bwd_bf16",)


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.calls.get("steps"):
        return None
    t = prof.kernel_s(PATTERNS)
    if t <= 0:
        return None
    tr = ctx.traffic
    g = tr["size"] // ctx.config["patch_size"]
    bound = sum(2 * ctx.counts.bound_s(*ctx.counts.k2_backward(tr["batch"] * px, tr["clip_len"], c))
                for px, c in ctx.counts.motion_shapes(ctx.config, g, g))
    return 100.0 * prof.calls["steps"] * bound / t
