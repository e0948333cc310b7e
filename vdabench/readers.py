"""The per-layer metrics' arithmetic, shared by the small files of
``metrics/``: each file names its quantity's reader here and, for a
kernel, the kernel-name patterns it reads in the profiler. A reader
returns None where the run has nothing to read; a share is in %."""
from __future__ import annotations


def host_share(ctx):
    """1 - the pipeline's ``window_forward`` spans over the clips' wall
    time (``collect_timings=True``)."""
    spans = getattr(ctx, "spans", None)
    if not spans or spans["clip_wall"] <= 0 or spans["window_forward"] <= 0:
        return None
    return 100.0 * (1.0 - spans["window_forward"] / spans["clip_wall"])


def encoder_ms_per_frame(ctx):
    """CUDA events around ``encode`` over the window, per frame encoded."""
    enc = getattr(ctx, "encode", None)
    return 1e3 * enc[0] / enc[1] if enc and enc[1] else None


def head_ms_per_frame(ctx):
    """CUDA events around the head's forward over the window, per frame
    delivered."""
    head = getattr(ctx, "head", None)
    return 1e3 * head[0] / ctx.frames if head and ctx.frames else None


def idle_share(ctx):
    """The profiled span's time with no kernel, copy or memset running."""
    prof = ctx.profile
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)


def k1_roofline(ctx, patterns):
    """The bound of the K1 work of the profiled span's encoder calls (every
    block up to the last tap, one launch each) over K1's profiler time."""
    prof = ctx.profile
    frames = prof.calls.get("encode_frames", []) if prof is not None else []
    t = prof.kernel_s(patterns) if frames else 0.0
    if t <= 0:
        return None
    blocks = max(ctx.config["taps"]) + 1
    bound = sum(blocks * ctx.counts.bound_s(*(x / blocks for x in ctx.counts.encoder_k1(
        ctx.config, n, ctx.ph, ctx.pw))) for n in frames)
    return 100.0 * bound / t


def k2_roofline(ctx, patterns):
    """The bound of the K2 forward work of the profiled span's head calls
    (two attention blocks in each motion module, one launch each) over
    K2's profiler time."""
    prof = ctx.profile
    windows = prof.calls.get("head_windows", []) if prof is not None else []
    t = prof.kernel_s(patterns) if windows else 0.0
    if t <= 0:
        return None
    frames = ctx.config["num_frames"]
    bound = sum(2 * ctx.counts.bound_s(*ctx.counts.k2(w * px, frames, c)) for w in windows
                for px, c in ctx.counts.motion_shapes(ctx.config, ctx.ph, ctx.pw))
    return 100.0 * bound / t


def mfu_infer(ctx):
    """The reference's FLOPs (FlopCounterMode on meta tensors) of the frames
    encoded and the windows the head ran in the window, over its time, as
    a share of the bf16 peak."""
    enc, head = getattr(ctx, "encode", None), getattr(ctx, "head", None)
    if not enc or not head or not ctx.window_s:
        return None
    flops = ctx.counts.model_flops(ctx.config, ctx.net_hw, ctx.config["num_frames"])
    work = enc[1] * flops["encoder"] + head[1] * flops["head"]
    return 100.0 * work / ctx.window_s / ctx.counts.PEAK_FLOPS
