"""K8, the fused SwiGLU's gate (``csrc/swiglu.cu``), against its roofline, in %.

The bound is bytes alone (the gate does no products the tensor cores
could take): per encoded frame, (ph pw + 1) tokens x the blocks that run
(up to the last tap) x 3H x 2 bytes, w12's output [.., 2H] read once and
the gate [.., H] written once in bf16, at the HBM rate
(``counts.bound_s``), over K8's profiler time, found by the kernel's name.
None in a configuration without the fused SwiGLU, or where no K8 ran.

Read as ``kernel.swiglu_roofline`` (moves ``frames_per_s``).
"""

PATTERNS = ("swiglu_bf16",)


def hidden(config: dict) -> int:
    """The fused SwiGLU's hidden size H: 2/3 of the MLP's, rounded up to a
    multiple of 8 (DINOv2's ``SwiGLUFFNFused``; vitg: 4096)."""
    return (int(int(config["embed_dim"] * config["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8


def swiglu_bytes(config: dict, frames: int, ph: int, pw: int) -> float:
    """Bytes of K8's work in one encode of ``frames`` frames at a patch grid
    (ph, pw): every block up to the last tap, one launch each."""
    blocks = max(config["taps"]) + 1
    return float(frames * (ph * pw + 1) * blocks * 3 * hidden(config) * 2)


def read(ctx):
    if ctx.config.get("ffn_layer", "mlp") != "swiglufused":
        return None
    prof = ctx.profile
    frames = prof.calls.get("encode_frames", []) if prof is not None else []
    t = prof.kernel_s(PATTERNS) if frames else 0.0
    if t <= 0:
        return None
    bound = sum(ctx.counts.bound_s(0.0, swiglu_bytes(ctx.config, n, ctx.ph, ctx.pw))
                for n in frames)
    return 100.0 * bound / t
