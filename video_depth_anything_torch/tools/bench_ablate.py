"""Stage costs of the window forward on the card, by in-model ablation.

    python -m video_depth_anything_torch.tools.bench_ablate [vits|vitl|vitg] [--head|--temporal|--encoder]

The port of the JAX package's ``tools/bench_ablate.py``. It times the full
bf16 window forward (1x32x518x518, seeded random weights, vitl unless
another encoder is named) and the same forward with one stage stubbed, and
reads the stage's cost as the difference:

  default     the temporal modules; the RefineNet residual conv units; the
              output head; the scratch convs (``Scratch.rn``); the DPT-side
              bilinear resizes (fusion blocks and the output head), stubbed
              by a repeat-and-slice that writes the same output bytes, so
              that the delta is the interpolation's arithmetic;
  --head      the output head's stages: output_conv1, the resize to the
              input size, conv2a (3x3 to 32) and conv2b (1x1 to 1);
  --temporal  the attention blocks; the attention itself (K2); K2 against
              its plain version at every motion module (the JAX tool's
              "flat -> pallas kernel" row taken from the other side: K2 is
              the port's default); the GEGLU feed-forward; GroupNorm;
  --encoder   the attention itself (K1); K1 against its plain version (the
              JAX tool's ``use_pallas=False``); the MLP (vitg: SwiGLU); every
              LayerNorm (the motion modules' too, as in the JAX tool); the
              whole ViT stack (the tokens embedded once and, after the final
              norm, reused for every tap); then what is left of the blocks:
              the qkv / proj GEMMs, LayerScale and the residual adds.

A stub swaps a method of the port's modules (or a function one of them
calls) inside ``patched``, which restores it in a ``finally``. Each keeps
its site's shape, dtype and device and writes its output out as the site
does (the order of the dims in memory may differ). PyTorch runs eagerly and
removes no dead code, so a stub needs none of the JAX tool's ``1e-12``
data dependencies.

Each variant is timed as the best of ITERS chains of CHAIN forwards
between CUDA events (``timing.best_ms``), in ms per window. After each
variant the model's forward is run again and held against the unablated
output bit for bit. ``stage_deltas`` is the measurement, for chip_smoke.py
too. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import contextlib
import sys

import torch
import torch.nn.functional as F

from ..kernels.spatial_attention import spatial_attention_plain
from ..kernels.temporal_attention import temporal_attention_plain
from ..models import dinov2, dpt, motion
from ..ops import nn as vnn
from .timing import best_ms, card_line

T = 32
SIZE = 518
CHAIN = 3
ITERS = 5
MODES = ("default", "head", "temporal", "encoder")
ENCODERS = ("vits", "vitl", "vitg")
# The kernels a run of each mode launches (its full forward's K1 and K2).
KERNELS_TIMED = ("spatial_attention", "temporal_attention")


@contextlib.contextmanager
def patched(patches):
    """Set each (owner, attribute, value) for the block; restore them all in
    a ``finally``, in reverse order."""
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def seeded_model(encoder: str = "vitl", seed: int = 0, device: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
    """The model in ``dtype`` on ``device``, seeded random weights."""
    from ..config import get_model_config
    from ..models import build_model

    return build_model(get_model_config(encoder), seed=seed, device=device).to(dtype)


def window(encoder: str = "vitl", frames: int = T, size: int = SIZE, seed: int = 0,
           device: str = "cuda", dtype: torch.dtype = torch.bfloat16):
    """(config, ``seeded_model``, a seeded N(0, 1) window [1, frames, size,
    size, 3] in ``dtype``), on ``device``: the stage tools' setting."""
    model = seeded_model(encoder, seed, device, dtype)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(1, frames, size, size, 3, device=device, generator=gen).to(dtype)
    return cfg, model, x


# ---------------------------------------------------------------- the stubs


def _keep(self, x, *args, **kwargs):
    """A module that returns its input (contiguous, as the module writes
    its output): the stage stubbed out."""
    return x.contiguous()


def repeat_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-style upsample of x[..., H, W, C] by repeat and slice: the
    bilinear resize's output bytes without its arithmetic."""
    h, w = x.shape[-3], x.shape[-2]
    ho, wo = out_hw
    if (h, w) == (ho, wo):
        return x
    rh, rw = -(-ho // h), -(-wo // w)
    y = x.repeat_interleave(rh, dim=-3).repeat_interleave(rw, dim=-2)
    return y[..., :ho, :wo, :].contiguous()


def _mean_head(self, path_1, out_hw, train=False):
    """The output head replaced by the mean of its input, broadcast to
    [N, H, W, 1] fp32 and written out."""
    m = path_1.float().mean()
    return m.expand(path_1.shape[0], *out_hw, 1).contiguous()


def _channels_rn(self, feats):
    """The scratch convs replaced by a slice (or zero padding) of each
    map's channels to ``features``."""
    f = self.layer1_rn.weight.shape[0]
    return [y[..., :f].contiguous() if y.shape[-1] >= f else F.pad(y, (0, f - y.shape[-1]))
            for y in feats]


def _conv1_slice(self, x):
    """output_conv1 replaced by a slice of its input's channels."""
    return x[..., :self.output_conv1.weight.shape[0]].contiguous()


def _resize_repeat(self, x, out_hw):
    """The head's resize replaced by ``repeat_resize``."""
    return repeat_resize(x, out_hw)


def _conv2a_slice(self, x, island):
    """output_conv2's 3x3 replaced by a slice of its input's channels and
    the ReLU, in the dtype the site returns."""
    y = x[..., :self.output_conv2[0].weight.shape[0]].contiguous()
    return vnn.relu(y.float() if island else y)


def _conv2b_slice(self, x, island):
    """output_conv2's 1x1 replaced by the first channel and the ReLU, fp32."""
    return vnn.relu(x[..., :1].float().contiguous())


# --head: each stage of ``Scratch.output_head`` and its stub. On a card's bf16
# path everything after head_conv1 is kernel K7 (``Scratch.fused_tail``), so
# there only conv1's stub takes effect; the others ablate the fp32 island.
HEAD_STUBS = (("conv1", "head_conv1", _conv1_slice), ("resize", "head_resize", _resize_repeat),
              ("conv2a", "head_conv2a", _conv2a_slice), ("conv2b", "head_conv2b", _conv2b_slice))


def _attention_out(q, k, v, **kwargs):
    """An attention call replaced by its v, written out as the kernels
    write their output (contiguous)."""
    return v.contiguous()


def _embedded_taps(self, x, taps):
    """No ViT block: the tokens embedded once and, after the final norm,
    returned for every tap (patch embed and the pos-embed interpolation
    keep their cost)."""
    y = self.embed_tokens(x)
    y = vnn.layer_norm(y, self.norm.weight, self.norm.bias, 1e-6)
    return [(y[:, 1:, :], y[:, 0, :]) for _ in taps]


def variants(mode: str, cfg) -> list[tuple[str, str, int, list]]:
    """(label, delta key, sign, patches) of each variant of ``mode``. The
    delta is sign * (full - variant): a stub's saving (sign 1), or what a
    kernel saves against its plain version (sign -1)."""
    if mode == "default":
        return [("- temporal modules", "temporal modules", 1,
                 [(motion.TemporalModule, "forward", _keep)]),
                ("- refinenet RCUs", "refinenet RCUs", 1,
                 [(dpt.ResidualConvUnit, "forward", _keep)]),
                ("- output head", "output head", 1, [(dpt.Scratch, "output_head", _mean_head)]),
                ("- scratch_rn", "scratch_rn", 1, [(dpt.Scratch, "rn", _channels_rn)]),
                ("- dpt resizes", "dpt resize interp", 1,
                 [(dpt, "resize_bilinear_align_corners", repeat_resize)])]
    if mode == "head":
        return [(f"- head {skip}", skip, 1, [(dpt.Scratch, method, stub)])
                for skip, method, stub in HEAD_STUBS]
    if mode == "temporal":
        return [("- tm attention", "attention (all)", 1,
                 [(motion.TemporalAttention, "forward", _keep)]),
                ("- tm attn math", "attn math only", 1,
                 [(motion, "temporal_attention", _attention_out)]),
                ("- tm K2=plain", "K2 -> plain", -1,
                 [(motion, "temporal_attention", temporal_attention_plain)]),
                ("- tm ff", "geglu ff", 1, [(motion.FeedForward, "forward", _keep)]),
                ("- tm group_norm", "group_norm", 1, [(vnn, "group_norm", _keep_fn)])]
    if mode == "encoder":
        ffn = "swiglu (w12+silu+w3)" if cfg.vit.ffn_layer == "swiglufused" else "mlp (fc1+gelu+fc2)"
        return [("- attn kernel", "attention math", 1,
                 [(dinov2, "spatial_attention", _attention_out)]),
                ("- attn=plain", "K1 -> plain attn", -1,
                 [(dinov2, "spatial_attention", spatial_attention_plain)]),
                ("- mlp", ffn, 1, [(dinov2.Mlp, "forward", _keep),
                                   (dinov2.SwiGLUFFNFused, "forward", _keep)]),
                ("- layer_norm", "layer_norms (all)", 1, [(vnn, "layer_norm", _keep_fn)]),
                ("- whole ViT stack", "all ViT blocks", 1,
                 [(dinov2.DinoVisionTransformer, "get_intermediate_layers", _embedded_taps)])]
    raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def _keep_fn(x, *args, **kwargs):
    """A function that returns its input (contiguous, as the function
    writes its output)."""
    return x.contiguous()


# ---------------------------------------------------------------- the measurement


@torch.no_grad()
def stage_deltas(model, x: torch.Tensor, mode: str = "default", iters: int = ITERS,
                 chain: int = CHAIN) -> dict:
    """Time the full forward of ``model`` on ``x`` and each variant of
    ``mode``; print them and the deltas. Returns {"full_ms", "rows" (label
    -> ms), "deltas" (key -> ms), "restored" (label -> the forward after the
    variant equal to the unablated one bit for bit, and every patched
    attribute back), "forward" (the unablated output), "card"}."""
    cfg = model.cfg
    t = x.shape[1]
    ref = model(x)
    card = card_line()

    def run(label):
        ms = best_ms(lambda: model(x), chain, iters)
        print(f"  {label:<24s}: {ms:8.2f} ms/window", flush=True)
        return ms

    print(f"{cfg.encoder} {x.shape[2]}x{x.shape[3]} x{t} {mode} ablation (ms/window, "
          f"chain={chain}, best of {iters}):", flush=True)
    full = run("full forward")
    rows, deltas, restored = {"full forward": full}, {}, {}
    for label, key, sign, patches in variants(mode, cfg):
        before = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
        with patched(patches):
            rows[label] = run(label)
        deltas[key] = sign * (full - rows[label])
        restored[label] = (all(owner.__dict__[name] is v for owner, name, v in before)
                           and torch.equal(model(x), ref))
    print(f"{mode} stage deltas (ms/window):", flush=True)
    for k, v in deltas.items():
        print(f"  {k:<22s}: {v:8.2f}", flush=True)
    if mode == "encoder":
        ffn = next(k for k in deltas if k.startswith(("mlp", "swiglu")))
        deltas["residual qkv/proj GEMMs + adds"] = (
            deltas["all ViT blocks"] - deltas["attention math"] - deltas[ffn]
            - deltas["layer_norms (all)"])
        print(f"  residual qkv/proj GEMMs + adds: "
              f"{deltas['residual qkv/proj GEMMs + adds']:8.2f} ({cfg.vit.depth} blocks)",
              flush=True)
    if mode == "default":
        print(f"  per frame (full)      : {full / t:8.3f} ms", flush=True)
    return dict(card=card, full_ms=full, per_frame_ms=full / t, rows=rows, deltas=deltas,
                restored=restored, forward=ref)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    enc = next((a for a in argv if not a.startswith("-")), "vitl")
    flags = [a for a in argv if a.startswith("-")]
    mode = {"--head": "head", "--temporal": "temporal", "--encoder": "encoder"}.get(
        flags[0] if flags else "", "default")
    if enc not in ENCODERS or len(flags) > 1 or (flags and mode == "default"):
        print(f"usage: bench_ablate [{'|'.join(ENCODERS)}] [--head|--temporal|--encoder]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    _, model, x = window(enc)
    stage_deltas(model, x, mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
