"""In-model A/B of the temporal attention on the card: K2 against its plain
version, in the full window forward.

    python -m video_depth_anything_torch.tools.bench_temporal_swap [vits|vitl|vitg]

The port of the JAX package's ``tools/bench_temporal_swap.py``, which
timed the full vitl window forward with the head-grouped dh-32 motion
modules routed to its Pallas kernel or to XLA einsums, in one process
(only a same-process A/B is valid). Here three routings of the bf16
window forward (1x32x518x518, seeded random weights), in one process:

  kernel  K2 at every motion module (the port's default);
  plain   K2's plain version at every motion module;
  routed  K2 only at the modules the JAX tool routed to its kernel: C 256
          at dh 32 (vitl's motion modules 2 and 3; none of vits' or
          vitg's), the plain version elsewhere.

The port has no head grouping (the JAX model grouped g heads to g x dh =
128 for the TPU's lanes), so the sites are named by module, not by the
grouped shape. Each is the best of ITERS chains of CHAIN forwards between
CUDA events (``timing.best_ms``), in ms per window. ``swap`` is the
measurement, for chip_smoke.py too. Needs a CUDA card and exits 2 without
one.
"""
from __future__ import annotations

import contextlib
import sys

import torch

from ..kernels.temporal_attention import temporal_attention_plain
from ..models import motion
from .bench_ablate import ENCODERS, patched, window
from .timing import best_ms, card_line

T = 32
SIZE = 518
CHAIN = 3
ITERS = 5
SITE_C, SITE_DH = 256, 32   # the modules the JAX tool routed to its kernel
KERNELS_TIMED = ("temporal_attention",)


def kernel_sites(model) -> list[int]:
    """The motion modules at C 256 and dh 32."""
    sites = []
    for i, m in enumerate(model.head.motion_modules):
        attn = m.temporal_transformer.transformer_blocks[0].attention_blocks[0]
        c = attn.to_q.in_features
        if c == SITE_C and c // attn.num_heads == SITE_DH:
            sites.append(i)
    return sites


def plain_k2():
    """Every motion module on K2's plain version, for the block."""
    return patched([(motion, "temporal_attention", temporal_attention_plain)])


@contextlib.contextmanager
def k2_only_at(model, sites):
    """K2 at the motion modules ``sites``, its plain version at the others:
    each other module's forward runs under ``plain_k2``. The instance
    attributes are removed in a ``finally``."""
    def routed(module):
        forward = module.forward

        def run(*args, **kwargs):
            with plain_k2():
                return forward(*args, **kwargs)
        return run

    others = [m for i, m in enumerate(model.head.motion_modules) if i not in sites]
    try:
        for m in others:
            m.forward = routed(m)
        yield
    finally:
        for m in others:
            m.__dict__.pop("forward", None)


@torch.no_grad()
def swap(model, x: torch.Tensor, iters: int = ITERS, chain: int = CHAIN) -> dict:
    """Time the three routings; print them. Returns ms per window of each,
    the routed sites, whether the forward equals the unablated one bit
    for bit after them, and the card."""
    t = x.shape[1]
    enc = model.cfg.encoder
    sites = kernel_sites(model)
    ref = model(x)

    def run():
        return best_ms(lambda: model(x), chain, iters)

    t_kernel = run()
    print(f"{enc} K2 everywhere (base)  : {t_kernel:8.2f} ms/window ({t_kernel / t:.3f} "
          f"ms/frame)", flush=True)
    with plain_k2():
        t_plain = run()
    print(f"{enc} plain everywhere      : {t_plain:8.2f} ms/window ({t_plain / t:.3f} "
          f"ms/frame)", flush=True)
    with k2_only_at(model, sites):
        t_routed = run()
    print(f"{enc} K2 at modules {sites} : {t_routed:8.2f} ms/window ({t_routed / t:.3f} "
          f"ms/frame)", flush=True)
    print(f"delta plain - K2: {t_plain - t_kernel:+.2f} ms/window; routed - K2: "
          f"{t_routed - t_kernel:+.2f} ms/window", flush=True)
    return dict(card=card_line(), kernel_ms=t_kernel, plain_ms=t_plain, routed_ms=t_routed,
                sites=sites, restored=torch.equal(model(x), ref))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    enc = argv[0] if argv else "vitl"
    if enc not in ENCODERS:
        print(f"usage: bench_temporal_swap [{'|'.join(ENCODERS)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_temporal_swap: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    _, model, x = window(enc, T, SIZE)
    swap(model, x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
