"""Card microbench: the output head at the benchmark's window shapes, its
stages one by one and kernel K7 (the full-resolution tail).

    python -m video_depth_anything_torch.tools.bench_head_tail [--json PATH]

For each of ``SHAPES`` (vitl at C 1 and vits at C 4, one chunk at
518x924: output_conv1's input ``[N, 296, 528, features]`` bf16, laid out as
the pipeline hands it over, H and W swapped in memory by the resize before
it), a bf16 ``Scratch`` with the model's widths (weights N(0, 0.04^2) for
the 3x3s, the init's scale for the 1x1) times, by CUDA events
(``timing.time_ms``):

  output    ``output_head``: the whole stage as the tree runs it on a card;
  conv1     ``head_conv1`` on that map: the 3x3 at h x w;
  resize    ``head_resize``: the two einsums to H x W;
  conv2a    ``head_conv2a``: the cuDNN 3x3 to 32 and its fp32 bias, ReLU, bf16;
  conv2b    ``head_conv2b``: the fp32 1x1 and its ReLU;
  plain     K7's plain version (resize + conv2a + conv2b in one call);
  library   conv2a + conv2b on the resized map (the cuDNN conv and PyTorch's
            tail, without the resize);
  k7        the kernel, where the tree has it (an older tree prints none);

and K7's bound (its operations at the bf16 peak against x read and the
depth written once), its share of it and its max abs error against the
plain version over max |y|. Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import timing
from .timing import time_ms

# name: (frames, h, w, features) at 518x924, H, W = 14 / 8 of h, w.
SHAPES = {"vitl-c1": (32, 296, 528, 256), "vits-c4": (128, 296, 528, 64)}


def tail_flops(n, oh, ow, c) -> float:
    """The tail's products: the 3x3 C -> 32 and the 1x1 32 -> 1."""
    return 2.0 * n * oh * ow * (9 * c * 32 + 32)


@torch.no_grad()
def bench(name: str, iters: int = 5, seed: int = 0) -> dict:
    from ..models.dpt import Scratch

    n, h, w, f = SHAPES[name]
    oh, ow, c = 14 * h // 8, 14 * w // 8, f // 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sc = Scratch([f] * 4, f).to("cuda")
    for conv in (sc.output_conv1, sc.output_conv2[0]):
        conv.weight.copy_(0.04 * torch.randn(conv.weight.shape, device="cuda", generator=gen))
        conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, device="cuda", generator=gen))
    sc = sc.to(torch.bfloat16)
    c2a, c2b = sc.output_conv2[0], sc.output_conv2[2]
    ops = (c2a.weight, c2a.bias, c2b.weight, c2b.bias)
    path_1 = torch.randn(n, w, h, f, device="cuda", generator=gen).to(torch.bfloat16)
    path_1 = path_1.transpose(1, 2)   # the resize's layout: [N][W][H][C] in memory
    x = sc.head_conv1(path_1.contiguous()).contiguous()
    up = sc.head_resize(x, (oh, ow))
    mid = sc.head_conv2a(up, False)
    row = dict(shape=name, frames=n, map=[h, w, c], out=[oh, ow],
               output_ms=time_ms(lambda: sc.output_head(path_1, (oh, ow)), iters),
               conv1_ms=time_ms(lambda: sc.head_conv1(path_1), iters),
               resize_ms=time_ms(lambda: sc.head_resize(x, (oh, ow)), iters),
               conv2a_ms=time_ms(lambda: sc.head_conv2a(up, False), iters),
               conv2b_ms=time_ms(lambda: sc.head_conv2b(mid, False), iters))
    del mid
    row["library_ms"] = time_ms(lambda: sc.head_conv2b(sc.head_conv2a(up, False), False), iters)
    del up
    try:
        from ..kernels import head_output_tail as k7
    except ImportError:
        k7 = None
    if k7 is not None:
        plain = k7.head_output_tail_plain(x, *ops, (oh, ow))
        row["plain_ms"] = time_ms(lambda: k7.head_output_tail_plain(x, *ops, (oh, ow)), iters)
        got = k7.head_output_tail(x, *ops, (oh, ow))
        top = plain.abs().max().item()
        row["err_over_max"] = (got - plain).abs().max().item() / top
        del got, plain
        row["k7_ms"] = time_ms(lambda: k7.head_output_tail(x, *ops, (oh, ow)), iters)
        bms, by = timing.bound_ms(tail_flops(n, oh, ow, c), x.numel() * 2 + n * oh * ow * 4)
        row.update(bound_ms=bms, bound_by=by, k7_roofline_pct=100 * bms / row["k7_ms"])
    print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in row.items()), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="append one JSON line per shape here")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_head_tail: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(timing.card_line(), flush=True)
    for name in SHAPES:
        row = dict(bench(name), label=args.label, card=timing.card_line())
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(row) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
