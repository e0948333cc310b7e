"""Device memory of one window forward on the card (the VRAM parity row).

    python -m video_depth_anything_torch.tools.bench_memory [--encoders vits vitl] [--size 518]
        [--fp32_only | --bf16_only]

The port of the JAX package's ``tools/bench_memory.py``. The reference
publishes GPU VRAM for the 1x32x518x518 window (its README: vits 7.3 / 6.8
GB, vitl 26.7 / 23.6 GB in fp32 / fp16 on an A100). The JAX tool reads
XLA's allocation plan ahead of time; eager PyTorch has no plan, so this
tool materialises the model (seeded random weights, in the dtype) and a
uint8 window on the card and runs preprocess plus the forward once under
``torch.inference_mode``, reading the caching allocator's statistics:

  weights + frames  the bytes of the parameters, buffers and the window
                    (the allocator's requested bytes, which it counts
                    before rounding each block up);
  output            the depth's bytes;
  temporaries       the requested bytes' peak during the call, after
                    ``reset_peak_memory_stats``, less the two above.

The total is their sum; ``allocated_peak_bytes`` is the allocator's own
peak (``max_memory_allocated``, blocks rounded up) over the same
baseline, the memory the call holds on the card. XLA's generated code has no counterpart
in the allocator (the kernels' code is loaded outside it): ``code_gib`` is
None. One JSON line per (encoder, dtype), under the JAX tool's metric
names. ``measure`` is the measurement and ``argument_bytes`` its
accounting of weights and frames, for chip_smoke.py and the tests too.
Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..config import INFER_LEN
from .timing import card_line

# The reference's A100 VRAM (GB) at 1x32x518x518: its README's rows for
# vits and vitl in fp32 / fp16. bf16 is set beside the fp16 row (the same width).
REF_VRAM_GB = {("vits", "float32"): 7.3, ("vits", "bfloat16"): 6.8,
               ("vitl", "float32"): 26.7, ("vitl", "bfloat16"): 23.6}
KERNELS_TIMED = ("spatial_attention", "temporal_attention")
GIB = 1024.0 ** 3


def argument_bytes(model, win: torch.Tensor) -> dict:
    """{name: bytes} of every parameter and buffer of ``model`` and of the
    window ("window"): what the JAX tool counts as the program's arguments."""
    out = {name: t.numel() * t.element_size()
           for name, t in (*model.named_parameters(), *model.named_buffers())}
    out["window"] = win.numel() * win.element_size()
    return out


def forward_fn(model, size: int, dtype: torch.dtype):
    """The measured call: preprocess of a uint8 window to size^2 in
    ``dtype``, then the window forward."""
    from ..pipeline import preprocess

    def fn(win):
        return model(preprocess.preprocess_frames(win, (size, size), dtype))
    return fn


def _requested() -> int:
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def measure(encoder: str, size: int, fp32: bool) -> dict:
    """One record for (encoder, size, dtype) on the card; the model, the
    window and the output are freed before it returns."""
    from ..config import get_model_config
    from ..models import build_model

    dtype = torch.float32 if fp32 else torch.bfloat16
    name = str(dtype).split(".")[1]
    torch.cuda.synchronize()
    base, base_alloc = _requested(), torch.cuda.memory_allocated()
    model = build_model(get_model_config(encoder), seed=0, device="cuda").to(dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    win = torch.randint(0, 256, (1, INFER_LEN, size, size, 3), device="cuda",
                        generator=gen, dtype=torch.uint8)
    torch.cuda.synchronize()
    args = _requested() - base
    accounted = argument_bytes(model, win)
    fn = forward_fn(model, size, dtype)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = fn(win)
        torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    peak = stats["requested_bytes.all.peak"] - base
    alloc_peak = torch.cuda.max_memory_allocated() - base_alloc
    out_bytes = out.numel() * out.element_size()
    finite = bool(torch.isfinite(out).all())
    del model, win, out, fn
    torch.cuda.empty_cache()
    total = peak / GIB
    ref = REF_VRAM_GB.get((encoder, name)) if size == 518 else None
    return {"metric": f"{encoder}_hbm_gib_{size}", "dtype": name,
            "value": round(total, 3), "unit": "GiB",
            "weights_plus_frames_gib": round(args / GIB, 3),
            "temps_gib": round((peak - args - out_bytes) / GIB, 3),
            "output_gib": round(out_bytes / GIB, 6), "code_gib": None,
            "ref_a100_vram_gb": ref,
            "vs_ref": round(ref / total, 2) if ref else None,
            "weights_plus_frames_bytes": args,
            "accounted_bytes": sum(accounted.values()),
            "output_bytes": out_bytes, "peak_bytes": peak, "allocated_peak_bytes": alloc_peak,
            "card_bytes": torch.cuda.get_device_properties(0).total_memory,
            "output_finite": finite, "card": card_line()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoders", nargs="+", default=["vits", "vitl"])
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--fp32_only", action="store_true")
    ap.add_argument("--bf16_only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_memory: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 as run.py runs it (the
    torch.backends.cudnn.allow_tf32 = False         # algorithms' workspaces differ)
    for enc in args.encoders:
        for fp32 in ((True,) if args.fp32_only else
                     (False,) if args.bf16_only else (False, True)):
            print(json.dumps(measure(enc, args.size, fp32)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
