"""Card tool: the readings behind chip_smoke's vitg drift limits.

    python -m video_depth_anything_torch.tools.drift_limits --encoder vitg \\
        --seeds 0 1 2 3 --plant 0 10 20 30 39 --factor 0.5

For each seed s (model weights drawn from seed s, the synthetic video from
seed 10 + s), runs chip_smoke (k)'s pipeline call, 44 frames at 518x518
(two windows, keyframe cache), in fp32, bf16 and int8, and prints the bf16
and int8 drifts from the fp32 depths (utils/precision.py's report: max and
mean error as fractions of the fp32 depth range after affine alignment),
and each encoder block's int8 error on its own (``block_rel_l2``: the
block's residual branch in int8 against bf16 on the bf16 stream's input,
first window). For the first seed it then plants two faults in the int8
side file, one run each, for each block named by ``--plant`` (by default
the first, the last and the quarters of the encoder's depth: 0 10 20 30 39
for vitg, 0 6 12 18 23 for vitl): the block's
``fc1`` and ``fc2`` absmaxes swapped (the ``w12`` and ``w3`` inputs on
vitg), and its ``fc2`` absmax scaled by ``--factor``. The last line is one
JSON record. TF32 is off, as in chip_smoke, so fp32 is true fp32. Needs a
CUDA card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch


def swap_slots(src: str, dst: str, block: int, a: str = "fc1", b: str = "fc2") -> None:
    """Copy an int8 side file with block ``block``'s encoder slots ``a`` and
    ``b`` swapped (the geometry stamp kept)."""
    with np.load(src) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    ka, kb = f"encoder/{a}", f"encoder/{b}"
    arrays[ka][block], arrays[kb][block] = arrays[kb][block].copy(), arrays[ka][block].copy()
    np.savez(dst, **arrays)


def scale_slot(src: str, dst: str, block: int, factor: float, site: str = "fc2") -> None:
    """Copy an int8 side file with block ``block``'s encoder slot ``site``
    multiplied by ``factor``."""
    with np.load(src) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    arrays[f"encoder/{site}"][block] *= np.float32(factor)
    np.savez(dst, **arrays)


def default_plant(depth: int) -> list[int]:
    """The blocks planted by default: 0, the quarters and the last."""
    return sorted({0, depth // 4, depth // 2, 3 * depth // 4, depth - 1})


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@torch.no_grad()
def block_rel_l2(float_model, int8_model, frames: np.ndarray, net_hw) -> list[float]:
    """Each encoder block's int8 error on its own: the relative L2 of the
    block's residual branch (output minus input) in ``int8_model`` against
    ``float_model``, both given the float model's input to that block.
    ``frames``: uint8 [N, H, W, 3] on the host, preprocessed to ``net_hw``
    in the float model's dtype."""
    from ..pipeline import preprocess

    p = next(float_model.parameters())
    x = preprocess.preprocess_frames(torch.from_numpy(np.ascontiguousarray(frames)).to(p.device),
                                     net_hw, p.dtype)
    enc_f, enc_q = float_model.pretrained, int8_model.pretrained
    t = enc_f.embed_tokens(x)
    errs = []
    for bf, bq in zip(enc_f.blocks, enc_q.blocks):
        ref = bf(t)
        errs.append(rel_l2(bq(t).float() - t.float(), ref.float() - t.float()))
        t = ref
    return errs


def _drift(d, ref) -> dict:
    from ..utils.precision import precision_drift_report

    r = precision_drift_report(d, ref)
    return {"max_err_frac": r["max_err_frac"], "mean_err_frac": r["mean_err_frac"]}


@torch.no_grad()
def readings(encoder: str, seeds: list[int], plant: list[int], factor: float) -> dict:
    from ..config import INFER_LEN, get_model_config
    from ..models import build_model
    from ..pipeline import VideoDepthPipeline, preprocess
    from ..utils.precision import synthetic_video

    cfg = get_model_config(encoder)
    net_hw = preprocess.network_input_hw(518, 518, preprocess.effective_input_size(518, 518, 518))
    rec = {"encoder": encoder, "card": torch.cuda.get_device_name(0), "factor": factor,
           "seeds": [], "planted": []}

    def int8_run(model, frames, side, pipe):
        q = VideoDepthPipeline(cfg, model, quant="int8", calib_path=side)
        d8, _ = q.infer_video_depth(frames)
        blocks = block_rel_l2(pipe.model_in(torch.bfloat16),
                              q.quantized_model(frames[:INFER_LEN], net_hw, torch.bfloat16),
                              frames[:INFER_LEN], net_hw)
        return d8, blocks

    tmp = tempfile.mkdtemp(prefix="vda_drift_limits_")
    try:
        for i, s in enumerate(seeds):
            model = build_model(cfg, seed=s, device="cuda")
            frames = synthetic_video(n=44, hw=(518, 518), seed=10 + s)
            pipe = VideoDepthPipeline(cfg, model)
            d16, _ = pipe.infer_video_depth(frames)
            d32, _ = pipe.infer_video_depth(frames, fp32=True)
            side = os.path.join(tmp, f"seed{s}.int8calib.npz")
            d8, blocks = int8_run(model, frames, side, pipe)
            row = {"seed": s, "bf16": _drift(d16, d32), "int8": _drift(d8, d32),
                   "block_rel_l2": blocks}
            rec["seeds"].append(row)
            print(f"{encoder} seed {s}: bf16 max {row['bf16']['max_err_frac']:.5f} / mean "
                  f"{row['bf16']['mean_err_frac']:.6f}; int8 max "
                  f"{row['int8']['max_err_frac']:.5f} / mean "
                  f"{row['int8']['mean_err_frac']:.6f}; int8 block relative L2 "
                  f"{min(blocks):.4f}-{max(blocks):.4f}", flush=True)
            for k in plant if i == 0 else ():
                for fault, plant_fn in (("fc1/fc2 absmax swapped", lambda a, b: swap_slots(a, b, k)),
                                        (f"fc2 absmax x {factor}",
                                         lambda a, b: scale_slot(a, b, k, factor))):
                    bad = os.path.join(tmp, f"seed{s}.block{k}.int8calib.npz")
                    plant_fn(side, bad)
                    dk, bk = int8_run(model, frames, bad, pipe)
                    r = {"seed": s, "block": k, "fault": fault, "int8": _drift(dk, d32),
                         "block_rel_l2": bk[k], "others_max": max(bk[:k] + bk[k + 1:])}
                    rec["planted"].append(r)
                    print(f"{encoder} seed {s}, block {k}, {fault}: int8 max "
                          f"{r['int8']['max_err_frac']:.5f} / mean "
                          f"{r['int8']['mean_err_frac']:.6f}; the block's relative L2 "
                          f"{bk[k]:.4f} (others at most {r['others_max']:.4f})", flush=True)
            del pipe, model
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--encoder", default="vitg", choices=["vits", "vitb", "vitl", "vitg"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--plant", type=int, nargs="*", default=None,
                    help="blocks given a planted fault, one run per block and fault "
                         "(default: default_plant(the encoder's depth))")
    ap.add_argument("--factor", type=float, default=0.5,
                    help="the planted scale of a block's fc2 absmax")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("drift_limits: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ..kernels import build
    build.build_all()
    plant = args.plant
    if plant is None:
        from ..config import get_model_config
        plant = default_plant(get_model_config(args.encoder).vit.depth)
    print(json.dumps(readings(args.encoder, args.seeds, plant, args.factor)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
