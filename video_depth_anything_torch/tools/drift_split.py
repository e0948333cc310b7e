"""Card tool: where one window's bf16 drift from fp32 comes from.

    python -m video_depth_anything_torch.tools.drift_split --encoder vitg

For one 32-frame 518x518 window of the synthetic video (seeded random
weights), prints the bf16 drift from the fp32 window (utils/precision.py's
report: max and mean error as fractions of the fp32 depth range after
affine alignment) three ways: all in bf16, the encoder alone in bf16 (its
taps cast to fp32 for the fp32 head), and the head alone in bf16 (the
fp32 taps cast to bf16); and each tap's relative L2 (patch tokens, cls).
The last line is one JSON record. TF32 is off, so fp32 is true fp32.
Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys

import torch


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@torch.no_grad()
def split(encoder: str, seed: int = 10) -> dict:
    from ..config import INFER_LEN, get_model_config
    from ..models import build_model
    from ..ops.resize import resize_bilinear_align_corners
    from ..pipeline import preprocess
    from ..utils.precision import precision_drift_report, synthetic_video

    cfg = get_model_config(encoder)
    m32 = build_model(cfg, seed=0, device="cuda")
    m16 = copy.deepcopy(m32).to(torch.bfloat16)
    up = torch.from_numpy(synthetic_video(n=INFER_LEN, hw=(518, 518), seed=seed)).cuda()
    g = 518 // cfg.vit.patch_size
    f32 = m32.encode(preprocess.preprocess_frames(up, (518, 518), torch.float32))
    f16 = m16.encode(preprocess.preprocess_frames(up, (518, 518), torch.bfloat16))

    def depth(model, feats, dtype):
        d = model.head([(p.to(dtype), c.to(dtype)) for p, c in feats], g, g, 1, INFER_LEN)
        d = resize_bilinear_align_corners(d.float(), (518, 518))
        return torch.relu(d)[..., 0].cpu().numpy()

    ref = depth(m32, f32, torch.float32)
    rec = {"encoder": encoder, "card": torch.cuda.get_device_name(0)}
    for name, d in (("all_bf16", depth(m16, f16, torch.bfloat16)),
                    ("encoder_bf16", depth(m32, f16, torch.float32)),
                    ("head_bf16", depth(m16, f32, torch.bfloat16))):
        r = precision_drift_report(d, ref)
        rec[name] = {"max_err_frac": r["max_err_frac"], "mean_err_frac": r["mean_err_frac"]}
    rec["depth_range"] = float(ref.max() - ref.min())
    rec["tap_rel_l2"] = [[rel_l2(a, b), rel_l2(ac, bc)] for (a, ac), (b, bc) in zip(f16, f32)]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--encoder", default="vitg", choices=["vits", "vitb", "vitl", "vitg"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("drift_split: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ..kernels import build
    build.build_all()
    rec = split(args.encoder)
    for k in ("all_bf16", "encoder_bf16", "head_bf16"):
        print(f"{args.encoder} {k}: max {rec[k]['max_err_frac']:.5f} / mean "
              f"{rec[k]['mean_err_frac']:.6f} of the range {rec['depth_range']:.4f}", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
