"""Validate a checkpoint the moment it lands in ./checkpoints/ (the port
of the JAX package's ``tools/validate_checkpoint.py``): one command runs
the chain and reports pass / fail.

  torch .pth -> converter (``convert.params_from_state_dict``) -> .npz round trip
            -> the parameter tree loaded strict into the port's model
            -> VideoDepthPipeline forward on a synthetic video (or --video)
            -> finite / non-negative output checks
            -> bf16-vs-fp32 drift against ``utils/precision.py``'s budget
               (max 5 % / mean 0.2 % of the depth range)
            -> optional: benchmark evaluation with --benchmark_json

    python -m video_depth_anything_torch.tools.validate_checkpoint   # scan ./checkpoints
    python -m video_depth_anything_torch.tools.validate_checkpoint \\
        checkpoints/video_depth_anything_vitl.pth [--encoder vitl] [--video in.mp4] \\
        [--benchmark_json ROOT --infer_path OUT] [--device cpu]

The pipeline runs on ``--device`` (default ``cuda``; ``cpu`` the plain
PyTorch path). One JSON report per checkpoint, with the JAX tool's keys;
exit code 0 only when every check of every checkpoint passed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .convert_checkpoint import infer_encoder


def validate_one(path, encoder=None, video=None, input_size=None, benchmark_json=None,
                 infer_path=None, device="cuda") -> dict:
    import numpy as np

    from ..config import MODEL_CONFIGS, get_model_config
    from ..convert import state_dict_from_params
    from ..models import build_model
    from ..pipeline import VideoDepthPipeline
    from ..utils import params_io
    from ..utils.precision import (MAX_ERR_FRAC, MEAN_ERR_FRAC, precision_drift_report,
                                   synthetic_video)
    from ..utils.tree import flatten_tree

    report = {"checkpoint": path, "checks": {}, "ok": False}
    encoder = encoder or infer_encoder(path)
    if encoder is None:
        report["error"] = "cannot infer encoder from filename; pass --encoder"
        return report
    metric = "metric" in os.path.basename(path)
    try:
        cfg = get_model_config(encoder, metric=metric)
    except KeyError:
        report["error"] = (f"no model config for encoder '{encoder}' "
                           f"(supported: {', '.join(MODEL_CONFIGS)}); pass --encoder")
        return report
    report["encoder"], report["metric"] = encoder, metric

    # 1. load: .pth through the converter, then strict into the port's model
    try:
        params = params_io.load_checkpoint(path, cfg)
        model = build_model(cfg)
        model.load_state_dict(state_dict_from_params(params, cfg.vit.depth), strict=True)
        report["checks"]["load"] = "ok"
    except Exception as e:  # noqa: BLE001 (reported; the scan goes on)
        report["checks"]["load"] = f"FAIL: {type(e).__name__}: {e}"
        return report

    # 2. the converted .npz round trip (only when starting from .pth)
    if path.endswith(".pth"):
        try:
            npz = os.path.splitext(path)[0] + ".npz"
            params_io.save_params(npz, params)
            back = flatten_tree(params_io.load_params(npz))
            flat = flatten_tree(params)
            if sorted(flat) != sorted(back) or not all(
                    np.array_equal(v, back[k]) for k, v in flat.items()):
                raise ValueError("the .npz does not hold the converted tree")
            report["checks"]["npz_roundtrip"] = "ok"
        except Exception as e:  # noqa: BLE001
            report["checks"]["npz_roundtrip"] = f"FAIL: {e}"
            return report

    # 3. the pipeline on real or synthetic frames
    if video is not None:
        from ..utils.video_io import read_video_frames
        frames, _ = read_video_frames(video, process_length=64, target_fps=-1, max_res=640)
        size = input_size or 518
    else:
        frames = synthetic_video()
        size = input_size or 140   # small, but several windows
    pipe = VideoDepthPipeline(cfg, model, device=device)
    d32, _ = pipe.infer_video_depth(frames, input_size=size, fp32=True)
    d16, _ = pipe.infer_video_depth(frames, input_size=size, fp32=False)
    finite = bool(np.isfinite(d32).all() and np.isfinite(d16).all())
    nonneg = bool((d32 >= 0).all())
    report["checks"]["finite"] = "ok" if finite else "FAIL: non-finite depths"
    report["checks"]["nonnegative"] = "ok" if nonneg else "FAIL: negative depths"

    # 4. the bf16 budget
    drift = precision_drift_report(d16, d32)
    report["bf16_drift"] = drift
    within = drift["max_err_frac"] < MAX_ERR_FRAC and drift["mean_err_frac"] < MEAN_ERR_FRAC
    report["checks"]["bf16_budget"] = "ok" if within else (
        f"FAIL: {drift} exceeds max {MAX_ERR_FRAC}/mean {MEAN_ERR_FRAC}")

    # 5. optional benchmark evaluation of predictions already written
    if benchmark_json:
        from ..benchmark import evaluate as bev
        report["benchmark"] = {}
        for ds in ("sintel", "scannet", "kitti", "bonn"):
            try:
                dcfg = bev.dataset_eval_config(ds, benchmark_json)
                report["benchmark"][ds] = bev.eval_dataset(infer_path, dcfg)
            except (FileNotFoundError, ValueError):
                continue

    report["ok"] = all(v == "ok" for v in report["checks"].values())
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help=".pth/.npz; default: scan ./checkpoints/")
    parser.add_argument("--encoder", default=None)
    parser.add_argument("--video", default=None,
                        help="real video to validate on (default: synthetic)")
    parser.add_argument("--input_size", type=int, default=None)
    parser.add_argument("--benchmark_json", default=None,
                        help="benchmark root (manifest dir) for a full eval run")
    parser.add_argument("--infer_path", default=None,
                        help="predictions dir for --benchmark_json")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)

    if args.checkpoint:
        paths = [args.checkpoint]
    else:
        paths = sorted(glob.glob("checkpoints/*.pth")) or sorted(glob.glob("checkpoints/*.npz"))
        if not paths:
            sys.exit("no checkpoints found under ./checkpoints/ — run "
                     "tools/get_weights.sh on a networked machine and copy "
                     "the .pth files here")
    ok = True
    for p in paths:
        rep = validate_one(p, args.encoder, args.video, args.input_size,
                           args.benchmark_json, args.infer_path, args.device)
        print(json.dumps(rep, indent=2))
        ok &= rep["ok"]
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
