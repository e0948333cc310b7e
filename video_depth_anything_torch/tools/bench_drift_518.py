"""bf16 and int8 against fp32, end to end at the serving shape, on the card.

    python -m video_depth_anything_torch.tools.bench_drift_518 [--encoder vitl] [--frames 50]
        [--src_hw 644 644] [--input_size 518] [--seed 3] [--numpy_weights S]

The port of the JAX package's ``tools/bench_drift_518.py``. The precision
budgets of ``utils/precision.py`` are held in the tests at toy
resolution; this tool measures the same drift report at input size 518,
the reference CLI's default. Three ``VideoDepthPipeline`` runs over
``utils/precision.py::synthetic_video(frames, src_hw, seed)``, on one
model (seeded random weights): fp32 (the oracle), bf16, and int8
(calibrated on the first window). Each lower-precision run's max and mean
error after least-squares scale / shift alignment onto fp32, as fractions
of fp32's depth range, in one JSON line under the JAX tool's keys
("backend" is the device's type). It reports and gates nothing.

The weights are ``build_model(seed=0)``'s (torch Generators on the
device), unless ``--numpy_weights S`` loads
``models/video_depth.py::numpy_state_dict(cfg, S)``, which every machine
draws alike: the weights of the CPU comparison with the JAX package
(tests/test_torch_drift_518.py). The line then also carries
``weights_sha256`` (``state_dict_sha256``) and the drift of a fourth run,
int8 with fp32 activations (``int8_fp32_*``), the mode that test holds
against JAX int8. ``measure`` is the measurement, for chip_smoke.py too.
Needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .timing import card_line

KERNELS_TIMED = ("spatial_attention", "temporal_attention", "spatial_attention_qk8")


def measure(encoder: str = "vitl", frames: int = 50, src_hw=(644, 644), input_size: int = 518,
            seed: int = 3, device: str = "cuda", cfg=None,
            numpy_weights: int | None = None) -> dict:
    """The report; ``cfg`` (a ModelConfig) overrides ``encoder``'s;
    ``numpy_weights`` (a seed) loads ``numpy_state_dict``'s weights."""
    from ..config import get_model_config
    from ..models import build_model, load_numpy_state_dict, numpy_state_dict, state_dict_sha256
    from ..pipeline import VideoDepthPipeline
    from ..utils.precision import precision_drift_report, synthetic_video

    cfg = cfg or get_model_config(encoder)
    extra = {}
    if numpy_weights is None:
        model = build_model(cfg, seed=0, device=device)
    else:
        sd = numpy_state_dict(cfg, numpy_weights)
        extra = dict(numpy_weights=numpy_weights, weights_sha256=state_dict_sha256(sd))
        model = load_numpy_state_dict(build_model(cfg, device=device), sd)
        del sd
    video = synthetic_video(frames, tuple(src_hw), seed)
    kw = dict(input_size=input_size)
    d32, _ = VideoDepthPipeline(cfg, model, device=device).infer_video_depth(video, fp32=True, **kw)
    dbf, _ = VideoDepthPipeline(cfg, model, device=device).infer_video_depth(video, **kw)
    d8, _ = VideoDepthPipeline(cfg, model, device=device, quant="int8").infer_video_depth(video,
                                                                                         **kw)
    reps = {"bf16": precision_drift_report(dbf, d32), "int8": precision_drift_report(d8, d32)}
    if numpy_weights is not None:
        d8f, _ = VideoDepthPipeline(cfg, model, device=device, quant="int8").infer_video_depth(
            video, fp32=True, **kw)
        reps["int8_fp32"] = precision_drift_report(d8f, d32)
    rec = {"metric": f"{cfg.encoder}_drift_{input_size}",
           "frames": frames, "src_hw": list(src_hw),
           "backend": torch.device(device).type}
    for name, rep in reps.items():
        rec[f"{name}_max_err_frac"] = round(rep["max_err_frac"], 5)
        rec[f"{name}_mean_err_frac"] = round(rep["mean_err_frac"], 6)
    return {**rec, **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", default="vitl", choices=["vits", "vitb", "vitl", "vitg"])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--src_hw", type=int, nargs=2, default=(644, 644), metavar=("H", "W"))
    ap.add_argument("--input_size", type=int, default=518)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--numpy_weights", type=int, default=None, metavar="S",
                    help="numpy_state_dict(cfg, S)'s weights instead of build_model(seed=0)'s")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_drift_518: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(dict(measure(args.encoder, args.frames, args.src_hw, args.input_size,
                                  args.seed, numpy_weights=args.numpy_weights),
                          card=card_line())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
