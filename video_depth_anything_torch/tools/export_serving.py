"""Export the serving window program as a ``torch.export`` artifact.

    python -m video_depth_anything_torch.tools.export_serving --encoder vitl \\
        --src_hw 1080 1920 --output vitl_1080p.pt2 [--int8] [--verify]

Writes ``<output>`` (+ ``<output>.json`` metadata) through
``utils/serving_export.py``: the exact program the pipeline's plain mode
runs per chunk of windows, frozen for deployment. The weights travel
separately (the artifact takes the state dict as an argument), so one
artifact serves every checkpoint of its encoder. The port of the JAX
package's ``tools/export_serving.py``, with ``--device`` (default
``cuda``; ``cpu`` traces on the CPU, and ``load_exported(path,
device="cuda")`` moves that artifact to the card) in place of
``--platforms``; the kernels are custom ops in every artifact, so there is
no ``--use_pallas``. Without a card and without ``--device cpu`` it exits.

``--verify`` reads the artifact back and holds it, on the export's device
and in this process, to the live program (the pipeline's own model, int8
calibrated on the same window) on one random window from seed 0, bit for
bit (``torch.equal``); on the card the kernels' launches per call must be
equal too.
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--encoder", default="vitl", choices=["vits", "vitb", "vitl", "vitg"])
    ap.add_argument("--metric", action="store_true")
    ap.add_argument("--src_hw", type=int, nargs=2, required=True, metavar=("H", "W"),
                    help="serving frame resolution (after run.py's --max_res clamp, if any)")
    ap.add_argument("--input_size", type=int, default=518)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--windows_per_batch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the device to trace on (default cuda; cpu needs no card)")
    ap.add_argument("--int8", action="store_true",
                    help="export over the int8 model (its state dict from "
                         "serving_export.quantize_for_serving, or the pipeline's "
                         "<ckpt>.int8calib.npz)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--verify", action="store_true",
                    help="read the artifact back and compare one random window with the "
                         "live program, bit for bit, on --device")
    return ap.parse_args(argv)


def verify(cfg, args, path: str) -> None:
    """The artifact at ``path`` against the live program (module docstring)."""
    import numpy as np
    import torch

    from .. import kernels
    from ..models import build_model
    from ..pipeline import VideoDepthPipeline
    from ..pipeline.infer import PlainWindows
    from ..utils import serving_export as se

    src_hw, c = tuple(args.src_hw), args.windows_per_batch
    net_hw = se.geometry(src_hw, args.input_size)
    dtype = se.serving_dtype(args.fp32)
    model = build_model(cfg, seed=0, device=args.device)
    win = np.random.default_rng(0).integers(0, 256, size=(c, 32, *src_hw, 3), dtype=np.uint8)
    pipe = VideoDepthPipeline(cfg, model, device=args.device)
    if args.int8:
        live_model = pipe.quantized_model(win[0], net_hw, dtype)
        state = se.quantize_for_serving(model, win[:1], cfg, net_hw, fp32=args.fp32)
    else:
        live_model = pipe.model_in(dtype)
        state = se.cast_params(model.state_dict(), fp32=args.fp32)
    frames = torch.from_numpy(win).to(args.device)
    program = se.artifact_module(se.load_exported(path, device=args.device))
    live = PlainWindows(live_model, net_hw, src_hw, dtype)

    def counted(call):
        kernels.reset_launch_counts()
        out = call()
        return out, {k: n for k, n in kernels.launch_counts().items() if n}

    with torch.no_grad():
        got, got_n = counted(lambda: program(state, frames))
        want, want_n = counted(lambda: live(frames.reshape(-1, *frames.shape[2:]), None, c))
    if not torch.equal(got, want):
        sys.exit(f"verify: the artifact differs from the live program (max |d| "
                 f"{(got - want).abs().max().item():.3e})")
    if got_n != want_n:
        sys.exit(f"verify: launches per call {got_n}, the live program's {want_n}")
    print(f"verify: artifact output == live program (bit-exact), launches per call {got_n}")


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from ..run import probe_device

    probe_device(args.device)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is available; --device cpu traces on the CPU")
    from ..config import get_model_config
    from ..utils import serving_export as se

    cfg = get_model_config(args.encoder, metric=args.metric)
    ep = se.export_window_program(
        cfg, tuple(args.src_hw), input_size=args.input_size, fp32=args.fp32,
        windows_per_batch=args.windows_per_batch, device=args.device,
        quant="int8" if args.int8 else None)
    se.save_exported(ep, args.output, {
        "encoder": args.encoder, "metric": args.metric, "src_hw": list(args.src_hw),
        "input_size": args.input_size, "fp32": args.fp32,
        "windows_per_batch": args.windows_per_batch, "quant": "int8" if args.int8 else None,
    })
    size = os.path.getsize(args.output)
    ops = se.op_counts(ep)
    print(f"wrote {args.output} ({size / 1e6:.1f} MB, traced on {args.device}, "
          f"ops {se.vda_op_counts(ep)}; {sum(ops.values())} call nodes, the most frequent "
          f"{dict(list(ops.items())[:3])})")
    if args.verify:
        verify(cfg, args, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
