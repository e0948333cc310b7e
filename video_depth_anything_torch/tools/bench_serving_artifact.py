"""Card bench of the serving artifact against the live window program.

    python -m video_depth_anything_torch.tools.bench_serving_artifact \\
        [--encoder vitl] [--src_hw 518 518] [--input_size 518] [--fp32] [--int8] \\
        [--iters 5] [--no_cpu_trace] [--json out.jsonl]

Exports the window program (``utils/serving_export.py``) on the card,
saves and loads it, and runs it and the live program (the pipeline's plain
mode, ``PlainWindows``) at the network size the pipeline derives from
(``src_hw``, ``input_size``) on one random window (C = 1, seed 0; random
weights from seed 0; int8 calibrated on that window). Then, unless
``--no_cpu_trace``, it exports a second artifact on the CPU and moves it
to the card (``load_exported(path, device="cuda")``): the port's
counterpart of the JAX tool's ``use_pallas`` A/B, showing that where the
artifact was traced does not change which kernels it serves.

Prints one JSON line, its metric named by the input size as the JAX
tool's (``<encoder>_serving_artifact_<input_size>``): for each program the median ms per frame over
``--iters`` calls (host clock, each call synchronised; a window is 32
frames) and its runs, the idle share of ``--iters`` more calls under
torch.profiler (1 - kernels' busy time / wall time; busy and wall per
call), the kernels' launches per call; each
artifact's bit-for-bit equality with the live output; the export, save
and load seconds, the artifact's bytes and its graph's call nodes (the
five most frequent targets); the card's name and power
limit. ``measure`` is chip_smoke.py's phase (q) too. Exits 2 without a
card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch


def _timed(call, iters: int, frames: int) -> dict:
    """One warm call, then ``iters`` synchronised calls: median ms per frame
    and the runs; then ``iters`` more under the profiler: their idle share
    (one call alone is at the mercy of a single host pause)."""
    from .bench_long_video import profiled

    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    n = max(iters, 1)
    wall, busy, copies = profiled(lambda: [(call(), torch.cuda.synchronize()) for _ in range(n)])
    return dict(ms_per_frame=statistics.median(walls) / frames,
                ms_per_frame_runs=[w / frames for w in walls], profiled_wall_ms=wall / n,
                kernel_busy_ms=busy / n, copy_ms=copies / n, idle_share=1 - busy / wall)


def _launches(call):
    from .. import kernels

    kernels.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    return out, {k: n for k, n in kernels.launch_counts().items() if n}


def measure(encoder: str = "vitl", src_hw=(518, 518), fp32: bool = False, int8: bool = False,
            iters: int = 5, cpu_trace: bool = True, input_size: int = 518) -> dict:
    """The bench's record (module docstring)."""
    import numpy as np

    from ..config import get_model_config
    from ..models import build_model
    from ..pipeline import VideoDepthPipeline
    from ..pipeline.infer import PlainWindows
    from ..utils import serving_export as se
    from .timing import card_line

    cfg = get_model_config(encoder)
    src_hw = tuple(src_hw)
    net_hw = se.geometry(src_hw, input_size)
    dtype = se.serving_dtype(fp32)
    quant = "int8" if int8 else None
    model = build_model(cfg, seed=0, device="cuda")
    win = np.random.default_rng(0).integers(0, 256, size=(1, 32, *src_hw, 3), dtype=np.uint8)
    frames = torch.from_numpy(win).cuda()
    pipe = VideoDepthPipeline(cfg, model)
    with torch.no_grad():
        if int8:
            live_model = pipe.quantized_model(win[0], net_hw, dtype)
            state = se.quantize_for_serving(model, win, cfg, net_hw, fp32=fp32)
            want = live_model.state_dict()
            state_equal = all(torch.equal(state[k], want[k]) for k in want)
        else:
            live_model = pipe.model_in(dtype)
            state = se.cast_params(model.state_dict(), fp32=fp32)
            state_equal = None
    live = PlainWindows(live_model, net_hw, src_hw, dtype)
    programs = {"live": lambda: live(frames.reshape(-1, *frames.shape[2:]), None, 1)}
    rec: dict = dict(metric=f"{encoder}_serving_artifact_{input_size}", card=card_line(),
                     encoder=encoder, src_hw=list(src_hw), input_size=input_size,
                     net_hw=list(net_hw), dtype=str(dtype).split(".")[1], quant=quant,
                     windows_per_call=1, frames_per_call=32, int8_state_equal=state_equal)
    traces = [("artifact", "cuda")] + ([("artifact_cpu_traced", "cpu")] if cpu_trace else [])
    with tempfile.TemporaryDirectory() as tmp:
        for name, device in traces:
            t0 = time.perf_counter()
            ep = se.export_window_program(cfg, src_hw, input_size, fp32=fp32, device=device,
                                          quant=quant)
            export_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.pt2")
            t0 = time.perf_counter()
            se.save_exported(ep, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            program = se.artifact_module(se.load_exported(path, device="cuda"))
            load_s = time.perf_counter() - t0
            programs[name] = lambda program=program: program(state, frames)
            ops = se.op_counts(ep)
            rec[name] = dict(traced_on=device, export_s=export_s, save_s=save_s, load_s=load_s,
                             bytes=os.path.getsize(path), vda_ops=se.vda_op_counts(ep),
                             call_nodes=sum(ops.values()), top_ops=dict(list(ops.items())[:5]))
            del ep
    outs = {}
    with torch.no_grad():
        for name, call in programs.items():
            outs[name], n = _launches(call)
            rec.setdefault(name, {}).update(launches_per_call=n, **_timed(call, iters, 32))
    for name in programs:
        if name != "live":
            rec[name]["equal_to_live"] = bool(torch.equal(outs[name], outs["live"]))
            rec[name]["launches_equal_to_live"] = (rec[name]["launches_per_call"]
                                                   == rec["live"]["launches_per_call"])
    rec["output_shape"] = list(outs["live"].shape)
    rec["output_finite"] = bool(torch.isfinite(outs["live"]).all())
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--encoder", default="vitl", choices=["vits", "vitb", "vitl", "vitg"])
    ap.add_argument("--src_hw", type=int, nargs=2, default=[518, 518], metavar=("H", "W"))
    ap.add_argument("--input_size", type=int, default=518,
                    help="the pipeline's input size; the network size follows the "
                         "pipeline's rule (preprocess.effective_input_size)")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no_cpu_trace", action="store_true")
    ap.add_argument("--json", default=None, help="append the record to this JSON-lines file")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_serving_artifact: no CUDA device", file=sys.stderr)
        return 2
    from ..kernels import build

    build.build_all()
    rec = measure(args.encoder, args.src_hw, args.fp32, args.int8, args.iters,
                  cpu_trace=not args.no_cpu_trace, input_size=args.input_size)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
