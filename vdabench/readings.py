"""Readings of the correctness check on many seeds in one process: the
program as the cell runs it, and the controls, on the clips each seed's
run would compare.

Two controls: ``control_int8``, the program's own lower-precision path
(the same pipeline with ``quant="int8"``: int8 weights and activations in
the encoder's and the motion modules' linears), calibrated on the first
window of the seed's first sampled clip; and ``control_fp8``, the
reference put in the program's place and computed with every product's
operands rounded to float8 e4m3 (one scale per tensor;
``reference.model.operands``). The limits in ``workloads/<cell>.json``
lie between the program's largest reading and the controls' smallest
(PERF.md). Each clip's record also holds every tap's and every encoder
branch's reading (``each_tap``, ``each_branch``), from which the compared
numbers were chosen.

    python3 -m vdabench.readings --workload <cell> --seeds 1 2 3 [--control] [--taps_only]

Prints one JSON line per seed and side; needs a CUDA card. A train cell's
readings are ``train.readings``'s (its control: the reference with float8
operands; and the planted fault of half of each batch left out).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import check, infer, run, spec, traffic, train, weights
from .reference import model as ref_model
from .reference import pipeline as ref_pipeline


def readings(cell, seed: int, control: bool, device="cuda", depth: bool = True) -> list[dict]:
    """[{seed, side, numbers, seconds}] for the program and (``control``)
    the two controls, on the seed's sampled clips (``depth`` False: the
    taps alone, without the reference's whole clips)."""
    from video_depth_anything_torch.pipeline.infer import VideoDepthPipeline

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    dtype = infer.DTYPES[cfg["dtype"]]
    sd = weights.state_dict(infer.reference_shapes(cfg), seed, dev, dtype)
    model = infer.program_model(cfg, sd, dev)
    pool = traffic.frame_pool(tr, seed, dev)
    sample = sorted(traffic.check_sample(cell.workload, seed))
    sched = traffic.clips(tr, seed)
    clips = {}
    while len(clips) < len(sample):
        o, start, n = next(sched)
        if o in sample:
            clips[o] = (start, n)
    kw = dict(input_size=tr["input_size"], windows_per_batch=tr["windows_per_batch"],
              fp32=dtype == torch.float32)
    opts = tr.get("pipeline", {})
    sides = {"program": VideoDepthPipeline(infer.port_config(cfg), model, device=dev, **opts)}
    if control:
        sides["control_int8"] = VideoDepthPipeline(infer.port_config(cfg), model, device=dev,
                                                   **dict(opts, quant="int8"))
    outs, taps = {}, {}
    for side, pipe in sides.items():
        t0 = time.perf_counter()
        first = next(iter(clips.values()))
        infer.call(pipe, pool[first[0]:first[0] + first[1]], tr, kw)   # builds the model
        tp = infer.Taps(infer.served_model(pipe, tr, dtype), range(max(cfg["taps"]) + 1))
        outs[side] = []
        for o, (s, n) in clips.items():
            tp.armed = o
            outs[side].append(infer.call(pipe, pool[s:s + n], tr, kw))
        taps[side] = tp.host()
        outs[side + "_s"] = time.perf_counter() - t0
    del sides, model, tp
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ref = infer.reference_model(cfg, {k: v for k, v in sd.items()}, dev)
    del sd
    ref_io = infer.BlockIO(ref, range(max(cfg["taps"]) + 1))
    per = {side: [] for side in outs if not side.endswith("_s")}
    if control:
        per["control_fp8"] = []
        outs["control_fp8_s"] = 0.0
    net_hw = ref_pipeline.network_size(*tr["source_hw"], tr["input_size"])
    t0 = time.perf_counter()
    for i, (o, (s, n)) in enumerate(clips.items()):
        frames = torch.from_numpy(pool[s:s + n]).to(dev)
        rows = ref_pipeline.preprocess(frames[infer.Taps.frames(n)], net_hw)
        want_taps = ref.encode(rows)
        want = ref_pipeline.infer_video_depth(ref, frames, tr["input_size"],
                                              metric=cfg.get("metric", False)) if depth else None
        for side in per:
            if side == "control_fp8":
                t1 = time.perf_counter()
                with ref_model.operands(ref, torch.float8_e4m3fn):
                    ref_io.on, ref_io.kept = True, {}
                    got_taps = ref.encode(rows)
                    ref_io.on = False
                    got_blocks = ref_io.kept
                    got = ref_pipeline.infer_video_depth(
                        ref, frames, tr["input_size"], metric=cfg.get("metric", False)) \
                        if depth else None
                outs["control_fp8_s"] += time.perf_counter() - t1
            else:
                got_taps, got_blocks = taps[side][0][o], taps[side][1][o]
                got = torch.from_numpy(outs[side][i]).to(dev)
            nums = check.clip_numbers(got, want) if depth else {}
            each = check.tap_errs_pct(got_taps, want_taps)
            branches = check.branch_errs_pct(got_blocks, ref)
            nums["tap_err_pct"] = max(each)
            nums["branch_err_pct"] = max(v for k, v in branches.items()
                                         if int(k.split(".")[1]) in cfg["taps"])
            per[side].append(dict(nums, each_tap=each, each_branch=branches))
    ref_s = time.perf_counter() - t0 - outs.get("control_fp8_s", 0.0)
    return [{"cell": cell.name, "seed": seed, "side": side, "clips": [n for _, n in clips.values()],
             "numbers": check.worst([{k: x for k, x in d.items() if not k.startswith("each")}
                                     for d in v]),
             "per_clip": v, "side_s": outs[side + "_s"],
             "reference_s": ref_s} for side, v in per.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--taps_only", action="store_true",
                    help="infer cells: compare the taps alone, not the whole clips' depth")
    args = ap.parse_args(argv)
    run.use_checkout_caches()
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    from video_depth_anything_torch.utils.compile_cache import maybe_enable_from_env

    maybe_enable_from_env()
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        if cell.traffic["mode"] == "train":
            recs = train.readings(cell, seed, args.control)
        else:
            recs = readings(cell, seed, args.control, depth=not args.taps_only)
        for rec in recs:
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
