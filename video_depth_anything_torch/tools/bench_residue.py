"""Does earlier work in a process slow a later window forward? On the card.

    python -m video_depth_anything_torch.tools.bench_residue [--iters 6] [--chain 3]
        [--size 518] [--dummy_programs 4] [--dummy_trees 3]

The port of the JAX package's ``tools/bench_residue.py``, which separated
two ways in which a process that had run int8 calibration and a quantized
forward could run a later forward slower. One probe, a vits bf16 window
forward (seeded random weights, 1x32 x size^2), is timed in four phases
of one process:

  0  the baseline;
  1  the memory arm: ``dummy_trees`` vitl-sized models materialised on
     the card (no new work), the probe timed, the models freed, timed again;
  2  the program arm: ``dummy_programs`` vitl window forwards run, the
     k-th a chain of k + 1. The JAX tool compiled a distinct executable
     each; eager PyTorch compiles nothing, so what this arm leaves behind
     is cuBLAS / cuDNN handles and workspaces and the blocks the caching
     allocator keeps;
  3  the vitl model and its outputs dropped and ``torch.cuda.empty_cache()``
     called.

The probe's time is the median of ``iters`` timings of a chain of
``chain`` forwards between CUDA events (``timing.time_ms``), in ms per
chain. Each phase prints one JSON line, with ``vs_baseline`` after phase
0. ``measure`` is the measurement, for chip_smoke.py too. Needs a CUDA
card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys

import torch

from .bench_ablate import seeded_model
from .timing import card_line, time_ms

KERNELS_TIMED = ("spatial_attention", "temporal_attention")


@torch.no_grad()
def measure(iters: int = 6, chain: int = 3, size: int = 518, dummy_programs: int = 4,
            dummy_trees: int = 3) -> list[dict]:
    """The four phases' records (also printed as JSON lines)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    probe_model = seeded_model("vits")
    x = torch.randn(1, 32, size, size, 3, device="cuda", generator=gen).to(torch.bfloat16)
    recs, card = [], card_line()

    def timed():
        probe_model(x)
        return statistics.median(time_ms(lambda: probe_model(x), chain, warmup=0) * chain
                                 for _ in range(iters))

    def report(phase, t, base=None):
        rec = {"phase": phase, "probe_ms": round(t, 2)}
        if base is not None:
            rec["vs_baseline"] = round(t / base, 3)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        recs.append(rec)

    probe_model(x)
    base = timed()
    report("0_baseline", base)

    trees = [seeded_model("vitl", seed=10 + i) for i in range(dummy_trees)]
    torch.cuda.synchronize()
    report("1_memory_loaded", timed(), base)
    del trees
    gc.collect()
    report("1_memory_freed", timed(), base)

    big = seeded_model("vitl", seed=1)
    outs = [big(x) for k in range(dummy_programs) for _ in range(k + 1)]
    torch.cuda.synchronize()
    report("2_programs_live", timed(), base)

    del big, outs
    gc.collect()
    torch.cuda.empty_cache()
    report("3_programs_freed", timed(), base)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--chain", type=int, default=3)
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--dummy_programs", type=int, default=4)
    ap.add_argument("--dummy_trees", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_residue: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    measure(args.iters, args.chain, args.size, args.dummy_programs, args.dummy_trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
