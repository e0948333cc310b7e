"""The benchmark's command:

    python3 -m vdabench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``spec.py``), builds it from the seed, warms it up,
measures for ``--seconds``, checks what the timed path returned against
the reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; the compared numbers and their
limits come last in it, under ``checks``, and as the last lines of
standard error.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and 3
if a module of JAX or of the JAX package was loaded by the time the
window closed; neither prints a result. The program's kernel libraries
are built into ``.vdabench_cache/`` at the root of the checkout, so only
a checkout's first run builds them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "video_depth_anything_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".vdabench_cache")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def use_checkout_caches() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, set before the program is imported."""
    os.environ["VDA_COMPILE_CACHE"] = os.path.join(CACHE, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN})


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str | None = None, benchmark: str | None = None,
             setup_clock=process_age_s) -> dict:
    """One run of cell ``name`` -> the result line as a dict (``device``
    "cpu" runs the program's plain path: the tests' way round the card)."""
    import torch

    from . import check, spec

    cell = spec.load_cell(name, root or spec.HERE, benchmark)
    mode = spec.mode_module(cell)
    mode.validate(cell)
    seed = seed % 2**64
    if device == "cuda":
        from video_depth_anything_torch.utils.compile_cache import maybe_enable_from_env

        maybe_enable_from_env()
        torch.backends.cuda.matmul.allow_tf32 = False   # as the program's run.py sets it
        torch.backends.cudnn.allow_tf32 = False
    out = mode.run(cell, seed, seconds, trace, device, setup_clock)
    ok, checks = check.judge(out["numbers"], cell.workload["limits"])
    correct = ok and out["failed"] == 0 and out["attempted"] > 0
    if trace:
        metrics = _per_layer(cell, out["ctx"], root or spec.HERE)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out["e2e"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "count": 1,
           "memory_peak_bytes": int(out["peak"])}
    if device == "cuda":
        dev["kind"] = torch.cuda.get_device_name(0)
        dev["power_limit"] = _power_limit()
    line = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    prof = (out["ctx"] or {}).get("profile")
    if trace and prof is not None:
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.window_s
        line["breakdown"] = prof.breakdown()
    line["checks"] = checks
    return line


def _per_layer(cell, ctx: dict, root: str) -> dict:
    """{metric: value} of the cell's per-layer metrics whose reader found
    something to read."""
    import types

    from . import counts, spec

    ns = types.SimpleNamespace(counts=counts, **ctx)
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"], root)(ns)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Video Depth Anything (PyTorch port) benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    import torch

    from . import spec

    chips = spec.load_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vdabench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"vdabench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
