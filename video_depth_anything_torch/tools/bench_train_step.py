"""Real-scale training-step benchmark (the port of the JAX package's
``tools/bench_train_step.py``).

The reference's training setting: encoder vits, clip_len 20, 518x518,
batch 1, frozen encoder, bf16 with fp32 masters (``--fp32``: all fp32),
lstsq SSI + 10 TGM, seeded random weights (``synthetic_model``) and a
seeded clip whose target the head can learn (``synthetic_batch``). A
few warm steps, then ``--iters`` timed ones; prints ONE JSON line: the
median ms per step (wall, synchronised), its split into encoder (no
grad), head forward and loss, backward and optimizer (CUDA events at the
step's phase boundaries), the K2 backward's ms per step and share of the
step, the kernels' launches per step, the peak device memory, and each
step's loss and largest gradient of the last conv's weight (0 once no
output is above the final ReLU).

    python -m video_depth_anything_torch.tools.bench_train_step \\
        [--encoder vits] [--clip_len 20] [--size 518] [--batch 1] [--iters 5] [--fp32]

Runs on ``--device`` (default ``cuda``); ``--device cpu`` runs the plain
PyTorch path, untimed by events.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

PHASES = ("encoder", "head", "backward", "optimizer")


@contextlib.contextmanager
def k2_backward_events(events: list):
    """Record a CUDA event pair around every K2 backward into ``events``."""
    from ..kernels.temporal_attention import TemporalAttentionFunction as fn

    orig = fn.backward

    def timed(ctx, do):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig(ctx, do)
        end.record()
        events.append((start, end))
        return out

    fn.backward = staticmethod(timed)
    try:
        yield
    finally:
        fn.backward = orig


# The last conv's bias is raised by this so that every output starts
# positive and stays so, as a trained head's disparity does: with the
# seeded init the outputs before the final ReLU are of order 1 and about
# half are below 0, and the first AdamW steps (about lr * sign(g) on every
# tensor) send the rest there, after which no gradient passes the ReLU and
# the loss stops moving.
OUTPUT_BIAS = 10.0
OUTPUT_WEIGHT = "scratch.output_conv2.2.weight"   # the last conv, before the final ReLU


def synthetic_model(cfg, seed: int = 0, device="cpu"):
    """build_model(cfg, seed) with the output bias raised by OUTPUT_BIAS."""
    from ..models import build_model

    model = build_model(cfg, seed=seed, device=device)
    with torch.no_grad():
        model.head.scratch.output_conv2[2].bias.add_(OUTPUT_BIAS)
    return model


def synthetic_batch(batch: int, clip_len: int, size: int, device, seed: int = 0) -> dict:
    """A clip the head can learn from: a smooth random scene (6x6 values
    per channel, bilinear to ``size``) whose values change by N(0, 0.5^2)
    in each frame, and a target disparity that is a function of each frame
    (the sigmoid of twice its channel mean), valid everywhere. The scene
    moves, so TGM compares frames that differ (held still, every pixel
    would sit at the kink of its |pred[t+1] - pred[t]|)."""
    rng = np.random.default_rng(seed)
    scene = rng.standard_normal((batch, 1, 3, 6, 6)) + 0.5 * rng.standard_normal(
        (batch, clip_len, 3, 6, 6))
    low = torch.tensor(scene.reshape(batch * clip_len, 3, 6, 6), dtype=torch.float32)
    video = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=True)
    video = video.permute(0, 2, 3, 1).reshape(batch, clip_len, size, size, 3)
    gt = torch.sigmoid(2 * video.mean(-1))
    return {"video": video.to(device), "gt": gt.to(device),
            "mask": torch.ones_like(gt, device=device)}


def measure(encoder: str = "vits", clip_len: int = 20, size: int = 518, batch: int = 1,
            iters: int = 5, warmup: int = 2, fp32: bool = False, device: str = "cuda") -> dict:
    """Time ``iters`` train steps after ``warmup`` -> the record (see the
    module docstring), with the stepped TrainState under "state"."""
    from .. import kernels
    from ..config import get_model_config
    from ..training.train_state import TrainConfig, create_train_state, train_step

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = get_model_config(encoder, num_frames=clip_len)
    tc = TrainConfig(compute_dtype="float32" if fp32 else "bfloat16", clip_len=clip_len)
    state = create_train_state(synthetic_model(cfg, 0, dev), tc)
    data = synthetic_batch(batch, clip_len, size, dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    losses, out_grad = [], []
    for _ in range(warmup):
        _, m = train_step(state, data, cfg, tc)
        losses.append(float(m["loss"]))
        out_grad.append(state.head[OUTPUT_WEIGHT].grad.abs().max().item())
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, splits, k2_bwd = [], [], []
    for i in range(iters):
        marks: dict = {}

        def phase(name):
            if cuda:
                marks[name] = torch.cuda.Event(enable_timing=True)
                marks[name].record()

        events: list = []
        sync()
        t0 = time.perf_counter()
        with k2_backward_events(events) if cuda else contextlib.nullcontext():
            _, m = train_step(state, data, cfg, tc, phase=phase)
        losses.append(float(m["loss"]))   # the readout synchronises
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        out_grad.append(state.head[OUTPUT_WEIGHT].grad.abs().max().item())
        if i == 0:
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
        if cuda:
            bounds = PHASES + ("end",)
            splits.append({p: marks[p].elapsed_time(marks[q]) for p, q in zip(bounds, bounds[1:])})
            k2_bwd.append(sum(s.elapsed_time(e) for s, e in events))
    step_ms = statistics.median(walls)
    rec = {
        "metric": f"{encoder}_train_step_{size}_clip{clip_len}",
        "value": step_ms, "unit": "ms/step",
        "clips_per_sec": batch / step_ms * 1e3,
        "frames_per_sec": batch * clip_len / step_ms * 1e3,
        "compute_dtype": tc.compute_dtype, "device": str(dev),
        "launches_per_step": launches, "losses": losses, "output_grad_max": out_grad,
        "finite": bool(np.isfinite(losses).all()),
    }
    if cuda:
        rec["split_ms"] = {p: statistics.median(s[p] for s in splits) for p in PHASES}
        rec["k2_backward_ms"] = statistics.median(k2_bwd)
        rec["k2_backward_share"] = rec["k2_backward_ms"] / step_ms
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["card"] = torch.cuda.get_device_name(dev)
    rec["state"] = state
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--encoder", default="vits", choices=["vits", "vitl"])
    ap.add_argument("--clip_len", type=int, default=20)
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--fp32", action="store_true",
                    help="compute in fp32 (default bf16 with fp32 masters)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("bench_train_step: no CUDA device (use --device cpu)")
        return 2
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rec = measure(args.encoder, args.clip_len, args.size, args.batch, args.iters,
                  args.warmup, args.fp32, args.device)
    rec.pop("state")
    print(json.dumps(rec))
    return 0 if rec["finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
