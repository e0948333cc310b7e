"""A cell of mode ``train``: ``training/train_state.py::train_step`` on a
pool of batches made on the device from the seed.

A traffic file (``traffic/<name>.json``, mode ``train``) gives the batch
(``batch``, ``clip_len``, ``size``), ``pool_batches`` (distinct batches,
used in turn), the ``scene`` of the clips, ``first_steps`` (the steps of
set-up that the reference follows) and ``train`` (the hyper-parameters of
``TrainConfig``).

A batch is a clip the head can learn from: a smooth random scene whose
values change in each frame, normalised, and a target disparity that is a
function of each frame (the sigmoid of twice its channel mean), valid
everywhere.

Set-up builds one TrainState (fp32 master head, frozen encoder, AdamW),
drives it through ``first_steps`` steps on batches 0, 1, 2, ... (which also
build every shape), and hands the same state to the window, which steps on
until ``seconds`` have passed and synchronises. The numbers compared
(``check.train_numbers``) are the first steps' losses, the first
gradient as AdamW holds it after one step (``exp_avg / (1 - beta1)``) and
the change of every head tensor over the first steps, against the
reference (``reference/train.py``) from the same weights and batches.
"""
from __future__ import annotations

import gc
import sys
import time

import torch
import torch.nn.functional as F

from . import check, infer, weights
from . import trace as trace_mod
from .reference import model as ref_model
from .reference import train as ref_train

TRAFFIC_KEYS = {"name", "mode", "batch", "clip_len", "size", "pool_batches", "scene",
                "first_steps", "profile_s", "train"}


def validate(cell) -> None:
    """Refuses a cell whose files hold a key this mode does not take
    (``train``'s keys are TrainConfig's, which refuses its own unknown)."""
    bad = (set(cell.config) - infer.CONFIG_KEYS) | (set(cell.traffic) - TRAFFIC_KEYS) \
        | (set(cell.workload) - {"name", "config", "traffic", "chips", "why", "limits"})
    if bad or cell.config["dtype"] not in infer.DTYPES:
        raise ValueError(f"{cell.name}: keys the train harness does not take: {sorted(bad)}, "
                         f"or dtype {cell.config['dtype']!r}")


@torch.no_grad()
def batches(tr: dict, seed: int, device) -> list[dict]:
    """``pool_batches`` distinct batches {video, gt, mask} on ``device``."""
    b, t, s = tr["batch"], tr["clip_len"], tr["size"]
    g = tr["scene"]["grid"]
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(tr["pool_batches"]):
        scene = (torch.randn(b, 1, 3, g, g, generator=gen, device=device)
                 + tr["scene"]["drift"] * torch.randn(b, t, 3, g, g, generator=gen, device=device))
        video = F.interpolate(scene.reshape(b * t, 3, g, g), size=(s, s), mode="bilinear",
                              align_corners=True).permute(0, 2, 3, 1).reshape(b, t, s, s, 3)
        gt = torch.sigmoid(2 * video.mean(-1))
        out.append({"video": video.contiguous(), "gt": gt, "mask": torch.ones_like(gt)})
    return out


def train_config(tr: dict, dtype: str):
    from video_depth_anything_torch.training.train_state import TrainConfig

    return TrainConfig(clip_len=tr["clip_len"], compute_dtype=dtype, **tr["train"])


def program_state(cfg: dict, sd: dict, tr: dict, dev):
    from video_depth_anything_torch.training.train_state import create_train_state

    model = infer.program_model(cfg, sd, dev)
    return create_train_state(model, train_config(tr, cfg["dtype"]))


def first_steps(state, data, port_cfg, tc, n: int) -> dict:
    """Drive ``state`` through its first ``n`` steps on batches 0..n-1 ->
    what the check compares (host copies)."""
    from video_depth_anything_torch.training.train_state import train_step

    start = {k: v.detach().clone() for k, v in state.head.items()}
    losses, grads = [], None
    for i in range(n):
        _, m = train_step(state, data[i], port_cfg, tc)
        losses.append(float(m["loss"]))
        if grads is None:
            b1 = state.opt.param_groups[0]["betas"][0]
            grads = {k: (state.opt.state[t]["exp_avg"] / (1 - b1)).float().cpu()
                     for k, t in state.head.items()}
    change = {k: (t.detach() - start[k]).float().cpu() for k, t in state.head.items()}
    return {"losses": losses, "grads": grads, "change": change}


def reference_steps(cfg, sd, data, tr, dev, n: int, low=None) -> dict:
    """The reference's first ``n`` steps from the same weights and batches
    (``low``: its products' operands rounded to that dtype, the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = infer.reference_model(cfg, sd, dev)
        tc = dict(tr["train"], ratio_ssi=1.0)
        if low is None:
            out = ref_train.follow(ref, data, tc, n)
        else:
            with ref_model.operands(ref, low):
                out = ref_train.follow(ref, data, tc, n)
        return {"losses": out["losses"],
                "grads": {k: g.detach().float().cpu() for k, g in out["grads"].items()},
                "change": {k: c.detach().float().cpu() for k, c in out["change"].items()}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class PhaseEvents:
    """CUDA events at ``train_step``'s phase boundaries, per step."""

    def __init__(self):
        self.steps: list[dict] = []

    def __call__(self, name: str) -> None:
        if name == "encoder":
            self.steps.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1][name] = ev

    def ms(self, a: str, b: str) -> float:
        return sum(s[a].elapsed_time(s[b]) for s in self.steps) / max(len(self.steps), 1)


def run(cell, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    from video_depth_anything_torch.training.train_state import train_step

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sd = weights.state_dict(infer.reference_shapes(cfg), seed, dev, infer.DTYPES[cfg["dtype"]])
    state = program_state(cfg, sd, tr, dev)
    sd = {k: v.cpu() for k, v in sd.items()}
    port_cfg, tc = infer.port_config(cfg), train_config(tr, cfg["dtype"])
    data = batches(tr, seed, dev)
    n_first = tr["first_steps"]
    got = first_steps(state, data, port_cfg, tc, n_first)
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = setup_clock()

    phase = PhaseEvents() if trace and cuda else None
    steps, attempted, failed = 0, 0, 0
    host = infer.HostUse()
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        attempted += 1
        try:
            train_step(state, data[(n_first + steps) % len(data)], port_cfg, tc, phase=phase)
        except Exception as e:   # a step that fails counts; the run stops there
            print(f"train step {steps} failed: {e!r}", file=sys.stderr)
            failed += 1
            break
        steps += 1
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    print(f"window: {steps} steps in {window_s:.3f} s; host {host.since()}", file=sys.stderr)
    e2e = {"setup_s": setup_s, "train_step_ms": 1e3 * window_s / max(steps, 1),
           "peak_mem_gib": peak / 2**30}

    ctx = None
    if trace:
        ctx = {"config": cfg, "traffic": tr, "window_s": window_s, "steps": steps,
               "profile": None}
        if phase is not None:
            ctx["backward_ms"] = phase.ms("backward", "optimizer")
            ctx["profile"] = _profile(state, data, port_cfg, tc, tr)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = reference_steps(cfg, sd, data[:n_first], tr, dev, n_first)
    return {"attempted": attempted, "failed": failed, "e2e": e2e, "ctx": ctx,
            "numbers": check.train_numbers(got, want),
            "peak": max(peak, setup_peak) if cuda else 0}


def _profile(state, data, port_cfg, tc, tr):
    """A few more steps (at least ``profile_s`` seconds) under torch.profiler."""
    from video_depth_anything_torch.training.train_state import train_step

    torch.cuda.synchronize()
    n = 0
    with trace_mod.profiled() as prof:
        with torch.profiler.record_function("vdabench.span"):
            t0 = time.perf_counter()
            while n == 0 or time.perf_counter() < t0 + tr["profile_s"]:
                train_step(state, data[n % len(data)], port_cfg, tc)
                n += 1
            torch.cuda.synchronize()
    profile = trace_mod.read(prof)
    profile.calls = {"steps": n}
    return profile


def readings(cell, seed: int, control: bool, device="cuda") -> list[dict]:
    """The program's numbers on a seed, and (``control``) the control's
    (the reference with float8 e4m3 operands in the program's place) and
    the planted fault's (the reference with half of each batch's frames
    left out, its loss the mean over the rest)."""
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    n = tr["first_steps"]
    sd = weights.state_dict(infer.reference_shapes(cfg), seed, dev, infer.DTYPES[cfg["dtype"]])
    state = program_state(cfg, sd, tr, dev)
    data = batches(tr, seed, dev)
    t0 = time.perf_counter()
    sides = {"program": first_steps(state, data, infer.port_config(cfg),
                                    train_config(tr, cfg["dtype"]), n)}
    side_s = {"program": time.perf_counter() - t0}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = reference_steps(cfg, sd, data[:n], tr, dev, n)
    ref_s = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        sides["control_fp8"] = reference_steps(cfg, sd, data[:n], tr, dev, n,
                                               low=torch.float8_e4m3fn)
        side_s["control_fp8"] = time.perf_counter() - t0
        half = [{k: v[:, : v.shape[1] // 2] for k, v in b.items()} for b in data[:n]]
        sides["fault_half_batch"] = reference_steps(cfg, sd, half, tr, dev, n)
    return [{"cell": cell.name, "seed": seed, "side": side,
             "numbers": check.train_numbers(got, want), "losses": got["losses"],
             "reference_losses": want["losses"], "side_s": side_s.get(side),
             "reference_s": ref_s} for side, got in sides.items()]
