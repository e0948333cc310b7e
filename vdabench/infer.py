"""A cell of mode ``infer``: clips through ``VideoDepthPipeline.
infer_video_depth`` (or the traffic's ``entry``), one client in a closed
loop.

Set-up: the seeded weights (``weights.py``) loaded strictly into the
program's model, the pipeline, the frame pool (``traffic.py``), and one
clip of each ``warmup_lengths`` so that every shape the cell's clips use
is built. The window: clips are sent one after another, in whole cycles
(``traffic.cycles``), until ``seconds`` have passed; every clip sent is
waited for. For the sampled clips (``traffic.check_sample``) the encoder's
taps and branch inputs and outputs of a few frames of the first window
are kept on the device (``Taps``). With ``trace``: the window runs with
the pipeline's ``collect_timings`` and CUDA events around the encoder and
the head, then a few more clips run under torch.profiler.
After the window: the peak memory is read, the program is freed, and the
reference (``reference/``, float32, TF32 off) computes the sampled clips
(``traffic.check_sample``; one that the window did not reach runs after
it, untimed) again for the comparison (``check.py``).
"""
from __future__ import annotations

import gc
import itertools
import statistics
import sys
import time

import numpy as np
import torch

from . import check, traffic, weights
from . import trace as trace_mod
from .reference import model as ref_model
from .reference import pipeline as ref_pipeline

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ENTRIES = ("infer_video_depth", "infer_video_depth_streaming")
PIPELINE_KEYS = {"quant"}   # VideoDepthPipeline's options a traffic file sets
# Every key a file may hold; the harness refuses any other, so that no
# option is silently left out of a run.
CONFIG_KEYS = {"name", "source", "model", "encoder", "embed_dim", "depth", "num_heads",
               "mlp_ratio", "patch_size", "img_size", "taps", "features", "out_channels",
               "motion_heads", "num_frames", "dtype", "metric", "ffn_layer", "reduced",
               "assumed"}
TRAFFIC_KEYS = {"name", "mode", "source_hw", "pool_frames", "scene", "clip_frames", "lengths",
                "warmup_lengths", "input_size", "windows_per_batch", "clients", "profile_s",
                "entry", "pipeline"}
CHECK_KEYS = {"clips", "from_first"}


def validate(cell) -> None:
    """Refuses a cell whose files hold a key or a value this mode does not
    run."""
    tr = cell.traffic
    bad = (set(cell.config) - CONFIG_KEYS) | (set(tr) - TRAFFIC_KEYS) \
        | (set(tr.get("pipeline", {})) - PIPELINE_KEYS) | (set(cell.workload["check"]) - CHECK_KEYS)
    if bad:
        raise ValueError(f"{cell.name}: keys the infer harness does not take: {sorted(bad)}")
    if tr.get("entry", ENTRIES[0]) not in ENTRIES or tr["clients"] != 1 \
            or cell.config["dtype"] not in DTYPES:
        raise ValueError(f"{cell.name}: entry {tr.get('entry')!r}, clients {tr['clients']}, "
                         f"dtype {cell.config['dtype']!r}: the harness runs {ENTRIES}, "
                         f"one client, {sorted(DTYPES)}")
    if cell.config.get("ffn_layer", "mlp") not in ref_model.FFN_LAYERS:
        raise ValueError(f"{cell.name}: ffn_layer {cell.config['ffn_layer']!r}: the harness "
                         f"runs {sorted(ref_model.FFN_LAYERS)}")


def port_config(config: dict):
    """The program's ModelConfig for a configuration file."""
    from video_depth_anything_torch.config import ModelConfig, ViTConfig

    vit = ViTConfig(embed_dim=config["embed_dim"], depth=config["depth"],
                    num_heads=config["num_heads"], mlp_ratio=config["mlp_ratio"],
                    patch_size=config["patch_size"], img_size=config["img_size"],
                    ffn_layer=config.get("ffn_layer", "mlp"))
    return ModelConfig(encoder=config["encoder"], features=config["features"],
                       out_channels=tuple(config["out_channels"]),
                       num_frames=config["num_frames"],
                       num_attention_heads=config["motion_heads"],
                       taps=tuple(config["taps"]), metric=config.get("metric", False),
                       vit_override=vit)


def reference_shapes(config: dict):
    with torch.device("meta"):
        return ref_model.VideoDepthAnything(config)


def program_model(config: dict, sd: dict, device):
    """The program's model with the state dict loaded strictly."""
    from video_depth_anything_torch.models.video_depth import VideoDepthAnything

    with torch.device("meta"):
        model = VideoDepthAnything(port_config(config))
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval().requires_grad_(False)


def reference_model(config: dict, sd: dict, device):
    model = reference_shapes(config).to_empty(device=device)
    model.load_state_dict({k: v.to(device, torch.float32) for k, v in sd.items()}, strict=True)
    return model.eval().requires_grad_(False)


class Probes:
    """CUDA events around the encoder's ``encode`` (the model instance's)
    and the head's forward (hooks), with the frames and windows of each
    call, kept apart by ``phase`` ("window" or "profile")."""

    def __init__(self, model):
        self.phase = "window"
        self.calls = {"encode": [], "head": []}    # (phase, start, end, count)
        orig = model.encode

        def encode(x):
            start, end = self._event(), self._event()
            start.record()
            out = orig(x)
            end.record()
            self.calls["encode"].append((self.phase, start, end, x.shape[0]))
            return out

        model.encode = encode
        self._pending = None

        def pre(_, args):
            self._pending = self._event()
            self._pending.record()

        def post(_, args, out):
            end = self._event()
            end.record()
            self.calls["head"].append((self.phase, self._pending, end, args[3]))

        model.head.register_forward_pre_hook(pre)
        model.head.register_forward_hook(post)

    @staticmethod
    def _event():
        return torch.cuda.Event(enable_timing=True)

    def totals(self, kind: str, phase: str = "window") -> tuple[float, int]:
        rows = [c for c in self.calls[kind] if c[0] == phase]
        return (sum(s.elapsed_time(e) for _, s, e, _ in rows) / 1e3, sum(c[3] for c in rows))

    def counts(self, kind: str, phase: str) -> list[int]:
        return [c[3] for c in self.calls[kind] if c[0] == phase]


class Taps:
    """Keeps, for the clip it is ``armed`` with, the taps that the model's
    ``encode`` returned for rows ``ROWS`` of the clip's first call (the
    first window's frames ``ROWS``) and ``BlockIO``'s rows of ``blocks``:
    copies on the device, so the window pays no transfer."""

    ROWS = (0, 10, 21, 31)

    def __init__(self, model, blocks=()):
        self.armed, self.kept, self.blocks = None, {}, {}
        io = BlockIO(model, blocks)
        orig = model.encode

        def encode(x):
            first = self.armed is not None and self.armed not in self.kept
            io.on, io.kept = first, {}
            out = orig(x)
            io.on = False
            if first:
                rows = torch.tensor([min(r, x.shape[0] - 1) for r in self.ROWS], device=x.device)
                self.kept[self.armed] = [(t.index_select(0, rows), c.index_select(0, rows))
                                         for t, c in out]
                self.blocks[self.armed] = io.kept
            return out

        model.encode = encode

    def host(self) -> tuple[dict, dict]:
        """(taps, block rows) of every clip kept, in host memory."""
        return ({o: [(t.cpu(), c.cpu()) for t, c in v] for o, v in self.kept.items()},
                {o: {n: (i.cpu(), x.cpu()) for n, (i, x) in v.items()}
                 for o, v in self.blocks.items()})

    @classmethod
    def frames(cls, n: int) -> list[int]:
        """The clip's frames whose taps are kept (a clip under 32 frames
        pads its window with its last)."""
        return [min(r, n - 1) for r in cls.ROWS]


class BlockIO:
    """Keeps rows ``ROWS`` of the input and the output of the attention and
    the MLP of the encoder's blocks ``blocks`` (forward hooks on
    ``model.pretrained.blocks[b].attn`` and ``.mlp``) in the first call
    while ``on``: the first frame of a clip's first window. The
    reference's module on the same input then tells each branch's own
    error (``check.branch_errs_pct``), which the bf16 rounding of the
    residual stream, shared by every precision, does not hide."""

    ROWS = (0,)

    def __init__(self, model, blocks):
        self.on, self.kept = False, {}
        for b in blocks:
            for part in ("attn", "mlp"):
                name = f"blocks.{b}.{part}"
                model.pretrained.get_submodule(name).register_forward_hook(self._hook(name))

    def _hook(self, name):
        def keep(_, args, out):
            if self.on and name not in self.kept:
                rows = torch.tensor([min(r, out.shape[0] - 1) for r in self.ROWS],
                                    device=out.device)
                self.kept[name] = (args[0].index_select(0, rows), out.index_select(0, rows))
        return keep


def served_model(pipe, tr: dict, dtype):
    """The model instance the pipeline runs (after a first call)."""
    if pipe.quant == "int8":
        net_hw = ref_pipeline.network_size(*tr["source_hw"], tr["input_size"])
        return pipe.quantized_model(None, net_hw, dtype)
    return pipe.model_in(dtype)


def call(pipe, frames, tr: dict, kw: dict, timings: bool = False):
    """One clip through the traffic's entry -> depth [N, H, W] float32."""
    if tr.get("entry", ENTRIES[0]) == "infer_video_depth":
        return pipe.infer_video_depth(frames, collect_timings=timings, **kw)[0]
    return np.concatenate(list(pipe.infer_video_depth_streaming(iter(frames), **kw)))


def _device_allocs() -> tuple[int, int]:
    """cudaMalloc and cudaFree calls of PyTorch's caching allocator so far."""
    if not torch.cuda.is_available():
        return 0, 0
    st = torch.cuda.memory_stats()
    return st.get("num_device_alloc", 0), st.get("num_device_free", 0)


class HostUse:
    """The process's CPU time and the allocator's cudaMalloc and cudaFree
    calls since it was made, printed beside the window: whether the host
    paced it, and whether memory was still being reserved in it."""

    def __init__(self):
        self.t, self.cpu, self.a = time.perf_counter(), time.process_time(), _device_allocs()

    def since(self) -> str:
        cpu = (time.process_time() - self.cpu) / (time.perf_counter() - self.t)
        allocs = " / ".join(str(b - a) for a, b in zip(self.a, _device_allocs()))
        return f"cpu {cpu:.3f} of wall; cudaMalloc / cudaFree {allocs}"


def _p90(values: list[float]) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def run(cell, seed: int, seconds: float, trace: bool, device, setup_clock) -> dict:
    """One run of the cell -> the result (without the import check)."""
    from video_depth_anything_torch.pipeline.infer import VideoDepthPipeline

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = DTYPES[cfg["dtype"]]
    sd = weights.state_dict(reference_shapes(cfg), seed, dev, dtype)
    model = program_model(cfg, sd, dev)
    sd = {k: v.cpu() for k, v in sd.items()}
    pipe = VideoDepthPipeline(port_config(cfg), model, device=dev, **tr.get("pipeline", {}))
    pool = traffic.frame_pool(tr, seed, dev)
    kw = dict(input_size=tr["input_size"], windows_per_batch=tr["windows_per_batch"],
              fp32=dtype == torch.float32)
    spans_on = trace and tr.get("entry", ENTRIES[0]) == "infer_video_depth"
    for n in tr["warmup_lengths"]:
        call(pipe, pool[:n], tr, kw)
    taps = Taps(served_model(pipe, tr, dtype), cfg["taps"])
    probes = Probes(served_model(pipe, tr, dtype)) if trace and cuda else None
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = setup_clock()

    sample = traffic.check_sample(cell.workload, seed)
    kept, lat, frames, attempted, failed = {}, [], 0, 0, 0
    spans = {"window_forward": 0.0, "clip_wall": 0.0}
    schedule = traffic.cycles(tr, seed)
    host = HostUse()
    t0 = time.perf_counter()
    t_end = t0
    while time.perf_counter() < t0 + seconds and not failed:
        for ordinal, start, n in next(schedule):   # a window is whole cycles
            attempted += 1
            taps.armed = ordinal if ordinal in sample else None
            ts = time.perf_counter()
            try:
                depth = call(pipe, pool[start:start + n], tr, kw, spans_on)
            except Exception as e:   # a clip that fails counts; the run stops there
                print(f"clip {ordinal} ({n} frames) failed: {e!r}", file=sys.stderr)
                failed += 1
                break
            t_end = time.perf_counter()
            lat.append(t_end - ts)
            frames += n
            if spans_on:
                spans["window_forward"] += pipe.timer.summary()["window_forward"]["total_ms"] / 1e3
                spans["clip_wall"] += t_end - ts
            if ordinal in sample:
                kept[ordinal] = (start, n, depth)
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    while not failed and not sample <= set(kept):   # the sampled clips the window did not reach
        for ordinal, start, n in next(schedule):
            if ordinal in sample:
                taps.armed = ordinal
                kept[ordinal] = (start, n, call(pipe, pool[start:start + n], tr, kw))
    taps.armed = None

    print(f"window: {len(lat)} clips, {frames} frames in {window_s:.3f} s; latency min / median "
          f"/ max {min(lat, default=0):.4f} / {statistics.median(lat or [0]):.4f} / "
          f"{max(lat, default=0):.4f} s; host {host.since()}", file=sys.stderr)
    e2e = {"setup_s": setup_s, "frames_per_s": frames / window_s if window_s > 0 else 0.0,
           "peak_mem_gib": peak / 2**30}
    if len(lat) >= 2:
        e2e["clip_latency_p90_s"] = _p90(lat)

    ctx = None
    if trace:
        ctx = _profile_span(pipe, probes, schedule, pool, kw, cell, cuda)
        ctx.update(window_s=window_s, frames=frames, clips=len(lat),
                   spans=spans if spans_on else None)
        if probes is not None:
            torch.cuda.synchronize(dev)
            ctx["encode"] = probes.totals("encode")
            ctx["head"] = probes.totals("head")

    del pipe, model, probes
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept_taps, kept_blocks = taps.host()
    del taps
    numbers = compare(cfg, sd, pool, kept, kept_taps, kept_blocks, sample, tr["input_size"],
                      dev)
    return {"attempted": attempted, "failed": failed, "e2e": e2e, "ctx": ctx,
            "numbers": numbers, "peak": max(peak, setup_peak) if cuda else 0}


def _profile_span(pipe, probes, schedule, pool, kw, cell, cuda) -> dict:
    """A few more clips (at least ``profile_s`` seconds) under
    torch.profiler -> the per-layer metrics' context."""
    cfg, tr = cell.config, cell.traffic
    net_hw = ref_pipeline.network_size(*tr["source_hw"], tr["input_size"])
    p = cfg["patch_size"]
    ctx = {"config": cfg, "traffic": tr, "net_hw": net_hw, "ph": net_hw[0] // p,
           "pw": net_hw[1] // p, "profile": None}
    if not cuda:
        return ctx
    probes.phase = "profile"
    torch.cuda.synchronize()
    with trace_mod.profiled() as prof:
        with torch.profiler.record_function("vdabench.span"):
            t0 = time.perf_counter()
            for _, start, n in itertools.chain.from_iterable(schedule):
                call(pipe, pool[start:start + n], tr, kw)
                if time.perf_counter() > t0 + tr["profile_s"]:
                    break
            torch.cuda.synchronize()
    profile = trace_mod.read(prof)
    profile.calls = {"encode_frames": probes.counts("encode", "profile"),
                     "head_windows": probes.counts("head", "profile")}
    probes.phase = "window"
    ctx["profile"] = profile
    return ctx


def compare(cfg, sd, pool, kept, kept_taps, kept_blocks, sample, input_size, dev) -> dict:
    """The check's numbers over the sampled clips; a sampled clip that
    never came back gives NaN."""
    if any(o not in kept or o not in kept_taps for o in sample):
        return {k: float("nan") for k in check.NAMES}
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference_model(cfg, sd, dev)
        per_clip = []
        for o in sorted(kept):
            start, n, depth = kept[o]
            frames = torch.from_numpy(pool[start:start + n]).to(dev)
            want = ref_pipeline.infer_video_depth(ref, frames, input_size,
                                                  metric=cfg.get("metric", False))
            nums = check.clip_numbers(torch.from_numpy(depth).to(dev), want)
            del want
            rows = frames[Taps.frames(n)]
            want_taps = ref.encode(ref_pipeline.preprocess(rows, ref_pipeline.network_size(
                *frames.shape[1:3], input_size)))
            nums["tap_err_pct"] = check.tap_err_pct(kept_taps[o], want_taps)
            nums["branch_err_pct"] = max(check.branch_errs_pct(kept_blocks[o], ref).values())
            per_clip.append(nums)
            del frames, want_taps
        return check.worst(per_clip)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
