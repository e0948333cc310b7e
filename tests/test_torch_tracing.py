"""The port's spans (``utils/profiling.py``) on the CPU, on the toy model of
test_torch_streaming.py (ViTConfig(64, depth 2, 2 heads), features 32,
taps 0, 0, 1, 1) with seeded random weights, 42x56 frames at input 28.

Off, a span opens nothing: no ``record_function``, no CUDA event, no
clock or allocator read. On (under ``torch.profiler``, in
``collecting()``, with ``collect_timings=True`` or ``phase=``) the outputs,
the train step's update and the kernels' launch counts are those of a run
with tracing off, bit for bit; the ranges nest on the thread that opened
them; the totals count what the call did; and an export traced inside
both sinks records the graph an untraced export does.
"""
import copy
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_depth_anything_torch import kernels
from video_depth_anything_torch.config import ModelConfig, ViTConfig
from video_depth_anything_torch.models.video_depth import build_model
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.training import train_state as ts
from video_depth_anything_torch.utils import profiling
from video_depth_anything_torch.utils import serving_export as se
from video_depth_anything_torch.utils.precision import synthetic_video

INPUT = 28
HW = (42, 56)
CFG = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2),
                  features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
TC = ts.TrainConfig(clip_len=4, compute_dtype="float32", epochs=2, steps_per_epoch=5)
PHASES = ["encoder", "head", "backward", "optimizer", "end"]
# (windows_per_batch, cache_keyframe_features): the sequential cache, the
# batched cache (chunks of 2, 2 and 1 windows on 100 frames), plain windows
MODES = [(1, True), (2, True), (2, False)]
PIPELINE_SPANS = {"vda.clip", "vda.pipeline.setup", "vda.pipeline.chunk",
                  "vda.pipeline.gather_upload", "vda.pipeline.upload",
                  "vda.pipeline.preprocess", "vda.pipeline.resize", "vda.pipeline.stitch",
                  "vda.pipeline.wait", "vda.pipeline.download", "vda.pipeline.fetch",
                  "vda.pipeline.copy_out"}
MODEL_SPANS = {"vda.encoder", "vda.encoder.embed", "vda.encoder.norm1", "vda.encoder.attn",
               "vda.encoder.norm2", "vda.encoder.mlp", "vda.encoder.final_norm", "vda.head",
               "vda.head.project", "vda.head.rn", "vda.head.output",
               *(f"vda.head.motion{i}" for i in range(4)),
               *(f"vda.head.refinenet{i}" for i in range(1, 5))}
TRAIN_SPANS = {"vda.train.step", "vda.train.inputs", "vda.train.loss", "vda.train.backward",
               "vda.train.grad_fill", "vda.train.optimizer"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def pipe():
    return VideoDepthPipeline(CFG, build_model(CFG, seed=0), device="cpu")


@pytest.fixture(scope="module")
def video():
    return synthetic_video(n=100, hw=HW, seed=6)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    video = torch.rand(1, TC.clip_len, 42, 42, 3, generator=g)
    return {"video": (video - 0.45) / 0.22, "gt": torch.sigmoid(2 * video.mean(-1)),
            "mask": torch.ones(1, TC.clip_len, 42, 42)}


@pytest.fixture(scope="module")
def state():
    return ts.create_train_state(build_model(CFG, seed=1), TC)


def _infer(pipe, video, mode, **kw):
    c, cache = mode
    kernels.reset_launch_counts()
    out, _ = pipe.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=c,
                                    cache_keyframe_features=cache, **kw)
    return out, kernels.launch_counts()


def _step(state, **kw):
    """A copy of ``state`` one step on -> (its head, the loss, launches)."""
    s = copy.deepcopy(state)
    kernels.reset_launch_counts()
    s, m = ts.train_step(s, _batch(), CFG, TC, **kw)
    return {k: v.detach().clone() for k, v in s.head.items()}, m["loss"], kernels.launch_counts()


def _raise(*a, **k):
    raise AssertionError("tracing is off: nothing may be opened or read")


class _NoClock:
    perf_counter = staticmethod(_raise)


def test_off_a_span_opens_nothing(pipe, video, state, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", _raise)
    monkeypatch.setattr(torch.cuda, "memory_stats", _raise)
    monkeypatch.setattr(profiling, "time", _NoClock)
    assert profiling.span("vda.a") is profiling.span("vda.b", device=True, mallocs=True)
    out, _ = _infer(pipe, video[:50], (2, True))
    assert out.shape == (50, *HW)
    assert np.concatenate(list(pipe.infer_video_depth_streaming(
        iter(video[:30]), input_size=INPUT, fp32=True))).shape == (30, *HW)
    _step(state)
    assert profiling.totals() == {}


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_outputs_and_launches_equal_with_tracing_on(pipe, video, mode):
    want = _infer(pipe, video, mode)
    timed = _infer(pipe, video, mode, collect_timings=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.collecting():
            traced = _infer(pipe, video, mode)
    for got in (timed, traced):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_train_step_equal_with_tracing_on(state):
    head, loss, launches = _step(state)
    called = []
    for kw in ({"phase": called.append}, {}):
        with profile(activities=[ProfilerActivity.CPU]):
            got_head, got_loss, got_launches = _step(state, **kw)
        assert torch.equal(got_loss, loss) and got_launches == launches
        assert all(torch.equal(got_head[k], head[k]) for k in head)
    assert called == PHASES


def _ranges(prof):
    return [e for e in prof.events() if e.name.startswith("vda.")]


def _parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("vda."):
        p = p.cpu_parent
    return p


def _check_nesting(evs, root):
    for ev in evs:
        parent = _parent(ev)
        if ev.name == root:
            assert parent is None
            continue
        assert parent is not None, ev.name
        assert parent.thread == ev.thread
        assert parent.time_range.start <= ev.time_range.start
        assert ev.time_range.end <= parent.time_range.end


def test_pipeline_ranges_nest_under_the_profiler(pipe, video):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for mode in MODES:
            _infer(pipe, video, mode)
    evs = _ranges(prof)
    assert {e.name for e in evs} == PIPELINE_SPANS | MODEL_SPANS
    assert sum(e.name == "vda.clip" for e in evs) == len(MODES)
    _check_nesting(evs, "vda.clip")
    by_name = {e.name: _parent(e).name for e in evs if e.name != "vda.clip"}
    assert by_name["vda.encoder.attn"] == "vda.encoder"
    assert by_name["vda.head.motion2"] == "vda.head"
    assert by_name["vda.pipeline.gather_upload"] == "vda.pipeline.chunk"
    assert by_name["vda.pipeline.copy_out"] == "vda.clip"
    assert by_name["vda.pipeline.wait"] == "vda.pipeline.stitch"   # the fade weights' copy


def test_train_ranges_nest_under_the_profiler(state):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(state)
        _step(state)
    evs = _ranges(prof)
    assert {e.name for e in evs} == TRAIN_SPANS | MODEL_SPANS
    assert sum(e.name == "vda.train.step" for e in evs) == 2
    _check_nesting(evs, "vda.train.step")


def test_totals_count_the_call(pipe, video):
    _infer(pipe, video, (2, True), collect_timings=True)
    t = profiling.totals()
    assert t["vda.clip"]["count"] == 1
    assert t["vda.clip"]["counters"] == {"frames": 100}
    assert t["vda.pipeline.chunk"]["count"] == 3      # chunks of 2, 2 and 1 windows
    assert t["vda.head"]["count"] == 3 and t["vda.head"]["counters"] == {}
    assert t["vda.pipeline.wait"]["count"] == 4       # each window's stitch after the first
    assert t["vda.encoder"]["counters"]["frames"] == 100    # each frame encoded once
    for name, row in t.items():
        assert 0 <= row["self_s"] <= row["host_s"], name
        assert row["device_s"] == 0.0, name               # no card: no device interval
    chunk = t["vda.pipeline.chunk"]
    assert chunk["self_s"] < chunk["host_s"] - t["vda.encoder"]["host_s"] + 1e-9
    summary = pipe.timer.summary()
    assert summary["window_forward"]["count"] == 3
    assert summary["window_forward"]["total_ms"] == pytest.approx(1e3 * chunk["host_s"])
    # A call without collect_timings adds nothing.
    _infer(pipe, video, (2, True))
    assert profiling.totals()["vda.clip"]["count"] == 1


def test_totals_of_a_stream_and_of_train_steps(pipe, video, state):
    with profiling.collecting():
        parts = list(pipe.infer_video_depth_streaming(iter(video[:60]), input_size=INPUT,
                                                      fp32=True, windows_per_batch=2))
    assert sum(len(p) for p in parts) == 60
    t = profiling.totals()
    assert t["vda.clip"]["counters"] == {"frames": 60}
    assert t["vda.pipeline.chunk"]["count"] == 2      # 3 windows in chunks of 2 and 1
    profiling.reset()
    for _ in range(2):
        _step(state, phase=lambda _: None)
    t = profiling.totals()
    assert set(t) == TRAIN_SPANS | MODEL_SPANS
    assert t["vda.train.step"]["count"] == 2 and t["vda.train.step"]["counters"] == {}
    assert t["vda.encoder"]["counters"]["frames"] == 2 * TC.clip_len


def test_self_time_leaves_out_the_children_and_a_left_generator():
    with profiling.collecting():
        with profiling.span("vda.t.outer"):
            time.sleep(0.02)
            with profiling.span("vda.t.wait"):
                time.sleep(0.05)

        def stream():
            with profiling.span("vda.t.stream"):
                yield 1
                yield 2

        it = stream()
        next(it)
        with profiling.span("vda.t.after"):
            pass
        del it                    # closed while open: its span leaves the stack
        with profiling.span("vda.t.last"):
            pass
    t = profiling.totals()
    outer, wait = t["vda.t.outer"], t["vda.t.wait"]
    assert outer["host_s"] >= outer["self_s"] + wait["host_s"] - 1e-6
    assert wait["host_s"] >= 0.05 > outer["self_s"] >= 0.02
    assert t["vda.t.stream"]["count"] == 1
    assert profiling._TRACER.stack() == []


def test_an_export_inside_both_sinks_records_the_same_graph():
    plain = se.op_counts(se.export_window_program(CFG, HW, input_size=INPUT, fp32=True,
                                                  device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]), profiling.collecting():
        traced = se.export_window_program(CFG, HW, input_size=INPUT, fp32=True, device="cpu")
    assert se.op_counts(traced) == plain
    assert not any("record_function" in k or "profiler" in k for k in plain)
    assert profiling.totals() == {}
