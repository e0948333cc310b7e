"""The per-layer metrics that read the program's spans
(``video_depth_anything_torch/utils/profiling.py``), each on a fabricated
context: a profiled span with named gaps, and the program's totals
replaced by a fixed table. Each reads None without a profiled span (a run
on the CPU), and where the program has no spans (a program before them)."""
from __future__ import annotations

import types

import pytest

from vdabench import spec
from vdabench.trace import Profile
from video_depth_anything_torch.utils import profiling

UNNAMED = "host: Python or NumPy (no traced op)"
GAPS = {"vda.pipeline.upload": 0.30, "vda.pipeline.copy_out": 0.20, "vda.clip": 0.05,
        "vda.train.optimizer": 0.10, "vda.head.motion2": 0.05, "vda::temporal_attention": 0.07,
        "aten::mm": 0.04, UNNAMED: 0.19}


def _row(count=1, host=0.0, self_s=None, device=0.0, **counters):
    return {"count": count, "host_s": host, "self_s": host if self_s is None else self_s,
            "device_s": device, "counters": counters}


TOTALS = {
    "vda.clip": _row(2, host=4.0, self_s=0.1, frames=400, cuda_mallocs=6),
    "vda.pipeline.chunk": _row(19, host=3.0, self_s=0.2, device=3.5, cuda_mallocs=4),
    "vda.pipeline.upload": _row(20, host=0.4, self_s=0.3, cuda_mallocs=1),
    "vda.pipeline.wait": _row(5, host=0.1),
    "vda.pipeline.copy_out": _row(19, host=0.2),
    "vda.encoder": _row(19, host=1.0, self_s=0.05, device=1.6, frames=320),
    "vda.encoder.attn": _row(456, host=0.5),
    "vda.head": _row(19, host=1.5, self_s=0.1, device=1.9),
    "vda.train.step": _row(10, host=1.2, self_s=0.2),
    "vda.train.backward": _row(10, host=0.3, device=0.45),
}


def _read(name, profile=True, totals=TOTALS, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(profiling, "totals", lambda: totals)
    prof = Profile(window_s=2.0, busy_s=1.0, gaps=dict(GAPS)) if profile else None
    return spec.metric_reader(name)(types.SimpleNamespace(profile=prof))


@pytest.mark.parametrize("name, want", [
    ("pipeline.idle_share", 100 * 0.55 / 2.0),
    ("pipeline.idle_share.short", 100 * 0.55 / 2.0),
    ("train.idle_share", 100 * 0.70 / 2.0),     # every vda. range, no vda:: op
    ("pipeline.host_ms_per_frame", 1e3 * (0.1 + 0.2 + 0.3 + 0.2) / 400),   # no wait
    ("pipeline.host_ms_per_frame.short", 1e3 * 0.8 / 400),
    ("model.encoder_span_ms_per_frame", 1e3 * 1.6 / 320),
    ("model.encoder_span_ms_per_frame.short", 1e3 * 1.6 / 320),
    ("model.head_span_ms_per_frame", 1e3 * 1.9 / 400),
    ("model.head_span_ms_per_frame.short", 1e3 * 1.9 / 400),
    ("device.cuda_mallocs_per_clip", 3.0),
    ("device.cuda_mallocs_per_clip.short", 3.0),
    ("train.backward_span_ms", 45.0),
])
def test_a_span_metric_reads_its_spans(name, want, monkeypatch):
    assert _read(name, monkeypatch=monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "pipeline.idle_share", "train.idle_share", "pipeline.host_ms_per_frame",
    "model.encoder_span_ms_per_frame", "model.head_span_ms_per_frame",
    "device.cuda_mallocs_per_clip", "train.backward_span_ms"])
def test_without_a_profiled_span_or_the_programs_spans_nothing_is_read(name, monkeypatch):
    assert _read(name, profile=False, monkeypatch=monkeypatch) is None
    monkeypatch.delattr(profiling, "span")
    monkeypatch.delattr(profiling, "totals")
    assert _read(name) is None


@pytest.mark.parametrize("name", [
    "pipeline.host_ms_per_frame", "model.encoder_span_ms_per_frame",
    "model.head_span_ms_per_frame", "device.cuda_mallocs_per_clip",
    "train.backward_span_ms"])
def test_empty_totals_read_nothing(name, monkeypatch):
    """The CPU's totals: no device interval, no allocator counter; or none."""
    cpu = {k: dict(v, device_s=0.0, counters={c: n for c, n in v["counters"].items()
                                              if c != "cuda_mallocs"})
           for k, v in TOTALS.items()}
    for totals in ({}, cpu):
        got = _read(name, totals=totals, monkeypatch=monkeypatch)
        assert got is None or (totals and name == "pipeline.host_ms_per_frame"), (name, got)
