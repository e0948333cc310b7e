"""Tracing and timing of the port: named spans at its layer boundaries,
``WindowTimer``, and the ``torch.profiler`` exporter.

``span(name, device=False)`` marks one stage of the program (the table
below) and has two sinks:

- **The timeline.** While a ``torch.profiler`` records
  (``torch._C._autograd._profiler_enabled()``), the span opens
  ``torch.profiler.record_function(name)``: the range sits in kineto's host
  timeline on the clock of the device activity, so an idle gap on the card
  is named by the innermost stage around it, and ``run.py --profile_dir``
  shows stage names. Spans nest: a range's parent is the range around it.
- **The totals.** Inside ``collecting()``, which
  ``infer_video_depth(collect_timings=True)`` and ``train_step(phase=...)``
  enter for the call, the span adds to one in-memory table per process:
  per name the count, host seconds (``host_s``, and ``self_s``: less the
  time of its child spans, from a per-thread stack of open spans), device
  seconds (``device_s``) and ``counters``. Host seconds come from
  ``time.perf_counter``. Device seconds only for a span made with
  ``device=True`` (the caller passes whether its work runs on a card):
  a pair of CUDA events on the current stream, resolved once they have
  completed, never by a synchronise: those done at the end of each
  ``collecting()`` scope (for the pipeline, after the call's last fetch,
  so all of them), the rest in ``totals()``. ``mallocs=True`` adds the
  caching allocator's ``cudaMalloc`` calls across the span to the counter
  ``cuda_mallocs`` (once CUDA is initialised); ``add(**counters)`` on the
  open span adds others. ``totals()`` returns a copy of the table,
  ``reset()`` clears it.

Off (no profiler recording and no ``collecting()``), ``span`` returns one
shared no-op object after its flag checks: no ``record_function``, no event,
no clock or allocator read. It is off as well while ``torch.compile`` or
``torch.export`` traces, so the serving artifact's graph does not change.

The spans (``vda.`` with dots, apart from the custom ops' ``vda::``); each
totals its count and host seconds, and those marked also:

- ``vda.clip``: each ``infer_video_depth`` / ``_streaming`` call, the root;
  counters frames (delivered), cuda_mallocs.
- ``vda.pipeline.setup``: the frames as an array, geometry, window indices,
  the model (int8 calibration included), the output array.
- ``vda.pipeline.chunk``: one chunk's forward and the next chunk's
  ``vda.pipeline.gather_upload`` (its frames read and planned, then
  uploaded); device seconds, cuda_mallocs.
- ``vda.pipeline.upload``: ``HostLink.upload``, the stack into pinned
  memory and the copy enqueued; cuda_mallocs. ``vda.pipeline.wait``: a
  host block on the device (a device event in ``upload`` and ``fetch``;
  the stitch's pageable copy of its fade weights).
- ``vda.pipeline.preprocess``, ``.resize``: ``preprocess_frames``; the
  resize to source with its ReLU.
- ``vda.pipeline.stitch``: the windows stitched, concatenated and cast;
  cuda_mallocs. ``vda.pipeline.download``, ``.fetch``: ``HostLink``'s.
  ``vda.pipeline.copy_out``: a chunk's depths into the output array
  (streaming: its copy).
- ``vda.pipeline.all_gather``: ``DataAxis.gather``'s collective; device
  seconds.
- ``vda.encoder``: ``get_intermediate_layers`` (pipeline and train step);
  device seconds, frames. Its stages ``vda.encoder.embed``, ``.norm1``,
  ``.attn``, ``.norm2``, ``.mlp``, ``.final_norm``; inside ``.mlp``, the
  fused SwiGLU FFN's gate ``vda.encoder.swiglu`` (counter fused: the calls
  that ran kernel K8).
- ``vda.head``: ``DPTHeadTemporal.forward``; device seconds. Its
  stages in order ``vda.head.project``, ``.motion0``, ``.motion1``, ``.rn``,
  ``.refinenet4``, ``.motion2``, ``.refinenet3``, ``.motion3``,
  ``.refinenet2``, ``.refinenet1``, ``.output`` (counter fused: the calls
  whose tail ran kernel K7).
- ``vda.train.step``: ``train_step``, the root. Its stages
  ``vda.train.inputs``, ``.loss``, ``.backward`` (device seconds),
  ``.grad_fill``, ``.all_reduce`` (on a mesh), ``.optimizer``; the
  encoder's and the head's as above.

``WindowTimer``: per-key wall statistics (count, mean, p50, p95, total)
of one ``infer_video_depth(collect_timings=True)`` call, fed by the
spans: ``window_forward`` by ``vda.pipeline.chunk`` (its device interval
on a card, its host time on the CPU), ``gather_upload`` by
``vda.pipeline.gather_upload`` and, on a mesh, ``all_gather`` by
``vda.pipeline.all_gather`` (device on a card). No span synchronises the
card, so the timed call runs as an untimed one does.

``trace(log_dir)``: a ``torch.profiler`` run of the block (CPU and, where
present, CUDA activity) written to ``log_dir`` as a Chrome trace, which
Perfetto and ``chrome://tracing`` open; a no-op for ``None``
(``run.py --profile_dir``).
"""
from __future__ import annotations

import contextlib
import copy
import os
import threading
import time

import torch


class WindowTimer:
    # span name -> key of the summary
    KEYS = {"vda.pipeline.chunk": "window_forward",
            "vda.pipeline.gather_upload": "gather_upload",
            "vda.pipeline.all_gather": "all_gather"}

    def __init__(self):
        self.samples: dict[str, list[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.samples.setdefault(name, []).append(seconds)

    def take(self, span_name: str, seconds: float) -> None:
        """A closed span's seconds, kept under its key (other spans are not
        the timer's)."""
        key = self.KEYS.get(span_name)
        if key is not None:
            self.add(key, seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self.samples.items():
            s = sorted(ts)
            n = len(s)
            out[name] = {
                "count": n,
                "mean_ms": 1000 * sum(s) / n,
                "p50_ms": 1000 * s[n // 2],
                "p95_ms": 1000 * s[min(n - 1, int(0.95 * n))],
                "total_ms": 1000 * sum(s),
            }
        return out


class _Off:
    """The span of the off path: one object, entered and left for nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **counters) -> None:
        pass


_OFF = _Off()


class _Tracer:
    """The process's totals: the table, the device intervals not yet
    resolved, the timers of the open ``collecting()`` scopes, and each
    thread's stack of open spans."""

    def __init__(self):
        self.collecting = 0
        self.timers: list[WindowTimer] = []
        self.table: dict[str, dict] = {}
        self.pending: list = []            # (name, start event, end event, timers)
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack

    def row(self, name: str) -> dict:
        return self.table.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                            "device_s": 0.0, "counters": {}})

    def resolve(self, wait: bool) -> None:
        """Device seconds of the completed intervals (``wait``: of all,
        waiting for each end event)."""
        with self.lock:
            pending, self.pending = self.pending, []
        keep = []
        for name, start, end, timers in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((name, start, end, timers))
                continue
            s = start.elapsed_time(end) / 1e3
            with self.lock:
                self.row(name)["device_s"] += s
            for timer in timers:
                timer.take(name, s)
        with self.lock:
            self.pending[:0] = keep


_TRACER = _Tracer()


class _Span:
    __slots__ = ("name", "device", "mallocs", "rf", "on", "t0", "child", "start", "m0",
                 "counters")

    def __init__(self, name: str, device: bool, mallocs: bool):
        self.name, self.device, self.mallocs = name, device, mallocs
        self.rf = self.start = self.m0 = None
        self.on = False
        self.child = 0.0
        self.counters: dict[str, float] = {}

    def __enter__(self):
        tr = _TRACER
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if tr.collecting:
            self.on = True
            tr.stack().append(self)
            if self.device and not torch.cuda.is_current_stream_capturing():
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            if self.mallocs and torch.cuda.is_initialized():
                self.m0 = torch.cuda.memory_stats_as_nested_dict()["num_device_alloc"]
            self.t0 = time.perf_counter()
        return self

    def add(self, **counters) -> None:
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0) + v

    def __exit__(self, *exc) -> bool:
        if self.on:
            self._close(time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def _close(self, seconds: float) -> None:
        tr = _TRACER
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        if self.m0 is not None:
            self.add(cuda_mallocs=torch.cuda.memory_stats_as_nested_dict()["num_device_alloc"]
                     - self.m0)
        stack = tr.stack()
        for i in range(len(stack) - 1, -1, -1):    # the top, unless a generator was left open
            if stack[i] is self:
                del stack[i]
                break
        if stack:
            stack[-1].child += seconds
        with tr.lock:
            row = tr.row(self.name)
            row["count"] += 1
            row["host_s"] += seconds
            row["self_s"] += seconds - self.child
            for k, v in self.counters.items():
                row["counters"][k] = row["counters"].get(k, 0) + v
            timers = tuple(tr.timers)
            if end is not None:
                tr.pending.append((self.name, self.start, end, timers))
        if end is None:
            for timer in timers:
                timer.take(self.name, seconds)


def span(name: str, device: bool = False, mallocs: bool = False):
    """A context manager marking stage ``name`` (the module docstring lists
    the program's); ``device``: its work runs on a card, so the totals take its
    device interval; ``mallocs``: count ``cudaMalloc`` calls across it."""
    if not _TRACER.collecting and not torch._C._autograd._profiler_enabled():
        return _OFF
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _OFF
    return _Span(name, device, mallocs)


@contextlib.contextmanager
def collecting(timer: WindowTimer | None = None):
    """The totals' sink on for the block; ``timer`` also takes the spans
    of its keys. At the end, the device intervals already completed are
    resolved (with a timer: all of them, the pipeline's last fetch having
    waited for the card)."""
    tr = _TRACER
    with tr.lock:
        tr.collecting += 1
        if timer is not None:
            tr.timers.append(timer)
    try:
        yield
    finally:
        with tr.lock:
            if timer is not None:
                tr.timers.remove(timer)
            tr.collecting -= 1
        tr.resolve(wait=timer is not None)


def totals() -> dict[str, dict]:
    """{span name: {count, host_s, self_s, device_s, counters}} collected
    since the last ``reset()``, every device interval resolved."""
    _TRACER.resolve(wait=True)
    with _TRACER.lock:
        return copy.deepcopy(_TRACER.table)


def reset() -> None:
    with _TRACER.lock:
        _TRACER.table.clear()
        _TRACER.pending.clear()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the block into ``log_dir/trace.json``; no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
