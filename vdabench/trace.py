"""Reading a torch.profiler run: device time by kernel, the busy union of
device activity, and the idle gaps by what the host was doing.

Only the profiler's own events are read (kineto's results, in memory; no
trace file is written). A device event is a kernel, a copy or a memset;
the busy time is the union of their intervals, so a copy that overlaps a
kernel counts once. A gap is a stretch with no device activity; it is
named by the innermost host event (an ATen op, a CUDA runtime call or a
``record_function`` range of the benchmark) that spans its midpoint.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class Profile:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)    # name -> [seconds, count]
    gaps: dict = dataclasses.field(default_factory=dict)       # host activity -> seconds
    calls: dict = dataclasses.field(default_factory=dict)      # counters of the span

    def kernel_s(self, patterns) -> float:
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(p in name for p in patterns))

    def breakdown(self, top: int = 10, width: int = 160) -> dict:
        """The ``top`` device operations by time and idle gaps by host
        activity, names cut to ``width`` characters."""
        ops = sorted(((n, s) for n, (s, _) in self.kernels.items()), key=lambda r: -r[1])
        gaps = sorted(self.gaps.items(), key=lambda r: -r[1])
        return {"device_ops": [[n[:width], s] for n, s in ops[:top]],
                "idle_gaps": [[n[:width], s] for n, s in gaps[:top]]}


def _events(prof):
    return prof.profiler.kineto_results.events()


def _annotation(ev) -> bool:
    """A ``record_function`` range mirrored onto the device's timeline: no
    device work."""
    return ev.name().startswith("vdabench.") or getattr(ev, "is_user_annotation", bool)()


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def read(prof) -> Profile:
    """The Profile of the events inside the benchmark's
    ``record_function("vdabench.span")`` range."""
    dev, host, span = [], [], None
    for ev in _events(prof):
        start = ev.start_ns()
        end = ev.end_ns()
        if _is_device(ev):
            if not _annotation(ev):
                dev.append((start, end, ev.name()))
        elif ev.name() == "vdabench.span":
            span = (start, end)
        else:
            host.append((start, end, ev.name()))
    if span is None:
        raise RuntimeError("the profiled span's range was not recorded")
    lo, hi = span
    prof_out = Profile(window_s=(hi - lo) / 1e9)
    dev = sorted((max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi)
    busy, cur_s, cur_e, gaps = 0, None, None, []
    for s, e, name in dev:
        k = prof_out.kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > lo:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < hi:
            gaps.append((cur_e, hi))
    prof_out.busy_s = busy / 1e9
    host.sort()
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        label, best = "host: Python or NumPy (no traced op)", None
        for s, e, name in reversed(host[max(0, i - 2000):i]):
            if e >= mid and (best is None or s > best):
                label, best = name, s
        prof_out.gaps[label] = prof_out.gaps.get(label, 0.0) + (g1 - g0) / 1e9
    return prof_out


@contextlib.contextmanager
def profiled():
    """A torch.profiler run of CPU and CUDA activity; the benchmark marks
    its span inside with ``torch.profiler.record_function("vdabench.span")``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
