"""Tracing and timing hooks (the port's copy of the JAX package's
``utils/profiling.py``).

- ``WindowTimer``: per-span wall-clock statistics (count, mean, p50, p95,
  total) of the pipeline's chunks, ``VideoDepthPipeline.infer_video_depth(
  collect_timings=True)``. The pipeline synchronises the card at the end of
  each ``window_forward`` span, so a span holds the chunk's device time.
- ``trace(log_dir)``: a ``torch.profiler`` run of the block (CPU and, where
  present, CUDA activity) written to ``log_dir`` as a Chrome trace, which
  Perfetto and ``chrome://tracing`` open; a no-op for ``None``
  (``run.py --profile_dir``).
"""
from __future__ import annotations

import contextlib
import os
import time


class WindowTimer:
    def __init__(self):
        self.samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append(time.perf_counter() - t0)

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


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the block into ``log_dir/trace.json``; no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
