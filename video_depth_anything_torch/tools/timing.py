"""Card timing and the card's peak rates, shared by the port's bench tools
and chip_smoke.py.

``bound_ms`` is the least time the card could take for some work: the
larger of its operations at the published peak for their type and its
bytes at the HBM rate. ``exp_ms`` is the exponentials' own time at the
special-function rate, stated beside an attention kernel's bound (at
dh = 64 it equals the tensor-core term) but not part of it.

``time_ms`` is the mean of a run of launches between two CUDA events;
``best_ms`` the best of several such runs.
``marginal_ms`` is the port of the chain timing of the JAX package's
``tools/bench_kernel_phases.py`` and ``tools/bench_kernel_ab.py``
(``chain_fn`` / ``timed`` / ``_once``): it times a chain of c1 calls and
one of c2 calls and returns (t2 - t1) / (c2 - c1), which cancels what a
chain costs once (the event records, the first launch's latency). The
chains are sized so that the marginal work between them is about
``margin_s`` of card time. The JAX chains add ``acc * 1e-12`` of each
call's output to the next call's input, only so that XLA cannot hoist
the call out of its loop; launches on one stream run in order and each
runs in full, so the port calls ``fn`` on the same inputs.

Every time these tools take is warm in the card's 50 MB L2 cache, or
partly warm: the same inputs are read call after call. A QK probe's q and
k together are 46 MB, about the size of L2; a tool's report says so
beside its numbers.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

TARGET_MARGIN_S = 0.25   # the JAX tools' marginal card time per timing
ITERS = 5                # chain timings per length; the median is kept

# NVIDIA H100 SXM, published dense rates at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12,   # tensor cores
            "int8": 1979e12,      # tensor cores
            "float32": 67e12}     # outside the tensor cores (no TF32)
# Exponentials per second on the special-function units: 16 ex2 results
# per SM and clock (CUDA programming guide, throughput table, compute
# capability 9.0) at 132 SMs and the 1.98 GHz maximum clock.
# FlashAttention-3 (Shah et al., 2024) quotes 3.9 TFLOPS of special
# functions on the H100 SXM5, the same rate at a lower clock.
EXP_PER_S = 16 * 132 * 1.98e9


def bound_ms(ops: float, nbytes: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of ``ops`` at the peak
    rate of ``dtype`` and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def exp_ms(n_exps: float) -> float:
    """The time of ``n_exps`` exponentials at the special-function rate."""
    return n_exps / EXP_PER_S * 1e3


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them (the
    published peaks assume 700 W), or torch's name of it without nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def best_ms(fn, chain: int, iters: int, graph: bool = False) -> float:
    """The best of ``iters`` timings of a chain of ``chain`` calls, in ms
    per call, after one call outside them: the JAX stage tools' best of
    ITERS chains. With ``graph``, the chain is captured once into a CUDA
    graph and each timing replays it (for calls shorter than the host's
    cost of launching them)."""
    fn()
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(chain):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(chain):
                fn()
    return min(_timed_ms(run) for _ in range(iters)) / chain


def chain_lengths(est_call_ms: float, margin_s: float = TARGET_MARGIN_S) -> tuple[int, int]:
    """(c1, c2) as the JAX tools size them for a call of about est_call_ms."""
    calls = margin_s * 1e3 / est_call_ms
    c1 = max(4, int(calls / 8))
    return c1, c1 + max(8, int(calls))


def _timed_ms(run) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def marginal_ms(fn, *args, est_call_ms: float, margin_s: float = TARGET_MARGIN_S,
                graph: bool = False) -> float:
    """Marginal ms per call of ``fn(*args)``: the medians of ITERS timings
    of a c1-call and a c2-call chain, (t2 - t1) / (c2 - c1). With
    ``graph``, each chain is captured once into a CUDA graph and the
    timings replay it: for calls that take about as long as the host needs
    to launch them through a wrapper, which a chain of launches would time
    instead."""
    c1, c2 = chain_lengths(est_call_ms, margin_s)
    for _ in range(2):
        fn(*args)
    times = []
    for n in (c1, c2):
        if graph:
            chain = torch.cuda.CUDAGraph()
            with torch.cuda.graph(chain):
                for _ in range(n):
                    fn(*args)
            chain.replay()
            run = chain.replay
        else:
            def run(n=n):
                for _ in range(n):
                    fn(*args)
        times.append(statistics.median(_timed_ms(run) for _ in range(ITERS)))
        del run
    return (times[1] - times[0]) / (c2 - c1)
