"""Phase probes of the spatial attention kernel: T1 and T3 and their plain
versions.

T1 replaces ``tools/bench_kernel_phases.py::probes`` (Pallas bodies
``_qk_probe_kernel``, ``_qk128_probe_kernel``, ``_sm_probe_kernel``,
``_pv_probe_kernel``), T3 ``tools/bench_kernel_ab.py::probes`` (bodies
``_qk64_probe``, ``_qk128_probe``). Both are measurement kernels: each runs
one phase of K1 (QK, softmax, PV) alone at K1's vitl tile sizes, so the
bench tools (``tools/bench_kernel_phases.py``, ``tools/bench_kernel_ab.py``
of this package) can time it. The CUDA sources, with the notes on their
bounds and designs, are ``csrc/phase_probes.cu`` (T1) and
``csrc/qk_probes.cu`` (T3, a persistent kernel whose wgmma accumulators
are the column-group sums), both on the attention body's wgmma + TMA
machinery. No served path runs them, so they stay plain Python wrappers
and are not ``torch.library`` custom ops (``kernels/__init__.py``).

Every probe works per step on ``[steps, rows, 128]`` operands; "x2" probes
split the 128 columns into two heads of 64:

- T1 ``qk64x2`` / ``qk128``: the first 128 score columns, summed over the
  heads, ``[steps, M, 128]`` in the input dtype. The kernel keeps
  accumulating every later key tile's products; with ``sink=True`` it
  also stores their sums into a scratch buffer (the run that shows no
  product was dropped: its time must match the run without).
- T1 ``qk+sm x2``: per head ``bf16(exp(s - rowmax s))``, its first 128
  columns summed over the heads; with ``side=True`` also the per-row fp32
  sum of every exponential, ``[steps, M]``, which keeps the kernel's
  exponentials live.
- T1 ``pv128x2``: ``p v + p2 v`` for p, p2 ``[steps, M, N]``, v ``[steps, N, 128]``.
- T3 ``qk_probe``: every score column live, ``out[:, j] = sum_h sum_t
  s_h[:, 128 t + j]`` in fp32.

The kernels take bf16 only, as the tools run them; the plain versions also
take fp32 (the CPU tests). A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

WIDTH = 128                # q / k / v row width (two heads of 64 or one of 128)
PHASE_PROBES = ("qk64x2", "qk128", "qk+sm x2", "pv128x2")
_QK_CODES = {"qk64x2": 0, "qk128": 1, "qk+sm x2": 2}   # probe codes of vda_phase_probe


def _scores(q: torch.Tensor, k: torch.Tensor, heads: int) -> list[torch.Tensor]:
    """Per head, fp32 scores [steps, M, N]."""
    d = WIDTH // heads
    return [torch.matmul(q[..., h * d:(h + 1) * d].float(),
                         k[..., h * d:(h + 1) * d].float().transpose(-1, -2))
            for h in range(heads)]


def qk_first128_plain(q: torch.Tensor, k: torch.Tensor, *, heads: int) -> torch.Tensor:
    """T1 qk64x2 (heads 2) / qk128 (heads 1): sum_h s_h[:, :, :128]."""
    return sum(s[..., :WIDTH] for s in _scores(q, k, heads)).to(q.dtype)


def qk_softmax_plain(q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """T1 qk+sm x2: (sum_h bf16(exp(s_h - max s_h))[:, :, :128] in q's dtype,
    sum_h sum_keys exp(s_h - max s_h) in fp32)."""
    out, side = 0.0, 0.0
    for s in _scores(q, k, 2):
        e = torch.exp(s - s.amax(-1, keepdim=True))
        out = out + e[..., :WIDTH].to(torch.bfloat16).float()
        side = side + e.sum(-1)
    return out.to(q.dtype), side


def pv_plain(p: torch.Tensor, p2: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T1 pv128x2: p v + p2 v with fp32 accumulation."""
    vf = v.float()
    return (torch.matmul(p.float(), vf) + torch.matmul(p2.float(), vf)).to(v.dtype)


def qk_colsum_plain(q: torch.Tensor, k: torch.Tensor, *, heads: int) -> torch.Tensor:
    """T3: out[..., j] = sum_h sum_t s_h[..., 128 t + j], fp32."""
    steps, m, n = q.shape[0], q.shape[1], k.shape[1]
    return sum(s.reshape(steps, m, n // WIDTH, WIDTH).sum(2) for s in _scores(q, k, heads))


def _check(*ts: torch.Tensor, shapes: list[tuple]) -> None:
    for t, want in zip(ts, shapes):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the probe kernels take bfloat16 only, got {t.dtype}")
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"expected a contiguous {want}, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
        if t.device != ts[0].device:
            raise ValueError("the operands must be on one device")


def _qk_shapes(q: torch.Tensor, k: torch.Tensor) -> tuple[int, int, int]:
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0]:
        raise ValueError(f"q, k must be [steps, M, 128] and [steps, N, 128]: "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    steps, m, n = q.shape[0], q.shape[1], k.shape[1]
    if m % 64 or n % WIDTH or not m or not n:
        raise ValueError(f"the kernels take M % 64 == 0 and N % 128 == 0: M={m}, N={n}")
    return steps, m, n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_t1(code: int, q, k, out, side, sink) -> None:
    steps, m, n = _qk_shapes(q, k)
    _check(q, k, shapes=[(steps, m, WIDTH), (steps, n, WIDTH)])
    fn = build.library("phase_probes").vda_phase_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(q.device):
        err = fn(code, q.data_ptr(), k.data_ptr(), out.data_ptr(),
                 side.data_ptr() if side is not None else None,
                 sink.data_ptr() if sink is not None else None, steps, m, n, _stream(q))
    if err != 0:
        raise RuntimeError(f"phase probe {code} launch failed: cudaError {err}")


def _launch_qk(heads: int, q, k, out) -> None:
    steps, m, n = _qk_shapes(q, k)
    _check(q, k, shapes=[(steps, m, WIDTH), (steps, n, WIDTH)])
    fn = build.library("qk_probes").vda_qk_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(q.device):
        err = fn(heads, q.data_ptr(), k.data_ptr(), out.data_ptr(), steps, m, n, _stream(q))
    if err != 0:
        raise RuntimeError(f"qk probe (heads {heads}) launch failed: cudaError {err}")


def _launch_pv(p, p2, v, out) -> None:
    if p.dim() != 3 or v.dim() != 3:
        raise ValueError(f"p, p2 must be [steps, M, N], v [steps, N, 128]: "
                         f"{tuple(p.shape)} {tuple(v.shape)}")
    steps, m, n = p.shape
    if m % 64 or n % 64 or not m or not n:
        raise ValueError(f"the kernel takes M % 64 == 0 and N % 64 == 0: M={m}, N={n}")
    _check(p, p2, v, shapes=[(steps, m, n), (steps, m, n), (steps, n, WIDTH)])
    fn = build.library("phase_probes").vda_phase_pv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(p.device):
        err = fn(p.data_ptr(), p2.data_ptr(), v.data_ptr(), out.data_ptr(), steps, m, n,
                 _stream(p))
    if err != 0:
        raise RuntimeError(f"pv probe launch failed: cudaError {err}")


def _device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def phase_probe(name: str, *args: torch.Tensor, side: bool = False, sink: bool = False):
    """T1: one of ``PHASE_PROBES``. ``qk*`` probes take (q, k), ``pv128x2``
    takes (p, p2, v). Returns the probe's output, and for ``qk+sm x2`` with
    ``side=True`` the pair (output, per-row sum of the exponentials).
    ``sink=True`` (``qk64x2``, ``qk128``) has the kernel store the sums of
    every key tile's scores into a scratch buffer too; the output is the
    same."""
    if name not in PHASE_PROBES:
        raise ValueError(f"unknown phase probe {name!r}; one of {PHASE_PROBES}")
    if side and name != "qk+sm x2":
        raise ValueError("only the qk+sm x2 probe has a side sum")
    if sink and name not in ("qk64x2", "qk128"):
        raise ValueError("only the qk64x2 and qk128 probes have a sink")
    if not _device(args[0], "phase_probe"):
        if name == "pv128x2":
            return pv_plain(*args)
        if name == "qk+sm x2":
            out, rows = qk_softmax_plain(*args)
            return (out, rows) if side else out
        return qk_first128_plain(*args, heads=2 if name == "qk64x2" else 1)
    if name == "pv128x2":
        p, p2, v = args
        out = torch.empty(p.shape[0], p.shape[1], WIDTH, dtype=v.dtype, device=v.device)
        _launch_pv(p, p2, v, out)
        phase_probe.launches += 1
        return out
    q, k = args
    out = torch.empty(q.shape[0], q.shape[1], WIDTH, dtype=q.dtype, device=q.device)
    rows = (torch.empty(q.shape[0], q.shape[1], dtype=torch.float32, device=q.device)
            if name == "qk+sm x2" else None)
    # One float per consumer thread (256) of each 128-row block of each step.
    scratch = (torch.empty(q.shape[0] * -(-q.shape[1] // 128) * 256, dtype=torch.float32,
                           device=q.device) if sink else None)
    _launch_t1(_QK_CODES[name], q, k, out, rows, scratch)
    phase_probe.launches += 1
    return (out, rows) if side else out


def qk_probe(q: torch.Tensor, k: torch.Tensor, *, heads: int) -> torch.Tensor:
    """T3: the column-group sum of every score, over ``heads`` (2: qk64, two
    64-deep heads; 1: qk128, one 128-deep product), fp32 [steps, M, 128]."""
    if heads not in (1, 2):
        raise ValueError(f"heads must be 1 or 2, got {heads}")
    if not _device(q, "qk_probe"):
        return qk_colsum_plain(q, k, heads=heads)
    out = torch.empty(q.shape[0], q.shape[1], WIDTH, dtype=torch.float32, device=q.device)
    _launch_qk(heads, q, k, out)
    qk_probe.launches += 1
    return out


phase_probe.launches = 0
qk_probe.launches = 0
