"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled on
its own into ``<BUILD_DIR>/lib<name>-<hash>.so`` for ``sm_90a`` (the hash
covers the source, the shared headers ``csrc/*.cuh``, the flags and nvcc's
``--version`` text, so an edited source or header, or another toolkit,
rebuilds). ``BUILD_DIR`` is the package's ``_build/`` unless
``utils/compile_cache.py`` points it at a shared cache directory: the
names are content keys, and each library is written to a temporary file
and renamed into place, so processes and checkouts share one directory
safely. All sources compile in parallel, one
nvcc process each, at the first call of any kernel. Nothing here runs at
import time: the CPU tests import every module of the package on a machine
that has no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("spatial_attention", "temporal_attention", "spatial_attention_qk8",
           "attention_head_major", "fused_rcu", "qk_probes", "attention_variants",
           "phase_probes", "attention_switches", "temporal_attention_backward",
           "head_output_tail", "swiglu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


class KernelBuildError(RuntimeError):
    pass


_LIBS: dict[str, ctypes.CDLL] = {}   # loaded once per process, on first use
_LOG: dict[str, str] = {}            # nvcc output of this process's builds


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (on PATH or /usr/local/cuda/bin)")


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str:
    """``nvcc --version``'s text: part of every library's key."""
    proc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc --version: {proc.stdout}{proc.stderr}")
    return proc.stdout


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(nvcc_version().encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source not yet built (in parallel) and load them all.

    Raises KernelBuildError with nvcc's output if any compile fails.
    """
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in SOURCES:
        target = _target(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        _LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise KernelBuildError("\n".join(failed))
    for name in SOURCES:
        _LIBS[name] = ctypes.CDLL(_target(name))
    return _LIBS


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def build_log() -> dict[str, str]:
    """nvcc output of this process's builds (register and smem use), one
    entry per source nvcc compiled: none when every library was in
    ``BUILD_DIR`` already."""
    return dict(_LOG)


# bf16 wgmma, int8 wgmma, mma.sync on bf16 / fp16, TMA loads, mbarrier operations
SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "UTMALDG", "SYNCS")


def sass_counts(name: str) -> dict[str, int]:
    """Counts of Hopper instructions in a built library's SASS (cuobjdump
    -sass, beside nvcc). Raises KernelBuildError if cuobjdump is missing or
    fails: the count is evidence, never skipped."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        raise KernelBuildError(f"cuobjdump not found beside nvcc: {cuobjdump}")
    build_all()
    proc = subprocess.run([cuobjdump, "-sass", _target(name)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump -sass {name}: {proc.stderr[-2000:]}")
    return {op: len(re.findall(rf"\b{op}\b", proc.stdout)) for op in SASS_OPS}
