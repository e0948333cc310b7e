"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled on
its own into ``_build/lib<name>-<hash>.so`` for ``sm_90a`` (the hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source or header rebuilds). All sources compile in parallel, one
nvcc process each, at the first call of any kernel. Nothing here runs at
import time: the CPU tests import every module of the package on a machine
that has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("spatial_attention", "temporal_attention", "spatial_attention_qk8")
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


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    """nvcc output of this process's builds (register and smem use)."""
    return dict(_LOG)
