"""The port's CLI end to end on the CPU, and its import hygiene.

``python -m video_depth_anything_torch.run`` runs on tiny shapes with
random weights and ``--device cpu`` (the plain path), in the manner of
test_cli_smoke.py, in its float modes and with ``--int8`` (the side file
beside a checkpoint); a fresh interpreter imports every module of the port
and must end with neither JAX nor the JAX package loaded.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "video_depth_anything_torch"

_DRIVER = """
import sys
from video_depth_anything_torch import run
base = ["--encoder", "vits", "--random_init", "--input_video", {video!r},
        "--input_size", "28", "--max_res", "64", "--save_npz", "--device", "cpu"]
for name, extra in [("bf16", []), ("fp32", ["--fp32"]), ("metric", ["--metric", "--fp32"])]:
    run.main(base + ["--output_dir", {out!r} + "/" + name] + extra)
    print("DONE", name, flush=True)
"""


def _write_clip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from video_depth_anything_torch.utils.precision import synthetic_video

    video = str(tmp_path / "clip.mp4")
    frames = synthetic_video(n=12, hw=(48, 64))
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    return video


def test_cli_all_modes(tmp_path):
    video = _write_clip(tmp_path)
    res = subprocess.run([sys.executable, "-c", _DRIVER.format(video=video, out=str(tmp_path))],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, f"CLI failed:\n{res.stdout}\n{res.stderr}"
    for name in ("bf16", "fp32", "metric"):
        assert f"DONE {name}" in res.stdout
        out = tmp_path / name
        d = np.load(out / "clip_depths.npz")["depths"]
        assert d.shape == (12, 48, 64) and d.dtype == np.float32 and np.isfinite(d).all()
        for suffix in ("_src.mp4", "_vis.mp4"):
            p = out / ("clip" + suffix)
            assert p.exists() and p.stat().st_size > 0, p


_DRIVER_INT8 = """
import os, torch
from video_depth_anything_torch import run
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.models import build_model
base = ["--encoder", "vits", "--input_video", {video!r}, "--input_size", "28",
        "--max_res", "64", "--save_npz", "--device", "cpu", "--int8"]
run.main(base + ["--random_init", "--output_dir", {out!r} + "/random"])
print("DONE random", flush=True)
ckpt = {out!r} + "/vits.pth"
torch.save(build_model(get_model_config("vits"), seed=1).state_dict(), ckpt)
side = ckpt + ".int8calib.npz"
assert not os.path.exists(side)
run.main(base + ["--checkpoint", ckpt, "--output_dir", {out!r} + "/ckpt1"])
first = os.stat(side).st_mtime_ns, open(side, "rb").read()
run.main(base + ["--checkpoint", ckpt, "--output_dir", {out!r} + "/ckpt2"])
assert (os.stat(side).st_mtime_ns, open(side, "rb").read()) == first, "side file rewritten"
print("DONE ckpt", flush=True)
"""


def test_cli_int8_random_init_and_checkpoint_side_file(tmp_path):
    """--int8 with --random_init writes its outputs (no side file: it
    calibrates every run); with --checkpoint the first run writes
    <ckpt>.int8calib.npz and the second reuses it untouched, with the same
    depths."""
    video = _write_clip(tmp_path)
    res = subprocess.run([sys.executable, "-c", _DRIVER_INT8.format(video=video, out=str(tmp_path))],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, f"CLI failed:\n{res.stdout}\n{res.stderr}"
    assert "DONE random" in res.stdout and "DONE ckpt" in res.stdout
    assert not list((tmp_path / "random").glob("*.int8calib.npz"))
    depths = {}
    for name in ("random", "ckpt1", "ckpt2"):
        d = np.load(tmp_path / name / "clip_depths.npz")["depths"]
        assert d.shape == (12, 48, 64) and d.dtype == np.float32 and np.isfinite(d).all()
        for suffix in ("_src.mp4", "_vis.mp4"):
            p = tmp_path / name / ("clip" + suffix)
            assert p.exists() and p.stat().st_size > 0, p
        depths[name] = d
    np.testing.assert_array_equal(depths["ckpt1"], depths["ckpt2"])
    with np.load(tmp_path / "vits.pth.int8calib.npz") as side:
        assert "__calib_meta__/net_hw" in side.files and "encoder/q_out" in side.files


_IMPORT_ALL = """
import importlib, pkgutil, sys
import video_depth_anything_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "video_depth_anything_tpu")))
print("LOADED", len([m for m in sys.modules if m.startswith(pkg.__name__)]))
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("LOADED")[1].split()[0]) >= 28, res.stdout


def test_no_port_file_names_jax():
    offenders = []
    for path in PORT.rglob("*"):
        if path.suffix not in (".py", ".cu", ".cuh"):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if ("import jax" in line or "from jax" in line or "jax." in line
                    or "video_depth_anything_tpu" in line):
                offenders.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not offenders, offenders
