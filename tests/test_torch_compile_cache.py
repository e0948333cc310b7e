"""The kernel build cache (``utils/compile_cache.py``) on the CPU.

No nvcc here: the nvcc version is stubbed where a library's key is read.
Held: the build directory follows ``enable_compile_cache`` and
``VDA_COMPILE_CACHE`` (a path, or "1" for the default directory) and stays
the package's ``_build/`` otherwise; a library's key changes with the nvcc
version, the flags and the source, and with nothing else; run.py and
training/train.py take ``--compile_cache [DIR]``; a CPU run with the cache
on builds nothing.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from video_depth_anything_torch.kernels import build
from video_depth_anything_torch.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


@pytest.fixture
def stub_nvcc(monkeypatch):
    """A fixed nvcc --version text, and BUILD_DIR restored afterwards."""
    monkeypatch.setattr(build, "nvcc_version", lambda: "Cuda compilation tools, release 12.8")
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.delenv("VDA_COMPILE_CACHE", raising=False)


def test_the_default_build_dir_is_the_packages(stub_nvcc):
    assert build.BUILD_DIR == os.path.join(os.path.dirname(build.CSRC), "_build")
    assert compile_cache.maybe_enable_from_env() is None
    assert os.path.dirname(build._target("fused_rcu")) == build.BUILD_DIR


def test_enable_points_the_build_at_the_cache(stub_nvcc, tmp_path):
    d = compile_cache.enable_compile_cache(str(tmp_path / "cache"))
    assert d == str(tmp_path / "cache") and os.path.isdir(d) and build.BUILD_DIR == d
    for name in build.SOURCES:
        target = build._target(name)
        assert os.path.dirname(target) == d
        assert os.path.basename(target).startswith(f"lib{name}-")


def test_the_environment_variable(stub_nvcc, tmp_path, monkeypatch):
    monkeypatch.setenv("VDA_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.maybe_enable_from_env() == str(tmp_path / "env")
    assert build.BUILD_DIR == str(tmp_path / "env")
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "default"))
    monkeypatch.setenv("VDA_COMPILE_CACHE", "1")
    assert compile_cache.maybe_enable_from_env() == str(tmp_path / "default")
    assert build.BUILD_DIR == str(tmp_path / "default")
    assert compile_cache.enable_compile_cache("") == str(tmp_path / "default")


def test_the_key_holds_the_nvcc_version_flags_and_source(stub_nvcc, tmp_path, monkeypatch):
    before = {name: build._target(name) for name in build.SOURCES}
    assert before == {name: build._target(name) for name in build.SOURCES}   # stable
    monkeypatch.setattr(build, "nvcc_version", lambda: "Cuda compilation tools, release 12.9")
    after = {name: build._target(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    monkeypatch.setattr(build, "nvcc_version", lambda: "Cuda compilation tools, release 12.8")
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-DVDA_UNUSED"))
    assert all(build._target(n) != before[n] for n in build.SOURCES)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS[:-1])
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    monkeypatch.setattr(build, "CSRC", str(src))
    assert {n: build._target(n) for n in build.SOURCES} == before     # same content, same key
    with open(src / "fused_rcu.cu", "a") as f:
        f.write("\n// edited\n")
    assert build._target("fused_rcu") != before["fused_rcu"]
    assert build._target("spatial_attention") == before["spatial_attention"]
    with open(src / "hopper.cuh", "a") as f:                            # a shared header
        f.write("\n// edited\n")
    assert build._target("spatial_attention") != before["spatial_attention"]


@pytest.mark.parametrize("entry", ["video_depth_anything_torch.run",
                                   "video_depth_anything_torch.training.train"])
def test_entry_points_take_the_flag(entry):
    res = subprocess.run([sys.executable, "-m", entry, "--help"], capture_output=True, text=True,
                         cwd=ROOT, env=ENV, timeout=300)
    assert res.returncode == 0 and "--compile_cache [DIR]" in res.stdout, res.stderr


def test_a_cpu_run_builds_nothing(stub_nvcc, tmp_path, monkeypatch):
    """The port's CPU path never reaches nvcc, with the cache on or off."""
    from video_depth_anything_torch.config import ModelConfig, ViTConfig
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.utils.precision import synthetic_video

    def no_build():
        raise AssertionError("a CPU run reached the kernel build")

    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(build, "_nvcc", no_build)
    compile_cache.enable_compile_cache(str(tmp_path / "cache"))
    cfg = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=128, depth=2, num_heads=2),
                      features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0), device="cpu", quant="int8")
        d, _ = pipe.infer_video_depth(synthetic_video(n=12, hw=(28, 28)), input_size=28)
    finally:
        torch.set_num_threads(threads)
    assert d.shape == (12, 28, 28)
    assert os.listdir(tmp_path / "cache") == [] and build.build_log() == {}


_DRIVER = """
import os
from video_depth_anything_torch import run
from video_depth_anything_torch.kernels import build
base = ["--encoder", "vits", "--random_init", "--input_video", {video!r}, "--input_size", "28",
        "--max_res", "64", "--device", "cpu"]
run.main(base + ["--output_dir", {out!r} + "/flag", "--compile_cache", {flag!r}])
assert build.BUILD_DIR == {flag!r}, build.BUILD_DIR
os.environ["VDA_COMPILE_CACHE"] = {env!r}
run.main(base + ["--output_dir", {out!r} + "/env"])
assert build.BUILD_DIR == {env!r}, build.BUILD_DIR
assert not build._LIBS and not build.build_log()
print("DONE", flush=True)
"""


def test_run_with_the_cache_on_the_cpu(tmp_path):
    from test_torch_cli import _write_clip

    video = _write_clip(tmp_path)
    flag, env = str(tmp_path / "flag_cache"), str(tmp_path / "env_cache")
    code = _DRIVER.format(video=video, out=str(tmp_path), flag=flag, env=env)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={k: v for k, v in ENV.items() if k != "VDA_COMPILE_CACHE"},
                         timeout=600)
    assert res.returncode == 0 and "DONE" in res.stdout, res.stdout + res.stderr
    assert f"kernel build cache: {flag}" in res.stdout
    assert f"kernel build cache (VDA_COMPILE_CACHE): {env}" in res.stdout
    assert os.listdir(flag) == [] and os.listdir(env) == []
    assert (tmp_path / "env" / "clip_vis.mp4").exists()


def test_bench_tool_exits_without_a_card(tmp_path):
    from video_depth_anything_torch.tools import bench_compile_cache

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_compile_cache.main([]) == 2
    assert bench_compile_cache.main(["--child", str(tmp_path)]) == 2
    assert os.listdir(tmp_path) == []
