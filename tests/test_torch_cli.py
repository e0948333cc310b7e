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
# Two intra-op threads per CLI process: beside the other test workers, one
# thread per core oversubscribes the cores and the runs take 10x longer.
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}

_DRIVER = """
import sys
from video_depth_anything_torch import run
base = ["--encoder", "vits", "--random_init", "--input_video", {video!r},
        "--input_size", "28", "--max_res", "64", "--save_npz", "--device", "cpu"]
for name, extra in [("bf16", []), ("fp32", ["--fp32"]), ("metric", ["--metric", "--fp32"])]:
    run.main(base + ["--output_dir", {out!r} + "/" + name] + extra)
    print("DONE", name, flush=True)
"""


def _write_clip(tmp_path, n=12):
    cv2 = pytest.importorskip("cv2")
    from video_depth_anything_torch.utils.precision import synthetic_video

    video = str(tmp_path / "clip.mp4")
    frames = synthetic_video(n=n, hw=(48, 64))
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    return video


def test_cli_all_modes(tmp_path):
    video = _write_clip(tmp_path)
    res = subprocess.run([sys.executable, "-c", _DRIVER.format(video=video, out=str(tmp_path))],
                         capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
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
                         capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
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


_LONG_VIDEO_RUNS = """
import glob, os
import numpy as np
from video_depth_anything_torch import run
from video_depth_anything_torch.pipeline import VideoDepthPipeline
base = ["--encoder", "vits", "--random_init", "--input_video", {video!r}, "--input_size", "28",
        "--max_res", "64", "--save_npz", "--device", "cpu", "--fp32"]
runs = {{"batch": [], "stream": ["--streaming"], "c2": ["--windows_per_batch", "2"],
        "stream_c2": ["--streaming", "--windows_per_batch", "2", "--profile_dir", {out!r} + "/trace"],
        "fp16": ["--transfer_fp16"],
        "int8_c2": ["--int8", "--windows_per_batch", "2"],
        "int8_stream_c2": ["--int8", "--streaming", "--windows_per_batch", "2"]}}
for name, extra in runs.items():
    run.main(base + ["--output_dir", {out!r} + "/" + name] + extra)
    print("DONE", name, flush=True)

def broken(self, frame_iter, **kw):   # dies after its first chunk
    for f in frame_iter:
        yield np.zeros((1, *f.shape[:2]), np.float32)
        raise RuntimeError("boom")

VideoDepthPipeline.infer_video_depth_streaming = broken
try:
    run.main(base + ["--output_dir", {out!r} + "/failed", "--streaming"])
except RuntimeError:
    print("RAISED", sorted(os.listdir({out!r} + "/failed")), flush=True)
"""


def test_cli_streaming_windows_per_batch_and_fp16_transport(tmp_path):
    """--streaming equals the batch run bit for bit at the same
    --windows_per_batch (with --int8 too); --windows_per_batch 2 is within the
    batched cache's 1e-5 of the sequential run; --transfer_fp16 within 2^-10
    of max |d| of the fp32 transport. No spool file is left behind, by a
    finished run or by one that failed mid-stream. --profile_dir writes its
    trace."""
    video = _write_clip(tmp_path, n=50)
    res = subprocess.run([sys.executable, "-c", _LONG_VIDEO_RUNS.format(video=video, out=str(tmp_path))],
                         capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
    assert res.returncode == 0, f"CLI failed:\n{res.stdout}\n{res.stderr}"
    d = {}
    for name in ("batch", "stream", "c2", "stream_c2", "fp16", "int8_c2", "int8_stream_c2"):
        assert f"DONE {name}" in res.stdout
        d[name] = np.load(tmp_path / name / "clip_depths.npz")["depths"]
        assert d[name].shape == (50, 48, 64) and d[name].dtype == np.float32
        assert np.isfinite(d[name]).all()
        for suffix in ("_src.mp4", "_vis.mp4"):
            assert (tmp_path / name / ("clip" + suffix)).stat().st_size > 0
    np.testing.assert_array_equal(d["stream"], d["batch"])
    np.testing.assert_array_equal(d["stream_c2"], d["c2"])
    np.testing.assert_array_equal(d["int8_stream_c2"], d["int8_c2"])
    np.testing.assert_allclose(d["c2"], d["batch"], rtol=1e-5, atol=1e-5)
    assert np.abs(d["fp16"] - d["batch"]).max() <= 2.0 ** -10 * np.abs(d["batch"]).max()
    for streamed, batch in (("stream", "batch"), ("stream_c2", "c2")):   # the same files
        for suffix in ("_src.mp4", "_vis.mp4"):
            a, b = (tmp_path / x / ("clip" + suffix) for x in (streamed, batch))
            assert a.read_bytes() == b.read_bytes(), (streamed, suffix)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0   # --profile_dir
    assert "RAISED ['clip_src.mp4']" in res.stdout, res.stdout
    assert not list(tmp_path.rglob("*.spool.f32"))


_SERVING_RUNS = """
from video_depth_anything_torch import depth_to_pointcloud, metric_run, run
base = ["--encoder", "vits", "--input_video", {video!r}, "--input_size", "28",
        "--max_res", "64", "--device", "cpu"]
rnd = base + ["--random_init"]
run.main(rnd + ["--output_dir", {out!r} + "/exr", "--save_npz", "--save_exr"])
run.main(rnd + ["--output_dir", {out!r} + "/exr_stream", "--save_npz", "--save_exr", "--streaming"])
metric_run.main(rnd + ["--output_dir", {out!r} + "/metric", "--save_npz", "--save_exr", "--fp32"])
depth_to_pointcloud.main(rnd + ["--output_dir", {out!r} + "/ply", "--fp32"])
print("DONE random", flush=True)
"""


def test_cli_save_exr_metric_and_pointclouds(tmp_path):
    """--save_exr frames read back equal to the npz (batch and streaming);
    metric_run writes its depths and EXR frames; depth_to_pointcloud one
    PLY per frame, each the unprojected metric depth of the frame."""
    from video_depth_anything_torch.utils.exr import read_exr_z
    from video_depth_anything_torch.utils.pointcloud import read_ply, unproject_depth

    video = _write_clip(tmp_path)
    res = subprocess.run([sys.executable, "-c", _SERVING_RUNS.format(video=video, out=str(tmp_path))],
                         capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
    assert res.returncode == 0, f"CLI failed:\n{res.stdout}\n{res.stderr}"
    assert "DONE random" in res.stdout
    for name in ("exr", "exr_stream", "metric"):
        d = np.load(tmp_path / name / "clip_depths.npz")["depths"]
        assert d.shape == (12, 48, 64) and np.isfinite(d).all()
        frames = sorted((tmp_path / name / "clip_depths_exr").glob("frame_*.exr"))
        assert [f.name for f in frames] == [f"frame_{i:05d}.exr" for i in range(12)]
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(read_exr_z(str(f)), d[i])
    metric = np.load(tmp_path / "metric" / "clip_depths.npz")["depths"]
    plys = sorted((tmp_path / "ply").glob("point*.ply"))
    assert [p.name for p in plys] == [f"point{i:04d}.ply" for i in range(12)]
    pts, cols = read_ply(str(plys[3]))
    want, _ = unproject_depth(metric[3], 470.4, 470.4)
    np.testing.assert_array_equal(pts, want.astype(np.float32))
    assert cols.shape == (48 * 64, 3)


_NPZ_CHECKPOINT = """
import jax, numpy as np
from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models.video_depth import init_params
from video_depth_anything_tpu.utils.params_io import save_params
save_params({ckpt!r}, init_params(jax.random.PRNGKey(0), j_config("vits")))
"""


def test_cli_npz_checkpoint(tmp_path):
    """--checkpoint x.npz (the JAX package's save_params layout) loads and
    runs, and with --int8 its side file is <x.npz>.int8calib.npz."""
    video = _write_clip(tmp_path)
    ckpt = str(tmp_path / "video_depth_anything_vits.npz")
    env = {**ENV, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _NPZ_CHECKPOINT.format(ckpt=ckpt)],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    base = [sys.executable, "-m", "video_depth_anything_torch.run", "--encoder", "vits",
            "--input_video", video, "--input_size", "28", "--max_res", "64", "--device", "cpu",
            "--save_npz", "--checkpoint", ckpt]
    for name, extra in (("fp32", ["--fp32"]), ("int8", ["--int8"])):
        res = subprocess.run(base + ["--output_dir", str(tmp_path / name)] + extra,
                             capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
        assert res.returncode == 0, f"CLI failed:\n{res.stdout}\n{res.stderr}"
        assert f"loading checkpoint: {ckpt}" in res.stdout
        d = np.load(tmp_path / name / "clip_depths.npz")["depths"]
        assert d.shape == (12, 48, 64) and np.isfinite(d).all()
    assert os.path.exists(ckpt + ".int8calib.npz")


def test_cli_accepts_vitg_and_the_new_flags():
    """Parsing only: a 1.1 B model is too slow for the CPU here."""
    from video_depth_anything_torch import depth_to_pointcloud, run

    args = run.parse_args(["--encoder", "vitg", "--save_exr", "--decode_backend", "ffmpeg",
                           "--checkpoint", "x.npz"])
    assert (args.encoder, args.save_exr, args.decode_backend, args.checkpoint) == (
        "vitg", True, "ffmpeg", "x.npz")
    assert run.parse_args([]).decode_backend is None and run.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        run.parse_args(["--decode_backend", "decord"])
    p = depth_to_pointcloud.parse_args(["--encoder", "vitg", "--focal-length-x", "500"])
    assert (p.encoder, p.focal_length_x, p.focal_length_y, p.device) == ("vitg", 500.0, 470.4, "cuda")


@pytest.mark.parametrize("entry", ["run", "depth_to_pointcloud", "bench"])
def test_cli_default_paths_lie_inside_the_checkout(entry):
    """The entry points run as ``python -m`` from the repo root: no default
    path may reach out of it."""
    import importlib

    args = vars(importlib.import_module(f"video_depth_anything_torch.{entry}").parse_args([]))
    paths = {k: v for k, v in args.items() if isinstance(v, str) and "/" in v}
    assert all(not v.startswith("..") for v in paths.values()), paths
    if "input_video" in args:
        assert args["input_video"] == "./assets/example_videos/davis_rollercoaster.mp4"


def test_cli_without_a_card_exits_instead_of_moving_to_the_cpu(tmp_path):
    """The default device is the card: where none answers, the probe ends
    the run with a message (no CPU fallback); VDA_DEVICE_TIMEOUT=0 skips
    the probe, and the pipeline itself then refuses."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe passes")
    cmd = [sys.executable, "-m", "video_depth_anything_torch.run", "--encoder", "vits",
           "--random_init", "--input_video", str(tmp_path / "none.mp4"),
           "--output_dir", str(tmp_path / "out")]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env={**ENV, "VDA_DEVICE_TIMEOUT": "60"}, timeout=300)
    assert res.returncode == 1 and "CUDA device unavailable" in res.stderr, res.stderr
    assert not (tmp_path / "out").exists()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env={**ENV, "VDA_DEVICE_TIMEOUT": "0"}, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr


_IMPORT_ALL = """
import importlib, pkgutil, sys
import video_depth_anything_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "video_depth_anything_tpu")))
print("LOADED", len([m for m in sys.modules if m.startswith(pkg.__name__)]))
print("BAD", bad)
print("HAS", all(pkg.__name__ + "." + m in sys.modules for m in (
    "bench", "run", "pipeline.infer", "utils.profiling", "utils.video_io", "metric_run",
    "depth_to_pointcloud", "utils.exr", "utils.pointcloud", "utils.params_io",
    "utils.platform_env", "training.train", "training.train_state", "training.losses",
    "training.checkpoint", "training.validate", "training.visualize", "data.vkitti",
    "data.landmarks", "data.loader", "benchmark.metrics", "benchmark.tae",
    "benchmark.evaluate", "benchmark.manifests", "benchmark.extract", "benchmark.infer",
    "tools.bench_train_step", "parallel.mesh", "parallel.distributed", "parallel.tensor", "app",
    "tools.convert_checkpoint", "tools.export_checkpoint", "tools.validate_checkpoint",
    "tools.bench_ablate", "tools.bench_segments", "tools.bench_head_fine",
    "tools.bench_head_convs", "tools.bench_memory", "tools.bench_mxu_geometry",
    "tools.bench_int8_conv", "tools.bench_residue", "tools.bench_drift_518",
    "tools.bench_temporal_swap", "tools.bench_temporal_kernel", "tools.bench_stock_flash",
    "tools.bench_attn_kernel", "tools.bench_decode")))
print("LIBS", sorted(m for m in ("yaml", "PIL", "cv2") if m in sys.modules))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert "HAS True" in res.stdout, res.stdout   # the long-video path's modules too
    # The card's machine has none of these: nothing imports them at module level.
    assert "LIBS []" in res.stdout, res.stdout
    assert int(res.stdout.split("LOADED")[1].split()[0]) >= 50, res.stdout


_BLOCKED_RUN = """
import runpy, sys
for name in ("jax", "jaxlib", "video_depth_anything_tpu", "yaml", "PIL", "cv2"):
    sys.modules[name] = None   # importing any of them now raises
sys.argv = [{mod!r}, "--help"]
runpy.run_module({mod!r}, run_name="__main__")
"""


@pytest.mark.parametrize("mod", ["video_depth_anything_torch.training.train",
                                 "video_depth_anything_torch.tools.bench_train_step",
                                 "video_depth_anything_torch.benchmark.infer",
                                 "video_depth_anything_torch.tools.convert_checkpoint",
                                 "video_depth_anything_torch.tools.export_checkpoint",
                                 "video_depth_anything_torch.tools.validate_checkpoint"])
def test_training_entry_points_start_without_jax(mod):
    """The training driver (with its --distributed mode), the train-step
    bench, the benchmark inference and the checkpoint tools print their
    help with jax, the JAX package, yaml, PIL and cv2 unimportable."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN.format(mod=mod)],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "usage:" in res.stdout, res.stdout
    if mod.endswith("training.train"):
        assert "--distributed" in res.stdout, res.stdout


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
