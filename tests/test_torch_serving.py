"""The port's serving surface against the JAX package, on the CPU: the
metric pipeline in every mode, EXR files, ``.npz`` checkpoints, point
clouds, the decode backend and the device probe.

The metric model runs the toy config of test_torch_streaming.py
(ViTConfig(64, depth 2, 2 heads), features 32, taps 0, 0, 1, 1) with
``metric=True``: the stitch pins scale and shift to 1 and 0. Tolerance for
the pipelines: fp32 rtol 1e-4, atol 1e-4 * max(depth range, 1). Files are
held bit for bit.
"""
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.config import ModelConfig as JModelConfig
from video_depth_anything_tpu.config import ViTConfig as JViTConfig
from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
from video_depth_anything_tpu.utils import exr as jexr
from video_depth_anything_tpu.utils import params_io as jparams_io
from video_depth_anything_tpu.utils import pointcloud as jpc
from video_depth_anything_tpu.utils import video_io as jvio
from video_depth_anything_torch.config import ModelConfig, ViTConfig
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.convert import load_checkpoint, model_from_params
from video_depth_anything_torch.models import build_model
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.pipeline import stitch
from video_depth_anything_torch.utils import exr as texr
from video_depth_anything_torch.utils import params_io as tparams_io
from video_depth_anything_torch.utils import platform_env
from video_depth_anything_torch.utils import pointcloud as tpc
from video_depth_anything_torch.utils import video_io as tvio
from video_depth_anything_torch.utils.precision import synthetic_video
from video_depth_anything_torch.utils.tree import flatten_tree

from test_torch_model import perturbed_params

INPUT = 28
J_CFG = JModelConfig(encoder="_tinytorchmetric",
                     vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2),
                     features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1), metric=True)
T_CFG = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2),
                    features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1), metric=True)
MODES = {"plain": dict(cache_keyframe_features=False), "sequential": dict(),
         "batched": dict(windows_per_batch=2), "streaming": dict()}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads beside the JAX CPU client (test_torch_streaming.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def metric():
    params = perturbed_params(J_CFG)
    jpipe = JaxPipeline(J_CFG, jax.tree.map(jnp.asarray, params), use_pallas=False)
    pipe = VideoDepthPipeline(T_CFG, model_from_params(params, T_CFG), device="cpu")
    return jpipe, pipe, synthetic_video(n=60, hw=(42, 56), seed=8)


def _run(p, frames, mode):
    if mode == "streaming":
        return np.concatenate(list(p.infer_video_depth_streaming(
            iter(frames), input_size=INPUT, fp32=True)))
    return np.asarray(p.infer_video_depth(frames, input_size=INPUT, fp32=True,
                                          **MODES[mode])[0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_metric_pipeline_matches_jax(metric, mode):
    jpipe, pipe, frames = metric
    ref, got = _run(jpipe, frames, mode), _run(pipe, frames, mode)
    assert got.shape == ref.shape == frames.shape[:3] and np.isfinite(got).all()
    atol = 1e-4 * max(float(ref.max() - ref.min()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol, err_msg=mode)


def test_metric_stitch_is_clamp_and_crossfade(metric, monkeypatch):
    """Each stitched frame is the clamped window depth, cross-faded over the
    8 overlap frames: no scale or shift (pipeline/stitch.py)."""
    _, pipe, frames = metric
    windows = []
    first, step = stitch.stitch_first, stitch.stitch_step

    def spy_first(d):
        windows.append(d.clone())
        return first(d)

    def spy_step(carry, d, metric=False):
        assert metric
        windows.append(d.clone())
        return step(carry, d, metric=metric)

    monkeypatch.setattr(stitch, "stitch_first", spy_first)
    monkeypatch.setattr(stitch, "stitch_step", spy_step)
    got = _run(pipe, frames, "sequential")
    w = [np.maximum(d.numpy(), 0) for d in windows]
    fade = np.array([0.0] + [i / 7 for i in range(1, 7)] + [1.0], np.float32)[:, None, None]
    want, tail = [w[0][:24]], w[0][-8:]
    for d in w[1:]:
        want += [tail * (1 - fade) + d[2:10] * fade, d[10:24]]
        tail = d[-8:]
    want = np.concatenate(want + [tail])[:len(frames)]
    assert len(windows) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(want.max()))


# ---- EXR -----------------------------------------------------------------------

def _depth(seed=0):
    d = (10 * np.random.default_rng(seed).random((37, 53))).astype(np.float32)
    d[5:20, 10:30] = 3.0     # a flat patch: ZIP has something to gain
    return d


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_interchange_with_jax(tmp_path, compression):
    d = _depth()
    tp, jp = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    texr.write_exr_z(tp, d, compression)
    jexr.write_exr_z(jp, d, compression)
    np.testing.assert_array_equal(jexr.read_exr_z(tp), d)
    np.testing.assert_array_equal(texr.read_exr_z(jp), d)
    np.testing.assert_array_equal(texr.read_exr_z(tp), d)
    with open(tp, "rb") as f:
        head = f.read(400)
    cid = head[head.index(b"compression\x00compression\x00") + 28]
    assert cid == texr.COMPRESSION_IDS[compression]
    if compression != "none":   # smaller than the same frame uncompressed
        texr.write_exr_z(str(tmp_path / "raw.exr"), d, "none")
        assert os.path.getsize(tp) < os.path.getsize(tmp_path / "raw.exr")


def test_exr_batch_writes_every_frame(tmp_path):
    ds = np.stack([_depth(i) for i in range(3)])
    paths = [str(tmp_path / f"frame_{i:05d}.exr") for i in range(3)]
    texr.write_exr_batch(paths, ds, compression="zip")
    for p, d in zip(paths, ds):
        np.testing.assert_array_equal(jexr.read_exr_z(p), d)
    with pytest.raises(ValueError):
        texr.write_exr_batch(paths[:2], ds)


def test_exr_raises_where_jax_writes_uncompressed(tmp_path, monkeypatch):
    """Without its ZIP codec the JAX writer quietly writes an uncompressed
    file; the port raises and writes nothing."""
    from video_depth_anything_tpu import native
    d = _depth()
    monkeypatch.setattr(native, "load", lambda: None)
    jp = str(tmp_path / "j.exr")
    jexr.write_exr_z(jp, d, compression="zip")
    texr.write_exr_z(str(tmp_path / "raw.exr"), d, "none")
    assert open(jp, "rb").read() == open(tmp_path / "raw.exr", "rb").read()   # uncompressed
    monkeypatch.setitem(sys.modules, "zlib", None)
    tp = str(tmp_path / "t.exr")
    with pytest.raises(RuntimeError, match="zlib"):
        texr.write_exr_z(tp, d, compression="zip")
    assert not os.path.exists(tp) and not os.path.exists(tp + ".tmp")
    with pytest.raises(ValueError, match="compression"):
        texr.write_exr_z(tp, d, compression="piz")


# ---- checkpoints -----------------------------------------------------------------

@pytest.fixture(scope="module")
def vits_npz(tmp_path_factory):
    cfg = j_config("vits", num_frames=4)
    params = perturbed_params(cfg)
    path = str(tmp_path_factory.mktemp("ckpt") / "video_depth_anything_vits.npz")
    jparams_io.save_params(path, jax.tree.map(jnp.asarray, params))
    return cfg, params, path


def test_npz_checkpoint_loads_strict_and_matches_jax(vits_npz):
    """A JAX ``save_params`` file: read with NumPy, unflattened, converted
    and loaded with strict=True; its forward matches JAX at 1e-4."""
    cfg, params, path = vits_npz
    flat = tparams_io.load_params(path)
    assert sorted(flatten_tree(flat)) == sorted(jparams_io.flatten_tree(params))
    model = load_checkpoint(build_model(t_config("vits", num_frames=4)), path)
    x = np.random.default_rng(2).standard_normal((1, 4, 56, 56, 3)).astype(np.float32)
    ref = np.asarray(jvd.forward(jax.tree.map(jnp.asarray, jparams_io.load_params(path)),
                                 jnp.asarray(x), cfg, use_pallas=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    atol = 1e-4 * max(float(ref.max() - ref.min()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


def test_checkpoint_lookup_npz_before_pth(tmp_path):
    d = str(tmp_path)
    assert tparams_io.resolve_checkpoint("vits", checkpoint_dir=d) is None
    for name in ("video_depth_anything_vits.pth", "metric_video_depth_anything_vitl.pth"):
        open(os.path.join(d, name), "wb").close()
    for enc, metric in (("vits", False), ("vitl", True), ("vitl", False)):
        assert tparams_io.resolve_checkpoint(enc, metric, d) == \
            jparams_io.resolve_checkpoint(enc, metric, d)
    assert tparams_io.resolve_checkpoint("vits", False, d).endswith("vits.pth")
    open(os.path.join(d, "video_depth_anything_vits.npz"), "wb").close()
    assert tparams_io.resolve_checkpoint("vits", False, d).endswith("vits.npz")
    assert tparams_io.resolve_checkpoint("vitl", True, d).endswith("metric_video_depth_anything_vitl.pth")
    assert tparams_io.resolve_checkpoint("vits", False, d) == jparams_io.resolve_checkpoint("vits", False, d)


# ---- point clouds -----------------------------------------------------------------

def test_unproject_depth_equals_jax():
    depth = _depth()
    color = np.random.default_rng(3).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for c in (color, None):
        tp, tc = tpc.unproject_depth(depth, 470.4, 300.0, c)
        jp, jc = jpc.unproject_depth(depth, 470.4, 300.0, c)
        np.testing.assert_array_equal(tp, jp)
        assert (tc is None) == (jc is None)
        if tc is not None:
            np.testing.assert_array_equal(tc, jc)


def test_ply_round_trip_and_bytes_equal_jax(tmp_path):
    depth = _depth()
    color = np.random.default_rng(4).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    pts, cols = tpc.unproject_depth(depth, 470.4, 470.4, color)
    for c in (cols, None):
        tp, jp = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
        tpc.write_ply(tp, pts, c)
        jpc.write_ply(jp, pts, c)
        assert open(tp, "rb").read() == open(jp, "rb").read()
        rp, rc = tpc.read_ply(tp)
        np.testing.assert_array_equal(rp, pts.astype(np.float32))
        if c is None:
            assert rc is None
        else:
            np.testing.assert_array_equal(rc, np.round(c * 255) / 255)


# ---- decode backend ------------------------------------------------------------------

def test_decode_backend_resolution(monkeypatch):
    monkeypatch.delenv("VDA_DECODE_BACKEND", raising=False)
    assert tvio.resolve_backend(None) == jvio._resolve_backend(None) == "cv2"
    assert tvio.resolve_backend("cv2") == "cv2"
    monkeypatch.setenv("VDA_DECODE_BACKEND", "cv2")
    assert tvio.resolve_backend(None) == jvio._resolve_backend(None) == "cv2"
    for where in ("arg", "env"):
        monkeypatch.setenv("VDA_DECODE_BACKEND", "decord" if where == "env" else "cv2")
        with pytest.raises(ValueError, match="decode backend"):
            tvio.resolve_backend("decord" if where == "arg" else None)


def test_ffmpeg_backend_without_imageio_ffmpeg_raises(monkeypatch, tmp_path):
    """Named by argument or by VDA_DECODE_BACKEND, ffmpeg without
    imageio_ffmpeg raises an error naming the package (the JAX package
    falls back to cv2 for the environment variable); no decode runs."""
    monkeypatch.setitem(sys.modules, "imageio_ffmpeg", None)
    monkeypatch.delenv("VDA_DECODE_BACKEND", raising=False)
    with pytest.raises(ImportError, match="imageio_ffmpeg"):
        tvio.resolve_backend("ffmpeg")
    monkeypatch.setenv("VDA_DECODE_BACKEND", "ffmpeg")
    with pytest.raises(ImportError, match="imageio_ffmpeg"):
        tvio.resolve_backend(None)
    with pytest.warns(UserWarning):
        assert jvio._resolve_backend(None) == "cv2"
    with pytest.raises(ImportError, match="imageio_ffmpeg"):
        tvio.read_video_frames(str(tmp_path / "missing.mp4"))
    with pytest.raises(ImportError, match="imageio_ffmpeg"):
        tvio.stream_video_frames(str(tmp_path / "missing.mp4"), decode_backend="ffmpeg")


# ---- device probe ----------------------------------------------------------------------

@pytest.mark.parametrize("budget", [0, -1.0, float("nan")])
def test_probe_non_positive_budget_is_an_error(budget):
    calls = []
    err = platform_env.device_unreachable(budget, probe=lambda: calls.append(1))
    assert err is not None and "positive" in err and not calls


def test_probe_hang_returns_an_error_within_its_budget():
    t0 = time.perf_counter()
    err = platform_env.device_unreachable(0.3, probe=lambda: time.sleep(30))
    assert err is not None and "0.3" in err
    assert time.perf_counter() - t0 < 5.0


def test_probe_reports_the_probes_error_and_passes_a_healthy_card():
    def fails():
        raise RuntimeError("driver said no")

    assert "driver said no" in platform_env.device_unreachable(5.0, probe=fails)
    assert platform_env.device_unreachable(5.0, probe=lambda: None) is None
    if not torch.cuda.is_available():   # the default probe: CUDA init and one launch
        assert "is_available" in platform_env.device_unreachable(30.0)
