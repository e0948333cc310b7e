"""The port's long-video path against the JAX package, on the CPU.

A toy model (ViTConfig(64, depth 2, 2 heads), features 32, taps 0, 0, 1, 1,
the JAX package's tests/test_streaming.py config) with init_params(0)
weights, perturbed as in test_torch_model.py and carried across, runs
42x56 synthetic videos at input 28 through both pipelines.

Tolerances: port against JAX in fp32 rtol 1e-3, atol 1e-4 * max(depth
range, 1) (test_torch_pipeline.py's bound for the sequential mode); the
batched cache against the port's sequential cache 1e-5 and against its
cache-off batched path 1e-6 (the JAX package's own bounds,
tests/test_pipeline_parity.py). Streaming equals the batch API with the
same windows_per_batch bit for bit (the same launches on the same shapes),
except where the batch API drops C to its one window (n = 10 at C = 2),
where JAX's own bound holds (rtol 1e-4, atol 1e-5). int8 on the
JAX-written side file is held to twice its flip floor of JAX int8, and
the port's int8 modes to each other at JAX's bound for int8 runs on the
same scales (rtol 2e-4, atol 2e-4). The fp16 depth
transport is held within 2^-10 of max |d| of the fp32 transport. The
video_io copies are held to the JAX functions on the same inputs.
"""
import os
import threading
import time
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_depth_anything_tpu.config import ModelConfig as JModelConfig
from video_depth_anything_tpu.config import ViTConfig as JViTConfig
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
from video_depth_anything_tpu.utils import video_io as jvio
from video_depth_anything_torch.config import ModelConfig, ViTConfig
from video_depth_anything_torch.convert import model_from_params
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.pipeline import infer as tinfer
from video_depth_anything_torch.utils import profiling
from video_depth_anything_torch.utils import video_io as tvio
from video_depth_anything_torch.utils.precision import flip_floor_report, synthetic_video

from test_torch_model import perturbed_params

INPUT = 28
HW = (42, 56)
J_CFG = JModelConfig(encoder="_tinytorchstream",
                     vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2),
                     features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
T_CFG = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2),
                    features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: beside the JAX CPU client's device threads the
    default (one per core) oversubscribes the cores, and the port's calls
    take 10-30x longer."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    return perturbed_params(J_CFG)


@pytest.fixture(scope="module")
def jpipe(params):
    return JaxPipeline(J_CFG, jax.tree.map(jnp.asarray, params), use_pallas=False)


@pytest.fixture(scope="module")
def model(params):
    return model_from_params(params, T_CFG)


@pytest.fixture(scope="module")
def pipe(model):
    return VideoDepthPipeline(T_CFG, model, device="cpu")


@pytest.fixture(scope="module")
def video():
    return synthetic_video(n=100, hw=HW, seed=6)


def _stream(p, frames, **kw):
    return np.concatenate(list(p.infer_video_depth_streaming(iter(frames), input_size=INPUT, **kw)))


def _close_to_jax(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    atol = 1e-4 * max(float(ref.max() - ref.min()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol)


@pytest.mark.parametrize("c", [2, 4])
def test_batched_cache_matches_jax(pipe, jpipe, video, c):
    """100 frames = 5 windows: C = 2 runs chunks of 2, 2, 1 and C = 4 of 4, 1
    (the tail chunk shorter than C)."""
    ref, _ = jpipe.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=c)
    got, _ = pipe.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=c)
    _close_to_jax(got, np.asarray(ref))


@pytest.mark.parametrize("c", [2, 4])
def test_batched_cache_matches_sequential_and_cache_off(pipe, video, c):
    on, _ = pipe.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=c)
    off, _ = pipe.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=c,
                                    cache_keyframe_features=False)
    np.testing.assert_allclose(on, off, rtol=1e-6, atol=1e-6)
    seq, _ = pipe.infer_video_depth(video, input_size=INPUT, fp32=True)
    np.testing.assert_allclose(on, seq, rtol=1e-5, atol=1e-5)


def test_plain_batched_matches_jax(pipe, jpipe, video):
    ref, _ = jpipe.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=2,
                                     cache_keyframe_features=False)
    got, _ = pipe.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=2,
                                    cache_keyframe_features=False)
    _close_to_jax(got, np.asarray(ref))


@pytest.mark.parametrize("n", [10, 23, 32, 49, 50, 54])
def test_streaming_matches_batch(pipe, video, n):
    frames = video[:n]
    ref, _ = pipe.infer_video_depth(frames, input_size=INPUT)
    got = _stream(pipe, frames)
    assert got.shape == ref.shape == (n, *HW)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [10, 49, 50, 100])
def test_chunked_streaming_matches_batch(pipe, video, n):
    frames = video[:n]
    ref, _ = pipe.infer_video_depth(frames, input_size=INPUT, fp32=True, windows_per_batch=2)
    got = _stream(pipe, frames, fp32=True, windows_per_batch=2)
    assert got.shape == ref.shape == (n, *HW)
    if n > 22:   # both run the same C = 2 chunks
        np.testing.assert_array_equal(got, ref)
    else:        # one window: the batch API drops C to 1, the sequential cache
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c", [1, 2])
def test_streaming_matches_jax_streaming(pipe, jpipe, video, c):
    frames = video[:54]
    ref = np.concatenate(list(jpipe.infer_video_depth_streaming(
        iter(frames), input_size=INPUT, fp32=True, windows_per_batch=c)))
    _close_to_jax(_stream(pipe, frames, fp32=True, windows_per_batch=c), ref)


def test_fully_resident_chunk_skips_the_encode(model, video):
    """n = 49 at C = 2: the last chunk's rows all clamp to frame 48, which is
    resident, so it encodes nothing (an empty batch is no launch for K1)."""
    pipe = VideoDepthPipeline(T_CFG, model, device="cpu")
    batches = []
    encode = pipe.model.encode

    def spy(x):
        batches.append(x.shape[0])
        return encode(x)

    pipe.model.encode = spy
    try:
        ref, _ = pipe.infer_video_depth(video[:49], input_size=INPUT, fp32=True, windows_per_batch=2)
        assert batches == [49]   # chunk 0 (frames 0..48); none for chunk 1
        got = _stream(pipe, video[:49], fp32=True, windows_per_batch=2)
        assert batches[1:] == batches[:1]
    finally:
        del pipe.model.encode
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("c", [1, 2])
def test_streaming_int8_matches_batch_int8(model, video, c):
    p8 = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8")
    frames = video[:50]
    ref, _ = p8.infer_video_depth(frames, input_size=INPUT, windows_per_batch=c)
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(_stream(p8, frames, windows_per_batch=c), ref)


def test_int8_runs_every_mode(model, video):
    """The int8 model (one pipeline: the same scales) in the batched cache
    against its sequential cache, and the plain batched mode against the
    plain mode one window at a time, at the JAX package's own bound for
    int8 runs on identical scales (tests/test_quant.py, rtol 2e-4, atol
    2e-4): a wrong gather or wrong resident features would show."""
    p8 = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8")
    seq, _ = p8.infer_video_depth(video, input_size=INPUT, fp32=True)
    plain, _ = p8.infer_video_depth(video, input_size=INPUT, fp32=True,
                                    cache_keyframe_features=False)
    for c in (2, 4):
        for cache, ref in ((True, seq), (False, plain)):
            got, _ = p8.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=c,
                                          cache_keyframe_features=cache)
            assert got.shape == ref.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, err_msg=f"C={c} {cache}")


@pytest.fixture(scope="module")
def jpipe8(params, tmp_path_factory):
    """JAX int8; its first call calibrates on the video's first window and
    writes the side file that the port then reads."""
    path = str(tmp_path_factory.mktemp("calib") / "jax.int8calib.npz")
    return JaxPipeline(J_CFG, jax.tree.map(jnp.asarray, params), use_pallas=False,
                       quant="int8", calib_path=path)


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("c", [2, 4])
def test_int8_batched_matches_jax_int8(model, jpipe8, video, c, cache, monkeypatch, tmp_path):
    """The port's int8 batched cache and plain batched mode against JAX's on
    the JAX-written side file (identical scales; the port never
    calibrates), fp32 activations, held to twice the flip floor
    (utils/precision.py::flip_floor_report, as test_torch_quant.py holds
    the sequential mode): the floor is the port's own run with every absmax
    scaled by 1 + 1e-6."""
    kw = dict(input_size=INPUT, fp32=True, windows_per_batch=c, cache_keyframe_features=cache)
    ref, _ = jpipe8.infer_video_depth(video, **kw)

    def boom(*a, **k):
        raise AssertionError("calibration ran despite a matching side file")

    monkeypatch.setattr(type(model), "calibrate_stats", boom)
    nudged = str(tmp_path / "nudged.int8calib.npz")
    tinfer.scale_side_file(jpipe8.calib_path, nudged, 1 + 1e-6)
    got, floor = (VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8", calib_path=path)
                  .infer_video_depth(video, **kw)[0] for path in (jpipe8.calib_path, nudged))
    assert got.shape == ref.shape and np.isfinite(got).all()
    rep = flip_floor_report(np.asarray(ref), got, floor)
    assert rep["ok"], rep


@pytest.mark.parametrize("c", [1, 2])
def test_transfer_fp16(model, pipe, video, c):
    hp = VideoDepthPipeline(T_CFG, model, device="cpu", transfer_fp16=True)
    frames = video[:50]
    ref, _ = pipe.infer_video_depth(frames, input_size=INPUT, windows_per_batch=c)
    got, _ = hp.infer_video_depth(frames, input_size=INPUT, windows_per_batch=c)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2.0 ** -10 * np.abs(ref).max()
    assert not np.array_equal(got, ref)   # the transport did round
    np.testing.assert_array_equal(_stream(hp, frames, windows_per_batch=c), got)


def test_transfer_fp16_single_window_tail_is_rounded(model, video):
    hp = VideoDepthPipeline(T_CFG, model, device="cpu", transfer_fp16=True)
    got, _ = hp.infer_video_depth(video[:12], input_size=INPUT)
    np.testing.assert_array_equal(got, got.astype(np.float16).astype(np.float32))


def test_window_timer_spans(model, video):
    p = VideoDepthPipeline(T_CFG, model, device="cpu")
    assert p.timer is None
    p.infer_video_depth(video, input_size=INPUT, fp32=True, windows_per_batch=2,
                        collect_timings=True)
    summary = p.timer.summary()
    assert set(summary) == {"window_forward", "gather_upload"}
    for name, s in summary.items():
        assert s["count"] == 3, (name, s)        # chunks of 2, 2, 1 windows
        assert set(s) == {"count", "mean_ms", "p50_ms", "p95_ms", "total_ms"}
        assert 0 <= s["p50_ms"] <= s["p95_ms"] <= s["total_ms"]
    assert summary["gather_upload"]["total_ms"] <= summary["window_forward"]["total_ms"]
    p.infer_video_depth(video[:30], input_size=INPUT)
    assert p.timer is None


def test_window_timer_summary_matches_jax():
    from video_depth_anything_tpu.utils.profiling import WindowTimer as JTimer

    jt, tt = JTimer(), profiling.WindowTimer()
    for t in (jt, tt):
        t.samples = {"a": [0.003, 0.001, 0.002], "b": [0.01]}
    assert tt.summary() == jt.summary()


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


# ---- video_io copies -------------------------------------------------------

def _write_clip(path, frames, fps=10):
    cv2 = pytest.importorskip("cv2")
    h, w = frames.shape[1:3]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    wr.release()


def test_depth_spool_matches_jax_and_is_bounded(tmp_path):
    rng = np.random.default_rng(0)
    chunks = [rng.standard_normal((10, 64, 64)).astype(np.float32) for _ in range(100)]
    ref = np.concatenate(chunks)
    jspool = jvio.DepthSpool(str(tmp_path / "j.f32"))
    for c in chunks:
        jspool.append(c)
    jmm = jspool.finish()

    spool = tvio.DepthSpool(str(tmp_path / "t.f32"))
    tracemalloc.start()
    for c in chunks:
        spool.append(c)
    mm = spool.finish()
    total = 0.0
    for i in range(0, len(mm), 16):
        total += float(np.asarray(mm[i:i + 16]).sum())
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 4 * 1024 * 1024, f"peak {peak} bytes: not bounded"
    assert mm.shape == jmm.shape == ref.shape
    np.testing.assert_array_equal(np.asarray(mm), np.asarray(jmm))
    assert (spool.min, spool.max) == (jspool.min, jspool.max) == (float(ref.min()), float(ref.max()))
    np.testing.assert_array_equal(
        tvio.depth_visualization(ref[:4], value_range=(spool.min, spool.max)),
        jvio.depth_visualization(ref[:4], value_range=(jspool.min, jspool.max)))
    np.testing.assert_array_equal(
        tvio.depth_visualization(ref[:4], value_range=(spool.min, spool.max)),
        tvio.depth_visualization(ref)[:4])
    del mm, jmm
    spool.cleanup()
    jspool.cleanup()
    assert not os.path.exists(spool.path)
    empty = tvio.DepthSpool(str(tmp_path / "e.f32"))
    assert empty.finish().shape == (0, 0, 0)
    empty.cleanup()


def test_incremental_writer_equals_save_video(tmp_path):
    pytest.importorskip("cv2")
    frames = synthetic_video(n=9, hw=(32, 48))
    a, b, j = (str(tmp_path / f"{x}.mp4") for x in "abj")
    tvio.save_video(frames, a, fps=10)
    with tvio.IncrementalVideoWriter(b, fps=10) as w:
        for f in frames:
            w.append(f)
    with jvio.IncrementalVideoWriter(j, fps=10) as w:
        for f in frames:
            w.append(f)
    fa, _ = tvio.read_video_frames(a)
    fb, _ = tvio.read_video_frames(b)
    fj, _ = jvio.read_video_frames(j)
    assert fa.shape == fb.shape == fj.shape == (9, 32, 48, 3)
    np.testing.assert_array_equal(fb, fa)   # the same encoder on the same frames
    assert np.mean(np.abs(fb.astype(np.int16) - fj.astype(np.int16))) < 2.0


def test_stream_video_frames_round_trip(tmp_path):
    frames = synthetic_video(n=12, hw=(32, 48))
    path = str(tmp_path / "clip.mp4")
    _write_clip(path, frames)
    batch, fps_a = tvio.read_video_frames(path)
    it, fps_b, hw = tvio.stream_video_frames(path)
    streamed = np.stack(list(it))
    jit, fps_j, jhw = jvio.stream_video_frames(path)
    assert fps_a == fps_b == fps_j and hw == jhw == (32, 48)
    np.testing.assert_array_equal(streamed, batch)
    np.testing.assert_array_equal(streamed, np.stack(list(jit)))
    # fps stride, max_res and max_len, as read_video_frames applies them
    it, _, hw = tvio.stream_video_frames(path, 4, 5, 24)
    want, _ = tvio.read_video_frames(path, 4, 5, 24)
    assert hw == want.shape[1:3]
    np.testing.assert_array_equal(np.stack(list(it)), want)


def test_stream_video_frames_abandoned_releases_decoder(tmp_path):
    frames = synthetic_video(n=40, hw=(32, 48))
    path = str(tmp_path / "v.mp4")
    _write_clip(path, frames)
    before = {t.ident for t in threading.enumerate()}
    it, _, _ = tvio.stream_video_frames(path, prefetch=2)
    next(it)
    it.close()
    it2, _, _ = tvio.stream_video_frames(path, prefetch=2)
    del it2                      # never started: the finalizer releases it
    deadline = time.time() + 5.0
    extra = []
    while time.time() < deadline:
        extra = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"decoder thread leaked: {extra}"


def test_save_depth_video_streamed_matches_jax_and_save_video(tmp_path):
    pytest.importorskip("cv2")
    depths = np.random.default_rng(1).standard_normal((9, 32, 48)).astype(np.float32)
    a, b, j = (str(tmp_path / f"{x}.mp4") for x in "abj")
    tvio.save_video(depths, a, fps=10, is_depths=True)
    spool = tvio.DepthSpool(str(tmp_path / "d.f32"))
    for i in range(0, 9, 4):
        spool.append(depths[i:i + 4])
    mm = spool.finish()
    tvio.save_depth_video_streamed(mm, b, 10, (spool.min, spool.max), chunk_frames=4)
    jvio.save_depth_video_streamed(depths, j, 10, (spool.min, spool.max), chunk_frames=4)
    fa, _ = tvio.read_video_frames(a)
    fb, _ = tvio.read_video_frames(b)
    fj, _ = jvio.read_video_frames(j)
    np.testing.assert_array_equal(fb, fa)
    assert np.mean(np.abs(fb.astype(np.int16) - fj.astype(np.int16))) < 2.0
    del mm
    spool.cleanup()
