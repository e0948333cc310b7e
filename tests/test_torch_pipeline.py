"""The port's VideoDepthPipeline against the JAX package's, on the CPU.

A 50-frame synthetic video (3 windows, so two stitching steps run) goes
through both pipelines with the same weights (init_params(0) perturbed as
in test_torch_model.py). Tolerances: fp32 rtol 1e-3 and atol 1e-4 * max(
depth range, 1), as for the full forward; the port's keyframe cache
against its cache-off path at 1e-6 (the JAX package's own cache test); the
port's bf16 run against the JAX fp32 run within the utils/precision.py
drift budget.
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
from video_depth_anything_tpu.utils.precision import (MAX_ERR_FRAC, MEAN_ERR_FRAC,
                                                      precision_drift_report)
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.convert import model_from_params
from video_depth_anything_torch.models import build_model
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.utils.precision import synthetic_video

from test_torch_model import perturbed_params

INPUT_SIZE = 56


@pytest.fixture(scope="module")
def setup():
    cfg = j_config("vits")
    params = perturbed_params(cfg)
    frames = synthetic_video(n=50, hw=(70, 98), seed=3)
    jpipe = JaxPipeline(cfg, jax.tree.map(jnp.asarray, params), use_pallas=False)
    ref, _ = jpipe.infer_video_depth(frames, input_size=INPUT_SIZE, fp32=True)
    pipe = VideoDepthPipeline(t_config("vits"), model_from_params(params, t_config("vits")),
                              device="cpu")
    return pipe, frames, np.asarray(ref)


@pytest.fixture(scope="module")
def cached_fp32(setup):
    pipe, frames, _ = setup
    return pipe.infer_video_depth(frames, target_fps=24, input_size=INPUT_SIZE, fp32=True)


def test_pipeline_matches_jax(setup, cached_fp32):
    _, frames, ref = setup
    got, fps = cached_fp32
    assert fps == 24
    assert got.shape == ref.shape == frames.shape[:3] and got.dtype == np.float32
    atol = 1e-4 * max(float(ref.max() - ref.min()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol)


def test_keyframe_cache_matches_cache_off(setup, cached_fp32):
    pipe, frames, _ = setup
    off, _ = pipe.infer_video_depth(frames, target_fps=24, input_size=INPUT_SIZE, fp32=True,
                                    cache_keyframe_features=False)
    np.testing.assert_allclose(cached_fp32[0], off, rtol=1e-6, atol=1e-6)


def test_bf16_pipeline_within_drift_budget(setup):
    pipe, frames, ref = setup
    got, _ = pipe.infer_video_depth(frames, input_size=INPUT_SIZE)   # bf16 default
    assert np.isfinite(got).all()
    rep = precision_drift_report(got, ref)
    assert rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC, rep


def test_short_video_single_window(setup):
    pipe, frames, _ = setup
    got, _ = pipe.infer_video_depth(frames[:5], input_size=INPUT_SIZE, fp32=True)
    assert got.shape == (5, 70, 98) and np.isfinite(got).all()


def test_no_silent_cpu():
    """With no device given and no CUDA present, the pipeline raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = t_config("vits")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoDepthPipeline(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoDepthPipeline(cfg, model, device="cuda")
