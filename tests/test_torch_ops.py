"""The port's ops (ops/nn.py, ops/resize.py, pipeline preprocessing,
windows and stitching) against the JAX package's, in fp32 on the CPU.

Inputs are made with NumPy from a seed and handed to both. Tolerance:
rtol = atol = 1e-4 per op.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.ops import nn as jnn
from video_depth_anything_tpu.ops import resize as jresize
from video_depth_anything_tpu.pipeline import preprocess as jpre
from video_depth_anything_tpu.pipeline import stitch as jstitch
from video_depth_anything_tpu.pipeline.windows import window_indices as j_window_indices
from video_depth_anything_torch.ops import nn as tnn
from video_depth_anything_torch.ops import resize as tresize
from video_depth_anything_torch.pipeline import preprocess as tpre
from video_depth_anything_torch.pipeline import stitch as tstitch
from video_depth_anything_torch.pipeline.windows import window_indices as t_window_indices

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm(eps):
    x, w, b = _rand((3, 7, 48), 0, 3.0), _rand((48,), 1), _rand((48,), 2)
    ref = jnn.layer_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), eps)
    np.testing.assert_allclose(tnn.layer_norm(_t(x), _t(w), _t(b), eps).numpy(),
                               np.asarray(ref), **TOL)


def test_group_norm():
    x, w, b = _rand((2, 5, 6, 64), 3, 2.0), _rand((64,), 4), _rand((64,), 5)
    ref = jnn.group_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x),
                         num_groups=32, eps=1e-6)
    np.testing.assert_allclose(tnn.group_norm(_t(x), _t(w), _t(b), 32, 1e-6).numpy(),
                               np.asarray(ref), **TOL)


def test_gelu_and_linear():
    x, w, b = _rand((4, 9, 16), 6, 2.0), _rand((16, 24), 7), _rand((24,), 8)
    np.testing.assert_allclose(tnn.gelu(_t(x)).numpy(), np.asarray(jnn.gelu(jnp.asarray(x))),
                               **TOL)
    ref = jnn.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(tnn.linear(_t(x), _t(w.T), _t(b)).numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (1, 1, 0), (3, 2, 1), (14, 14, 0)])
def test_conv2d(k, stride, pad):
    x, w, b = _rand((2, 28, 28, 6), 9), _rand((k, k, 6, 5), 10, 0.2), _rand((5,), 11)
    ref = jnn.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     stride=stride, padding=pad)
    got = tnn.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride=stride, padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stride", [2, 4])
def test_conv_transpose2d(stride):
    x = _rand((2, 5, 6, 8), 12)
    w = _rand((stride, stride, 7, 8), 13, 0.3)   # JAX HWOI
    b = _rand((7,), 14)
    ref = jnn.conv_transpose2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                               stride)
    got = tnn.conv_transpose2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n_in,n_out,scale", [(37, 518, None), (50, 23, None), (37, 16, 0.44)])
def test_resize_matrices_equal(n_in, n_out, scale):
    np.testing.assert_array_equal(tresize.cubic_resize_matrix(n_in, n_out, scale),
                                  jresize.cubic_resize_matrix(n_in, n_out, scale))
    np.testing.assert_array_equal(tresize.linear_resize_matrix(n_in, n_out),
                                  jresize.linear_resize_matrix(n_in, n_out, True))


def test_resizes():
    x = _rand((3, 9, 13, 4), 15)
    ref = jresize.resize_bilinear_align_corners(jnp.asarray(x), (20, 7))
    np.testing.assert_allclose(tresize.resize_bilinear_align_corners(_t(x), (20, 7)).numpy(),
                               np.asarray(ref), **TOL)
    ref = jresize.resize_bicubic_half_pixel(jnp.asarray(x), (14, 28))
    np.testing.assert_allclose(tresize.resize_bicubic_half_pixel(_t(x), (14, 28)).numpy(),
                               np.asarray(ref), **TOL)


def test_preprocess():
    frames = np.random.default_rng(16).integers(0, 256, (3, 30, 41, 3), dtype=np.uint8)
    for hw in [(30, 41), (480, 640), (1080, 1920)]:
        for size in (518, 112, 28):
            eff = tpre.effective_input_size(*hw, size)
            assert eff == jpre.effective_input_size(*hw, size)
            assert tpre.network_input_hw(*hw, eff) == jpre.network_input_hw(*hw, eff)
    net = tpre.network_input_hw(30, 41, 28)
    ref = jpre.preprocess_frames(jnp.asarray(frames), net)
    np.testing.assert_allclose(tpre.preprocess_frames(_t(frames), net).numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("n", [1, 5, 32, 50, 100])
def test_window_indices(n):
    np.testing.assert_array_equal(t_window_indices(n), j_window_indices(n))


@pytest.mark.parametrize("metric", [False, True])
def test_stitching(metric):
    d0, d1 = np.abs(_rand((32, 6, 7), 17)), np.abs(_rand((32, 6, 7), 18)) * 2 + 0.5
    jc, je0 = jstitch.stitch_first(jnp.asarray(d0))
    tc, te0 = tstitch.stitch_first(_t(d0))
    np.testing.assert_array_equal(te0.numpy(), np.asarray(je0))
    jc, je1 = jstitch.stitch_step(jc, jnp.asarray(d1), metric=metric)
    tc, te1 = tstitch.stitch_step(tc, _t(d1), metric=metric)
    np.testing.assert_allclose(te1.numpy(), np.asarray(je1), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    flat = np.zeros((2, 6, 7), np.float32)   # degenerate fit: identity
    s, sh = tstitch.compute_scale_and_shift(_t(flat), _t(d1[:2]))
    assert float(s) == 1.0 and float(sh) == 0.0
