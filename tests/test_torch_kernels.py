"""The port's attention kernels (K1 spatial, K2 temporal, K3 int8-QK
spatial) against the JAX package: their plain versions on the CPU against
the Pallas kernels in interpret mode and the XLA forms. The CUDA kernels
themselves are held against these plain versions on the card by
test_torch_cuda.py and chip_smoke.py.

Tolerance: fp32, rtol = atol = 1e-4 (the per-op tolerance of the port); K3,
whose scores are exact integers on both sides, 1e-5 in fp32 and 2e-2 with
bf16 v (the probabilities round to bf16 before PV, and the TPU kernel sums
the rounded ones for its denominator).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.ops.attention import _xla_mha, temporal_flat_attention
from video_depth_anything_tpu.ops.pallas_attention import (flash_attention_packed,
                                                           flash_attention_packed_qk8)
from video_depth_anything_tpu.ops.pallas_temporal_attention import temporal_flash_attention
from video_depth_anything_torch import kernels
from video_depth_anything_torch.kernels import spatial_attention as k1
from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3
from video_depth_anything_torch.kernels import temporal_attention as k2

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,s,h", [(2, 50, 2), (1, 130, 4)])
def test_spatial_plain_matches_jax(b, s, h):
    c = h * 64
    q, k, v = (_rand((b, s, c), i) for i in range(3))
    kernels.reset_launch_counts()
    got = k1.spatial_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), num_heads=h, scale=0.125)
    assert kernels.launch_counts()["spatial_attention"] == 0  # CPU: plain path
    pallas = flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    num_heads=h, scale=0.125, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)

    def heads(x):
        return jnp.asarray(x).reshape(b, s, h, 64).transpose(0, 2, 1, 3)

    xla = _xla_mha(heads(q), heads(k), heads(v), 0.125)
    xla = np.asarray(xla.transpose(0, 2, 1, 3).reshape(b, s, c))
    np.testing.assert_allclose(got.numpy(), xla, **TOL)


def test_spatial_plain_takes_fused_qkv_views():
    """The model passes column views of the fused qkv output (row stride
    3C); the result equals the contiguous inputs' exactly."""
    b, s, h = 2, 37, 2
    c = h * 64
    qkv = torch.from_numpy(_rand((b, s, 3 * c), 7))
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    assert q.stride() == (s * 3 * c, 3 * c, 1)
    got = k1.spatial_attention(q, k, v, num_heads=h, scale=0.125)
    ref = k1.spatial_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               num_heads=h, scale=0.125)
    assert got.is_contiguous() and got.shape == (b, s, c)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dh", [8, 24, 48, 32])
@pytest.mark.parametrize("t", [4, 32])
def test_temporal_plain_matches_jax(dh, t):
    p, h = 6, 8
    c = h * dh
    q, k, v = (_rand((p, t, c), 10 + i) for i in range(3))
    scale = dh ** -0.5
    kernels.reset_launch_counts()
    got = k2.temporal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), num_heads=h, scale=scale)
    assert kernels.launch_counts()["temporal_attention"] == 0
    pallas = temporal_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      num_heads=h, scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    flat = temporal_flat_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   num_heads=h, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(flat), **TOL)


def test_temporal_plain_bf16_matches_jax_flat_form():
    """bf16: the same roundings as the XLA flat form (q pre-scaled in bf16
    with a bf16 scale, probabilities rounded to bf16 before PV). Tolerance:
    one bf16 ulp of the output (2^-8 relative) plus the fp32 order of sums."""
    p, t, h, dh = 5, 32, 8, 24
    c = h * dh
    q, k, v = (_rand((p, t, c), 20 + i) for i in range(3))
    got = k2.temporal_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                num_heads=h, scale=dh ** -0.5)
    flat = temporal_flat_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                   num_heads=h, scale=dh ** -0.5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(flat, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_wrapper_checks_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 10, 64)      # two heads of 32: K1 takes dh = 64 only
    with pytest.raises(ValueError, match="head dim"):
        k1._check(x, x, x, num_heads=2)
    with pytest.raises(TypeError):
        k1._check(x.half(), x.half(), x.half(), num_heads=1)
    y = torch.zeros(3, 33, 64)      # 33 frames: K2 takes T <= 32
    with pytest.raises(ValueError, match="T=33"):
        k2._check(y, y, y, num_heads=8)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros(3, 4, 128)[..., :64]
        k2._check(z, z, z, num_heads=8)


def _qk8_inputs(b, s, h, seed):
    rng = np.random.default_rng(seed)
    c = h * 64
    q8, k8 = (rng.integers(-127, 128, (b, s, c)).astype(np.int8) for _ in range(2))
    v = rng.standard_normal((b, s, c)).astype(np.float32)
    scales = np.array([0.013 * 64 ** -0.5, 0.021], np.float32)  # (amax_q/127*dh^-0.5, amax_k/127)
    return q8, k8, v, scales


@pytest.mark.parametrize("s", [130, 300])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_qk8_plain_matches_jax_interpret(s, dtype, tol):
    q8, k8, v, scales = _qk8_inputs(2, s, 4, 7)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kernels.reset_launch_counts()
    got = k3.spatial_attention_qk8(torch.from_numpy(q8), torch.from_numpy(k8),
                                   torch.from_numpy(v).to(dtype), torch.from_numpy(scales),
                                   num_heads=4)
    assert kernels.launch_counts()["spatial_attention_qk8"] == 0   # CPU: plain path
    assert got.dtype == dtype and got.shape == v.shape
    want = flash_attention_packed_qk8(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v, jdt),
                                      jnp.asarray(scales), num_heads=4, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_qk8_odd_heads_take_the_dequantized_fallback():
    """h = 3 cannot pair heads: q and k dequantize into K1 at scale 1, on
    both sides."""
    q8, k8, v, scales = _qk8_inputs(1, 140, 3, 8)
    args = [torch.from_numpy(a) for a in (q8, k8, v, scales)]
    kernels.reset_launch_counts()
    got = k3.spatial_attention_qk8(*args, num_heads=3)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    ref = k1.spatial_attention(args[0].float() * args[3][0], args[1].float() * args[3][1],
                               args[2], num_heads=3, scale=1.0)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    want = flash_attention_packed_qk8(*(jnp.asarray(a) for a in (q8, k8, v, scales)),
                                      num_heads=3, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_qk8_wrapper_checks_reject_what_the_kernel_does_not_take():
    q8 = torch.zeros(2, 10, 128, dtype=torch.int8)
    v = torch.zeros(2, 10, 128)
    sc = torch.ones(2)
    k3._check(q8, q8, v, sc, num_heads=2)
    with pytest.raises(TypeError, match="int8"):
        k3._check(q8.float(), q8, v, sc, num_heads=2)
    with pytest.raises(ValueError, match="head dim"):
        k3._check(q8, q8, v, sc, num_heads=4)
    with pytest.raises(ValueError, match="scales"):
        k3._check(q8, q8, v, sc.double(), num_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros(2, 10, 256, dtype=torch.int8)[..., :128]
        k3._check(z, z, v, sc, num_heads=2)
    with pytest.raises(ValueError, match="innermost stride"):
        k3._check(q8, q8, torch.zeros(2, 128, 10).transpose(1, 2), sc, num_heads=2)
