"""The port's attention kernels (K1 spatial, K2 temporal, K3 int8-QK
spatial, K4 head-major, K5 fused-qkv) against the JAX package: their plain
versions on the CPU against the Pallas kernels in interpret mode and the
XLA forms, and the routes of head dims other than 64 (K1 and K3 into K4,
as the JAX wrappers fall back). The CUDA kernels themselves are held
against these plain versions on the card by test_torch_cuda.py and
chip_smoke.py.

Tolerance: fp32, rtol = atol = 1e-4 (the per-op tolerance of the port); K3,
whose scores are exact integers on both sides, 1e-5 in fp32 and 2e-2 with
bf16 v (the probabilities round to bf16 before PV, and the TPU kernel sums
the rounded ones for its denominator). K4 in bf16: 2^-7 of the reference's
max |o|, the same two differences (q pre-scaled in bf16 on both sides).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.ops.attention import _xla_mha, temporal_flat_attention
from video_depth_anything_tpu.ops.pallas_attention import (flash_attention,
                                                           flash_attention_packed,
                                                           flash_attention_packed_qk8,
                                                           flash_attention_qkv_fused)
from video_depth_anything_tpu.ops.pallas_temporal_attention import temporal_flash_attention
from video_depth_anything_torch import kernels
from video_depth_anything_torch.kernels import attention_head_major as k4
from video_depth_anything_torch.kernels import spatial_attention as k1
from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3
from video_depth_anything_torch.kernels import spatial_attention_qkv as k5
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


@pytest.mark.parametrize("dh", [8, 24, 48, 32, 16, 96, 128])
@pytest.mark.parametrize("t", [4, 32, 1, 7])
def test_temporal_plain_matches_jax(dh, t):
    """vits motion-module head dims (24, 48, 8), vitb's and vitl's (16, 96,
    128) and 32, at T = 32, 4 and the odd 1 and 7."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_zero_channels_change_nothing(dtype):
    """K2's wrapper pads a bf16 head dim that is not a multiple of 8 with
    zero channels per head around the launch and drops them after: on the
    plain version, the padded run's kept channels equal the unpadded run."""
    p, t, h, dh = 5, 7, 8, 4
    q, k, v = (torch.from_numpy(_rand((p, t, h * dh), 70 + i)).to(dtype) for i in range(3))
    want = k2.temporal_attention(q, k, v, num_heads=h, scale=dh ** -0.5)
    padded = k2.temporal_attention(*(k2.pad_heads(x, h, 8) for x in (q, k, v)), num_heads=h,
                                   scale=dh ** -0.5)
    assert padded.shape == (p, t, h * 8)
    got = padded.reshape(p, t, h, 8)[..., :dh].reshape(p, t, h * dh)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not padded.reshape(p, t, h, 8)[..., dh:].any()


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
    w = torch.zeros(2, 4, 2 * 520, dtype=torch.bfloat16)   # bf16 head dim over 512
    with pytest.raises(ValueError, match="head dim 520"):
        k2._check(w, w, w, num_heads=2)
    k2._check(w.float(), w.float(), w.float(), num_heads=2)   # fp32 takes any head dim


def _qk8_inputs(b, s, h, seed, dh=64):
    rng = np.random.default_rng(seed)
    c = h * dh
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


@pytest.mark.parametrize("b,h,s,d", [(2, 2, 130, 32), (1, 3, 77, 32), (1, 2, 100, 64),
                                     (1, 3, 150, 64), (1, 2, 70, 128), (1, 3, 90, 128)])
def test_head_major_plain_matches_jax(b, h, s, d):
    q, k, v = (_rand((b, h, s, d), 30 + i) for i in range(3))
    scale = d ** -0.5
    kernels.reset_launch_counts()
    got = k4.attention_head_major(*(torch.from_numpy(x) for x in (q, k, v)), scale=scale)
    assert kernels.launch_counts()["attention_head_major"] == 0   # CPU: plain path
    assert got.shape == (b, h, s, d)
    pallas = flash_attention(*(jnp.asarray(x) for x in (q, k, v)), scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    xla = _xla_mha(*(jnp.asarray(x) for x in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


def test_head_major_plain_bf16_matches_jax_interpret():
    """bf16 at dh = 32, where the pre-scale of q rounds (32^-0.5 is not a
    power of two): the port rounds q * scale to bf16 as the JAX wrapper
    does."""
    q, k, v = (_rand((2, 3, 130, 32), 40 + i) for i in range(3))
    got = k4.attention_head_major(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                  scale=32 ** -0.5)
    want = np.asarray(flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                      scale=32 ** -0.5, interpret=True), np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert got.dtype == torch.bfloat16 and err <= 2 ** -7 * np.abs(want).max(), err


def test_head_major_writes_split_head_views_in_place():
    """K1's route for dh != 64: split-head views of [B, S, C] in and out."""
    b, s, h, d = 2, 37, 4, 32
    qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 41))
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d] for i in range(3))
    out = torch.empty(b, s, h * d)
    heads = [x.reshape(b, s, h, d).transpose(1, 2) for x in (q, k, v, out)]
    got = k4.attention_head_major(*heads[:3], scale=d ** -0.5, out=heads[3])
    assert got is heads[3]
    ref = k4.attention_head_major(*(x.contiguous() for x in heads[:3]), scale=d ** -0.5)
    torch.testing.assert_close(out, ref.transpose(1, 2).reshape(b, s, h * d), rtol=0, atol=0)


@pytest.mark.parametrize("b,s,h", [(2, 50, 4), (1, 130, 3)])
def test_spatial_dh32_routes_to_head_major_as_jax(b, s, h):
    """K1 takes dh = 64 only; dh = 32 goes to K4, as flash_attention_packed
    falls back to flash_attention."""
    c = h * 32
    q, k, v = (_rand((b, s, c), 50 + i) for i in range(3))
    kernels.reset_launch_counts()
    got = k1.spatial_attention(*(torch.from_numpy(x) for x in (q, k, v)), num_heads=h,
                               scale=32 ** -0.5)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    assert got.is_contiguous() and got.shape == (b, s, c)
    want = flash_attention_packed(*(jnp.asarray(x) for x in (q, k, v)), num_heads=h,
                                  scale=32 ** -0.5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_qk8_dh32_routes_through_the_dequantized_fallback_as_jax(dtype, tol):
    """dh = 32: q and k dequantize into spatial_attention (K4 there), as
    flash_attention_packed_qk8 dequantizes into flash_attention_packed."""
    q8, k8, v, scales = _qk8_inputs(2, 130, 4, 9, dh=32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kernels.reset_launch_counts()
    got = k3.spatial_attention_qk8(torch.from_numpy(q8), torch.from_numpy(k8),
                                   torch.from_numpy(v).to(dtype), torch.from_numpy(scales),
                                   num_heads=4)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    want = flash_attention_packed_qk8(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v, jdt),
                                      jnp.asarray(scales), num_heads=4, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,d", [(2, 300, 6, 64), (1, 1370, 2, 64), (1, 64, 3, 64),
                                     (1, 100, 4, 32)])
def test_qkv_fused_plain_matches_jax(b, s, h, d):
    """tests/test_fused_qkv_attention.py's shapes (odd heads included) and
    a dh = 32 case (K4 in both packages); q pre-scaled in the array."""
    c = h * d
    q, k, v = (_rand((b, s, c), 60 + i) for i in range(3))
    qkv = np.concatenate([q * d ** -0.5, k, v], axis=-1)
    kernels.reset_launch_counts()
    got = k5.spatial_attention_qkv_fused(torch.from_numpy(qkv), num_heads=h)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    want = flash_attention_qkv_fused(jnp.asarray(qkv), num_heads=h, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(got, k5.spatial_attention_qkv_fused_plain(
        torch.from_numpy(qkv), num_heads=h), rtol=1e-6, atol=1e-6)


def test_head_major_check_rejects_what_k4_does_not_take():
    x = torch.zeros(2, 3, 10, 32)
    k4._check(x, x, x, x)
    for d in (12, 136):             # not a multiple of 8; over 128
        y = torch.zeros(2, 3, 10, d)
        with pytest.raises(ValueError, match="head dims"):
            k4._check(y, y, y, y)
    with pytest.raises(TypeError):
        k4._check(x.half(), x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="innermost stride"):
        z = torch.zeros(2, 3, 32, 10).transpose(2, 3)
        k4._check(z, z, z, z)


# The switches. JAX's two mxu_denom settings compute one function (both sum
# the probabilities after their cast to v's dtype: pallas_attention.py:113
# before :119, :397 before :413), which is the port's mxu_denom=True; so the
# port's plain versions with mxu_denom=True are held to the Pallas bodies
# in interpret mode under both JAX settings. S = 130 pads to 256 keys on
# the TPU side, S = 256 does not. bf16 within 4e-3, fp32 within 1e-5.
SWITCH_DTYPES = [(torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 4e-3)]


def _switch_inputs(shape, seed, dtype, jdt):
    x = [_rand(shape, seed + i) for i in range(3)]
    return [torch.from_numpy(a).to(dtype) for a in x], [jnp.asarray(a, jdt) for a in x]


def _held(got, want, tol):
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("s", [130, 256])
@pytest.mark.parametrize("jax_mxu_denom", [True, False])
@pytest.mark.parametrize("dtype,jdt,tol", SWITCH_DTYPES)
def test_k1_mxu_denom_plain_matches_jax_interpret(s, jax_mxu_denom, dtype, jdt, tol):
    (q, k, v), (qj, kj, vj) = _switch_inputs((2, s, 4 * 64), 80, dtype, jdt)
    kernels.reset_launch_counts()
    got = k1.spatial_attention(q, k, v, num_heads=4, scale=0.125, mxu_denom=True)
    assert kernels.launch_counts()["spatial_attention"] == 0   # CPU: plain version
    want = flash_attention_packed(qj, kj, vj, num_heads=4, scale=0.125,
                                  mxu_denom=jax_mxu_denom, interpret=True)
    _held(got, want, tol)


@pytest.mark.parametrize("s", [130, 256])
@pytest.mark.parametrize("jax_mxu_denom", [True, False])
@pytest.mark.parametrize("dtype,jdt,tol", SWITCH_DTYPES)
def test_k4_mxu_denom_plain_matches_jax_interpret(s, jax_mxu_denom, dtype, jdt, tol):
    """dh 32: JAX's ones column fits the matrix unit's 128 lanes (2 d <= 128)."""
    (q, k, v), (qj, kj, vj) = _switch_inputs((2, 3, s, 32), 84, dtype, jdt)
    got = k4.attention_head_major(q, k, v, scale=32 ** -0.5, mxu_denom=True)
    want = flash_attention(qj, kj, vj, scale=32 ** -0.5, mxu_denom=jax_mxu_denom, interpret=True)
    _held(got, want, tol)


@pytest.mark.parametrize("s", [130, 256])
@pytest.mark.parametrize("jax_mxu_denom", [True, False])
@pytest.mark.parametrize("dtype,jdt,tol", SWITCH_DTYPES)
def test_k5_mxu_denom_plain_matches_jax_interpret(s, jax_mxu_denom, dtype, jdt, tol):
    q, k, v = (_rand((2, s, 4 * 64), 88 + i) for i in range(3))
    qkv = np.concatenate([q * 0.125, k, v], axis=-1)
    got = k5.spatial_attention_qkv_fused(torch.from_numpy(qkv).to(dtype), num_heads=4,
                                         mxu_denom=True)
    want = flash_attention_qkv_fused(jnp.asarray(qkv, jdt), num_heads=4,
                                     mxu_denom=jax_mxu_denom, interpret=True)
    _held(got, want, tol)


@pytest.mark.parametrize("s", [130, 256])
@pytest.mark.parametrize("dtype,jdt,tol", SWITCH_DTYPES)
def test_k1_exp2_plain_matches_jax_interpret(s, dtype, jdt, tol):
    """exp2: q pre-scaled in its dtype by scale * log2(e), base-2
    exponentials; with JAX's default denominator (the port's mxu_denom)."""
    (q, k, v), (qj, kj, vj) = _switch_inputs((2, s, 4 * 64), 92, dtype, jdt)
    got = k1.spatial_attention(q, k, v, num_heads=4, scale=0.125, exp2=True, mxu_denom=True)
    want = flash_attention_packed(qj, kj, vj, num_heads=4, scale=0.125, exp2=True,
                                  interpret=True)
    _held(got, want, tol)


def test_exp2_switch_is_live_in_bf16():
    """In bf16, bf16(0.125 * log2(e)) rounds, so exp2=True changes outputs
    (as it does in JAX); in fp32 the two agree to rounding."""
    x = [torch.from_numpy(_rand((2, 130, 4 * 64), 96 + i)) for i in range(3)]
    for dtype, live in ((torch.bfloat16, True), (torch.float32, False)):
        a, b = (k1.spatial_attention(*(t.to(dtype) for t in x), num_heads=4, scale=0.125,
                                     exp2=e) for e in (True, False))
        err = (a.float() - b.float()).abs().max().item()
        assert (err > 1e-3) if live else (err < 1e-5), (dtype, err)


def test_exp2_takes_head_dim_64_only():
    """JAX's head-dim fallback (flash_attention) has no exp2: dh 32 raises,
    on the CPU as on the card."""
    x = torch.zeros(2, 10, 64)
    with pytest.raises(ValueError, match="exp2"):
        k1.spatial_attention(x, x, x, num_heads=2, scale=0.125, exp2=True)
    k1.spatial_attention(x, x, x, num_heads=2, scale=0.125, mxu_denom=True)   # K4 takes it
