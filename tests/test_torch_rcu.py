"""The port's fused residual conv unit (kernel K6) and its opt-in against
the JAX package, on the CPU: K6's plain version against the Pallas kernel
``fused_rcu`` in interpret mode and the XLA conv chain, the gate, and the
``use_kernel`` opt-in of the residual conv unit and the fusion block with
weights converted from a JAX head tree. The CUDA kernel itself is held
against this plain version on the card by test_torch_cuda.py and
chip_smoke.py.

Tolerances: fp32 rtol = atol = 1e-4 (the port's per-op tolerance; 1e-5 for
the all-zero input, whose output is bias terms only). bf16: 2^-7 of the
reference's max |y| against the JAX bf16 interpret run: both round the
intermediate and the output to bf16 at the same points, so they differ by
the fp32 order of sums flipping a rounding, one bf16 step (2^-8 relative)
of an output.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models.dpt import feature_fusion_block, residual_conv_unit
from video_depth_anything_tpu.models.video_depth import init_head_params
from video_depth_anything_tpu.ops.pallas_conv import fused_rcu as j_fused_rcu
from video_depth_anything_tpu.ops.pallas_conv import rcu_supported as j_rcu_supported
from video_depth_anything_torch import kernels
from video_depth_anything_torch.convert import state_dict_from_params
from video_depth_anything_torch.kernels import fused_rcu as k6
from video_depth_anything_torch.models.dpt import FeatureFusionBlock

TOL = dict(rtol=1e-4, atol=1e-4)


def _params(c, seed=0):
    """The JAX RCU tree of tests/test_pallas_conv.py (HWIO weights)."""
    rng = np.random.default_rng(seed)
    return {k: {"w": rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32),
                "b": rng.normal(0, 0.1, (c,)).astype(np.float32)}
            for k in ("conv1", "conv2")}


def _operands(p, dtype):
    """The JAX tree as K6's operands: OIHW -> [3, 3, C_out, C_in] in dtype,
    fp32 biases."""
    def w(name):
        oihw = torch.from_numpy(p[name]["w"]).permute(3, 2, 0, 1)
        return k6.kernel_weight(oihw, dtype)

    return (w("conv1"), torch.from_numpy(p["conv1"]["b"]),
            w("conv2"), torch.from_numpy(p["conv2"]["b"]))


def _jax(p):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("n,h,w,c", [
    (2, 9, 16, 128),    # several output tiles, W a multiple of 8
    (1, 19, 19, 256),   # refinenet4's scale
    (1, 21, 37, 256),   # H != W, odd W
    (2, 37, 37, 256),   # refinenet3's scale
])
def test_plain_matches_jax_fp32(n, h, w, c):
    p = _params(c)
    x = np.random.default_rng(1).normal(0, 1, (n, h, w, c)).astype(np.float32)
    kernels.reset_launch_counts()
    got = k6.fused_rcu(torch.from_numpy(x), *_operands(p, torch.float32))
    assert kernels.launch_counts()["fused_rcu"] == 0   # CPU: plain path
    pallas = j_fused_rcu(_jax(p), jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    xla = residual_conv_unit(_jax(p), jnp.asarray(x), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


def test_plain_matches_jax_bf16():
    p = _params(128, seed=3)
    x = np.random.default_rng(2).normal(0, 1, (1, 12, 16, 128)).astype(np.float32)
    got = k6.fused_rcu(torch.from_numpy(x).bfloat16(), *_operands(p, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_fused_rcu(_jax(p), jnp.asarray(x, jnp.bfloat16), interpret=True),
                      np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -7 * np.abs(want).max(), (err, np.abs(want).max())


def test_plain_zero_input_sees_a_zero_padded_intermediate():
    """At the image border conv2 must read zeros, not conv1(0) = relu(b1)."""
    p = _params(128, seed=4)
    x = np.zeros((1, 8, 16, 128), np.float32)
    got = k6.fused_rcu(torch.from_numpy(x), *_operands(p, torch.float32)).numpy()
    for want in (j_fused_rcu(_jax(p), jnp.asarray(x), interpret=True),
                 residual_conv_unit(_jax(p), jnp.asarray(x), use_pallas=False)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,dtype,use_bn", [
    ((1, 19, 19, 256), "bfloat16", False),
    ((1, 19, 19, 256), "bfloat16", True),     # BN: the two-conv path
    ((1, 19, 19, 64), "float32", False),      # vits' 64 channels
    ((1, 2, 19, 256), "float32", False),      # H < 3
    ((1, 19, 7, 128), "float32", False),      # W < 8
    ((2, 3, 8, 384), "float32", False),       # vitg's width, the smallest map
    ((1, 19, 19, 256), "float16", False),
    ((19, 19, 256), "float32", False),        # not NHWC
])
def test_gate_matches_jax(shape, dtype, use_bn):
    x = torch.zeros(shape, dtype=getattr(torch, dtype))
    jx = jnp.zeros(shape, getattr(jnp, dtype))
    assert k6.rcu_supported(x, use_bn) == j_rcu_supported(jx, use_bn)


def test_opt_in_matches_jax_fusion_block():
    """vitb width (C = 128) with a skip and a size: FeatureFusionBlock and
    its residual conv units with use_kernel=True (K6's plain version on the
    CPU), weights converted from a JAX head tree, against the JAX block's
    XLA path; use_kernel=False takes the two-conv path to the same result."""
    cfg = j_config("vitb")
    tree = init_head_params(np.random.default_rng(0), cfg)["scratch"]["refinenet2"]
    prefix = "scratch.refinenet2."
    sd = {k[len(prefix):]: v for k, v in state_dict_from_params({"scratch": {"refinenet2": tree}},
                                                                0).items()}
    block = FeatureFusionBlock(128)
    block.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(5)
    x, skip = (rng.normal(0, 1, (2, 10, 12, 128)).astype(np.float32) for _ in range(2))
    want = np.asarray(feature_fusion_block(_jax(tree), jnp.asarray(x), jnp.asarray(skip),
                                           size=(19, 23), use_pallas=False))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(skip), size=(19, 23), use_kernel=True)
        rcu = block.resConfUnit1(torch.from_numpy(skip), use_kernel=True)
        default = block(torch.from_numpy(x), torch.from_numpy(skip), size=(19, 23))
    assert kernels.launch_counts()["fused_rcu"] == 0   # CPU: plain path
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(default.numpy(), want, **TOL)
    np.testing.assert_allclose(rcu.numpy(), np.asarray(residual_conv_unit(
        _jax(tree["resConfUnit1"]), jnp.asarray(skip), use_pallas=False)), **TOL)


def test_opt_in_relays_weights_once():
    """The kernel layout of a unit's weights is built on first use and
    rebuilt only when a parameter changes."""
    block = FeatureFusionBlock(128)
    rcu = block.resConfUnit2
    first = rcu.kernel_operands(torch.bfloat16)
    assert first[0].shape == (3, 3, 128, 128) and first[0].dtype == torch.bfloat16
    assert all(a is b for a, b in zip(first, rcu.kernel_operands(torch.bfloat16)))
    with torch.no_grad():
        rcu.conv2.weight.mul_(2)
    again = rcu.kernel_operands(torch.bfloat16)
    torch.testing.assert_close(again[2], 2 * first[2])
    assert again[0] is not first[0]
