"""The head variants in the port against the JAX package, on the CPU:
``use_bn`` (eval-mode BatchNorm after each residual-conv-unit conv),
``use_clstoken`` (the readout projection on [patch, cls]) and ``pe="rope"``
(rotary q and k in the motion modules).

vits at T = 4, 56x56 (a 4x4 patch grid), weights from ``init_params``
perturbed as in test_torch_model.py; the BatchNorm leaves are drawn too
(JAX's init leaves them the identity), and the RoPE table is attached on
the JAX side as tests/test_model_variants.py does (JAX's ``init_params``
leaves it to the caller; the port builds it as a buffer). Weights cross by
``convert.state_dict_from_params`` with a strict load. Tolerance: the full
forward at rtol 1e-4, atol 1e-4 * max(depth range, 1), fp32.
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models import dpt as jdpt
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.models.motion import rope_freqs_cis as j_rope
from video_depth_anything_tpu.ops.pallas_conv import rcu_supported as j_rcu_supported
from video_depth_anything_tpu.utils.torch_convert import export_torch_state_dict
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.convert import model_from_params, state_dict_from_params
from video_depth_anything_torch.kernels.fused_rcu import rcu_supported
from video_depth_anything_torch.models import VideoDepthAnything, dpt
from video_depth_anything_torch.models.motion import RotaryEmbedding, rope_freqs_cis

from test_torch_model import perturbed_params

T, HW = 4, 56
VARIANTS = {"use_bn": dict(use_bn=True), "use_clstoken": dict(use_clstoken=True),
            "rope": dict(pe="rope")}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads beside the JAX CPU client (test_torch_streaming.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _draw_bn(tree, rng):
    """Every BatchNorm leaf of a JAX head tree drawn so BN is no identity."""
    for k, v in tree.items():
        if isinstance(v, dict) and "var" in v:
            c = v["var"].shape
            v["scale"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (1 + 0.5 * rng.random(c)).astype(np.float32)
        elif isinstance(v, dict):
            _draw_bn(v, rng)


def _attach_rope(params):
    for mm in params["head"]["motion_modules"].values():
        for blk in mm["temporal_transformer"]["transformer_blocks"].values():
            for ab in blk["attention_blocks"].values():
                ab["_freqs_cis"] = j_rope(ab["to_q"]["w"].shape[0], T)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    over = VARIANTS[request.param]
    jcfg = j_config("vits", num_frames=T, **over)
    params = perturbed_params(jcfg)
    _draw_bn(params, np.random.default_rng(7))
    tcfg = t_config("vits", num_frames=T, **over)
    model = model_from_params(params, tcfg)   # strict load
    if jcfg.pe == "rope":
        _attach_rope(params)
    return request.param, jcfg, params, model


def test_variant_forward_matches_jax(variant):
    name, jcfg, params, model = variant
    x = np.random.default_rng(1).standard_normal((1, T, HW, HW, 3)).astype(np.float32)
    ref = np.asarray(jvd.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg,
                                 use_pallas=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, T, HW, HW)
    atol = 1e-4 * max(float(ref.max() - ref.min()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol, err_msg=name)


def test_variant_state_dict_is_the_jax_export(variant):
    """The variant's keys (bn1 / bn2 running statistics and
    num_batches_tracked, readout_projects.{i}.0, no pos_encoder under RoPE)
    equal the JAX export's, and the RoPE table is no checkpoint tensor."""
    name, jcfg, params, model = variant
    tree = {k: v for k, v in params.items()}
    ref = export_torch_state_dict(jax.tree.map(jnp.asarray, _without_rope(tree)), jcfg)
    ours = state_dict_from_params(params, jcfg.vit.depth)
    assert sorted(ours) == sorted(ref) == sorted(model.state_dict()), name
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    keys = "\n".join(ref)
    assert ("running_var" in keys) == (name == "use_bn")
    assert ("readout_projects.3.0.weight" in keys) == (name == "use_clstoken")
    assert ("pos_encoder" in keys) == (name != "rope")
    assert "freqs" not in keys


def _without_rope(node):
    return {k: _without_rope(v) if isinstance(v, dict) else v
            for k, v in node.items() if k != "_freqs_cis"}


def test_rope_table_is_jax_and_stays_fp32():
    """The port's table equals JAX's complex64 one, and survives a cast of
    the model to bf16 in fp32 (JAX keeps its complex table when it casts)."""
    want = j_rope(64, 32)
    np.testing.assert_array_equal(rope_freqs_cis(64, 32), want)
    rope = RotaryEmbedding(64, 32).to(torch.bfloat16)
    assert rope.freqs.dtype == torch.float32
    np.testing.assert_array_equal(rope.freqs[..., 0].numpy(), want.real)
    np.testing.assert_array_equal(rope.freqs[..., 1].numpy(), want.imag)
    m = VideoDepthAnything(t_config("vits", num_frames=T, pe="rope")).to(torch.bfloat16)
    assert all(r.freqs.dtype == torch.float32 for r in m.modules()
               if isinstance(r, RotaryEmbedding))


def test_rope_rotation_matches_jax():
    from video_depth_anything_tpu.models.motion import _apply_rope
    x = np.random.default_rng(2).standard_normal((5, 7, 64)).astype(np.float32)
    want = np.asarray(_apply_rope(jnp.asarray(x), j_rope(64, 32)))
    got = RotaryEmbedding(64, 32)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    assert RotaryEmbedding(64, 32)(xb).dtype == torch.bfloat16


def test_bn_unit_with_use_kernel_takes_the_two_conv_path(monkeypatch):
    """A BatchNorm unit at a K6-eligible shape (C 128) with use_kernel=True
    runs the two-conv path: JAX's gate excludes BN, and the kernel is not
    called. It equals the use_kernel=False result and JAX's
    residual_conv_unit(use_bn=True, use_pallas=True) at 1e-4."""
    rng = np.random.default_rng(3)
    c = 128
    p = {"conv1": {"w": 0.05 * rng.standard_normal((3, 3, c, c)), "b": 0.1 * rng.standard_normal(c)},
         "conv2": {"w": 0.05 * rng.standard_normal((3, 3, c, c)), "b": 0.1 * rng.standard_normal(c)},
         "bn1": {"scale": 1 + 0.1 * rng.standard_normal(c), "bias": 0.1 * rng.standard_normal(c),
                 "mean": 0.1 * rng.standard_normal(c), "var": 1 + rng.random(c)},
         "bn2": {"scale": 1 + 0.1 * rng.standard_normal(c), "bias": 0.1 * rng.standard_normal(c),
                 "mean": 0.1 * rng.standard_normal(c), "var": 1 + rng.random(c)}}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.standard_normal((2, 6, 9, c)).astype(np.float32)
    ref = np.asarray(jdpt.residual_conv_unit(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                             use_bn=True, use_pallas=True))
    unit = dpt.ResidualConvUnit(c, use_bn=True)
    sd = state_dict_from_params({"u": p}, 0)
    unit.load_state_dict({k[len("u."):]: v for k, v in sd.items()}, strict=True)

    def boom(*a, **k):
        raise AssertionError("K6 called for a BatchNorm unit")

    monkeypatch.setattr(dpt, "fused_rcu", boom)
    with torch.no_grad():
        got = unit(torch.from_numpy(x), use_kernel=True)
        plain = unit(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 6, 9, 128), (2, 6, 9, 64), (2, 2, 9, 256),
                                   (2, 6, 7, 384), (1, 37, 37, 384)])
@pytest.mark.parametrize("use_bn", [False, True])
def test_rcu_gate_with_bn_case_for_case(shape, use_bn):
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert rcu_supported(torch.zeros(shape, dtype=dt), use_bn) == \
            j_rcu_supported(jnp.zeros(shape, jdt), use_bn)
