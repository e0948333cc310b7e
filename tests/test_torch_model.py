"""The port's model (encoder taps, a motion module, the full window
forward) and weight conversion against the JAX package, on the CPU.

JAX weights come from ``init_params(0, cfg)``, with proj_out and cls_token
perturbed by 0.02 * N(0, 1) as the JAX package's own reference-parity
tests do (a zero proj_out would hide the temporal path); they cross into
the port through ``convert.state_dict_from_params`` with a strict load.

Tolerances: fp32 rtol = atol = 1e-4 per module; the full forward rtol 1e-3
and atol 1e-4 * max(depth range, 1) (as the JAX package's
test_model_parity.py holds the JAX model to the reference). bf16: the
drift budget of utils/precision.py after affine alignment.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models import dinov2 as jdinov2
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.models.motion import temporal_module as j_temporal_module
from video_depth_anything_tpu.utils.precision import (MAX_ERR_FRAC, MEAN_ERR_FRAC,
                                                      precision_drift_report)
from video_depth_anything_tpu.utils.torch_convert import export_torch_state_dict
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.convert import model_from_params, state_dict_from_params
from video_depth_anything_torch.models import VideoDepthAnything

TOL = dict(rtol=1e-4, atol=1e-4)


def perturbed_params(cfg, seed=0):
    """init_params(seed) as a NumPy tree, proj_out and cls_token perturbed."""
    tree = jax.tree.map(np.asarray, jvd.init_params(seed, cfg))
    rng = np.random.default_rng(100 + seed)
    for mm in tree["head"]["motion_modules"].values():
        po = mm["temporal_transformer"]["proj_out"]
        for k in po:
            po[k] = (po[k] + 0.02 * rng.standard_normal(po[k].shape)).astype(np.float32)
    cls = tree["pretrained"]["cls_token"]
    tree["pretrained"]["cls_token"] = (cls + 0.02 * rng.standard_normal(cls.shape)
                                       ).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def vits():
    cfg = j_config("vits")
    params = perturbed_params(cfg)
    return cfg, params, model_from_params(params, t_config("vits"))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_convert_matches_export_and_loads_strict(vits):
    cfg, params, _ = vits
    ours = state_dict_from_params(params, cfg.vit.depth)
    ref = export_torch_state_dict(jax.tree.map(jnp.asarray, params), cfg)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    model = VideoDepthAnything(t_config("vits"))
    assert sorted(model.state_dict()) == sorted(ref)   # strict both ways
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ref.items()},
                          strict=True)


def test_encoder_taps(vits):
    cfg, params, model = vits
    x = _x((4, 112, 112, 3), 1)
    ref = jdinov2.get_intermediate_layers(jax.tree.map(jnp.asarray, params["pretrained"]),
                                          jnp.asarray(x), cfg.vit,
                                          cfg.intermediate_layer_idx, use_pallas=False)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x))
    assert len(got) == 4
    for (gp, gc), (rp, rc) in zip(got, ref):
        np.testing.assert_allclose(gp.numpy(), np.asarray(rp), **TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), **TOL)


@pytest.mark.parametrize("key", ["0", "2"])
def test_motion_module(vits, key):
    """One temporal module (dh = 24 for module 0, 8 for module 2) with its
    proj_out randomised."""
    cfg, params, model = vits
    p = params["head"]["motion_modules"][key]
    c = p["temporal_transformer"]["proj_in"]["w"].shape[0]
    b, t = 1, 4
    x = _x((b * t, 5, 6, c), 2)
    ref = j_temporal_module(jax.tree.map(jnp.asarray, p), jnp.asarray(x), b, t)
    with torch.no_grad():
        got = model.head.motion_modules[int(key)](torch.from_numpy(x), b, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def forward_pair(vits):
    cfg, params, model = vits
    x = _x((1, 4, 112, 112, 3), 3)
    ref = np.asarray(jvd.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
                                 use_pallas=False))
    return model, x, ref


def test_full_forward(forward_pair):
    model, x, ref = forward_pair
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 4, 112, 112) and got.dtype == np.float32
    atol = 1e-4 * max(float(ref.max() - ref.min()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol)


def test_bf16_forward_within_drift_budget(forward_pair):
    model, x, ref = forward_pair
    import copy
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    with torch.no_grad():
        got = m16(torch.from_numpy(x).bfloat16()).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    rep = precision_drift_report(got, ref)
    assert rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC, rep


def test_unported_options_raise():
    """Register tokens are all that still raises (the JAX package runs none
    either); use_bn, use_clstoken, pe="rope" and vitg's SwiGLU construct
    (tests/test_torch_variants.py, tests/test_torch_vitg.py)."""
    regs = dataclasses.replace(t_config("vits").vit, num_register_tokens=4)
    with pytest.raises(NotImplementedError, match="register tokens"):
        VideoDepthAnything(dataclasses.replace(t_config("vits"), vit_override=regs))
    for over in (dict(use_bn=True), dict(use_clstoken=True), dict(pe="rope")):
        VideoDepthAnything(dataclasses.replace(t_config("vits"), **over))
    with torch.device("meta"):
        VideoDepthAnything(t_config("vitg"))
    with pytest.raises(ValueError, match="pe"):
        VideoDepthAnything(dataclasses.replace(t_config("vits"), pe="alibi"))
