"""``models/video_depth.py::numpy_state_dict``: seeded random weights that
every machine draws alike, shared by the port, the JAX package and a card.

- The dict has the port model's keys, in its order, with its shapes, fp32;
  it loads with ``strict=True`` and through JAX's own
  ``utils/torch_convert.py::convert_torch_state_dict``, where the two
  forwards agree at vitl's widths (cut to 2 blocks) at 1e-4 of the range.
- It follows ``init_random``'s rules (norms, LayerScale, truncated
  normals, torch's default bounds, the perturbed proj_out and cls_token,
  the APE tables, BatchNorm), and one seed gives one SHA-256 (pinned for
  vits; tests/test_torch_drift_518.py pins vitl's).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.utils.torch_convert import convert_torch_state_dict
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.models import (VideoDepthAnything, build_model,
                                               load_numpy_state_dict, numpy_state_dict,
                                               state_dict_sha256)
from video_depth_anything_torch.models.motion import sinusoidal_pe

torch.set_num_threads(2)   # beside the JAX CPU client's threads
# state_dict_sha256(numpy_state_dict(get_model_config("vits"), 0)).
VITS_SHA256 = "efcbb9c107edcdf72e4a3a2c04b8f580e1405037c23171e97b2a08389b246f58"


def _cut(config, name="vitl", **head):
    base = config(name)
    return dataclasses.replace(base, taps=(0, 0, 1, 1), **head,
                               vit_override=dataclasses.replace(base.vit, depth=2))


def test_keys_shapes_and_one_digest_per_seed():
    cfg = t_config("vits")
    sd = numpy_state_dict(cfg, 0)
    with torch.device("meta"):
        want = VideoDepthAnything(cfg).state_dict()
    assert list(sd) == list(want)
    assert all(tuple(sd[k].shape) == tuple(v.shape) and sd[k].dtype == np.float32
               for k, v in want.items())
    assert state_dict_sha256(sd) == VITS_SHA256
    assert state_dict_sha256(numpy_state_dict(cfg, 0)) == VITS_SHA256
    assert state_dict_sha256(numpy_state_dict(cfg, 1)) != VITS_SHA256
    model = load_numpy_state_dict(build_model(cfg), sd)
    assert state_dict_sha256({k: v.numpy() for k, v in model.state_dict().items()}) == VITS_SHA256


def test_follows_init_randoms_rules():
    cfg = _cut(t_config, "vits", use_bn=True)
    sd = numpy_state_dict(cfg, 0)
    with torch.device("meta"):
        mods = dict(VideoDepthAnything(cfg).named_modules())
    for key, v in sd.items():
        prefix, _, leaf = key.rpartition(".")
        m = mods[prefix]
        if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            assert np.all(v == (leaf == "weight")), key
        elif isinstance(m, torch.nn.BatchNorm2d):
            if leaf == "num_batches_tracked":
                assert v.dtype == np.int64 and v == 0
            elif leaf == "running_var":
                assert 1 <= v.min() and v.max() < 1.5, key
            else:
                assert 0 < np.std(v) < 0.2 and abs(np.mean(v) - (leaf == "weight")) < 0.05, key
        elif prefix.endswith("proj_out"):
            assert 0.01 < np.std(v) < 0.03, key
        elif key.startswith("pretrained.") and isinstance(m, torch.nn.Linear):
            if leaf == "bias":
                assert not v.any(), key
            else:   # N(0, 0.02) cut at 2 std: std 0.88 x 0.02
                assert np.abs(v).max() <= 0.04 and 0.016 < np.std(v) < 0.019, key
        elif isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d)) \
                and not key.startswith("pretrained."):
            w = m.weight.shape
            fan_in = (w[1] * w[2] * w[3] if isinstance(m, torch.nn.ConvTranspose2d)
                      else math.prod(w[1:]))
            bound = math.sqrt(1 / fan_in) * (math.sqrt(3) if leaf == "weight" else 1)
            assert np.abs(v).max() <= bound, key
            assert v.size < 64 or np.abs(v).max() > 0.9 * bound, key
    patch = sd["pretrained.patch_embed.proj.weight"]
    assert np.abs(patch).max() <= 2 * math.sqrt(1 / (3 * 14 * 14))
    assert np.abs(sd["pretrained.pos_embed"]).max() <= 0.04
    assert not sd["pretrained.mask_token"].any()
    assert 0.01 < np.std(sd["pretrained.cls_token"]) < 0.03
    assert all(np.all(v == cfg.vit.init_values) for k, v in sd.items() if k.endswith(".gamma"))
    pes = [(k, v) for k, v in sd.items() if k.endswith(".pe")]
    assert len(pes) == 8
    assert all(np.array_equal(v, sinusoidal_pe(v.shape[2], v.shape[1])) for _, v in pes)


def test_port_and_jax_agree_on_the_weights_at_vitl_width():
    """vitl's widths cut to 2 blocks, 1 x 4 x 56²: the port (strict load)
    and JAX (convert_torch_state_dict) in fp32 within 1e-4 of the range."""
    sd = numpy_state_dict(_cut(t_config), 0)
    model = load_numpy_state_dict(build_model(_cut(t_config)), sd)
    params = convert_torch_state_dict(sd, _cut(j_config))
    x = np.random.default_rng(1).standard_normal((1, 4, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jvd.forward(params, jnp.asarray(x), _cut(j_config), use_pallas=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.ptp(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.ptp(want))


@pytest.mark.parametrize("name", ["vits", "vitl"])
def test_jax_takes_every_key(name):
    """convert_torch_state_dict maps every key: the JAX tree's leaves hold
    the dict's values, rearranged (each encoder's widths, 2 blocks)."""
    cfg = _cut(t_config, name)
    sd = numpy_state_dict(cfg, 0)
    params = convert_torch_state_dict(sd, _cut(j_config, name))
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert n_params == sum(v.size for v in sd.values())
