"""The port's int8 mode (``ops/quant.py``, the int8 encoder and motion
modules, calibration, the side file) against the JAX package, on the CPU.

Where the inputs are identical the parts agree exactly: ``quantize_weight``
and ``quant_act`` bit for bit (saturation and round-half-to-even ties
included), the fused qkv and GEGLU quantizations bit for bit with the JAX
package's separate q / k / v and column-slice products, ``qlinear`` at
1e-6. The calibration stats agree at rtol 1e-5 (fp32 rounding of the same
activations).

The composed int8 model is held to stated tolerances, with fp32
activations and the JAX stats carried across, so the scales are identical.
Port and JAX activations still differ by fp32 rounding (~1e-7), and near a
.5 tie ``quant_act`` then rounds one element to the neighbouring integer:
one step of amax / 127 on that element, a far larger change than the
rounding that caused it. One block or one motion module from the same
input absorbs its few flips within a relative L2 of 1e-3 of JAX int8. Over
the 12 blocks and the head the flips compound, as far as a 1e-6 rescale of
the port's own scales moves it; those comparisons (the encoder taps, the
pipeline) are held to twice that flip floor, measured in the test, and
each says so. Against JAX fp32, tests/test_quant.py's own budgets:
encoder and motion module relative L2 < 0.05, pipeline max 8 % / mean 0.2 %
of the depth range after affine alignment.
"""
import copy
import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.config import ViTConfig as JViTConfig
from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models import dinov2 as jdinov2
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.models.motion import _col_slice
from video_depth_anything_tpu.models.motion import temporal_module as j_temporal_module
from video_depth_anything_tpu.ops import quant as jquant
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
from video_depth_anything_tpu.pipeline import infer as jinfer
from video_depth_anything_tpu.utils.precision import precision_drift_report
from video_depth_anything_torch.config import ModelConfig, ViTConfig
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.convert import model_from_params, state_dict_from_params
from video_depth_anything_torch.models import VideoDepthAnything, build_model
from video_depth_anything_torch.models.dinov2 import DinoVisionTransformer
from video_depth_anything_torch.ops import quant
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.pipeline import infer as tinfer
from video_depth_anything_torch.utils.precision import flip_floor_report, synthetic_video
from video_depth_anything_torch.utils.tree import flatten_tree

from test_torch_model import perturbed_params

REL_VS_INT8 = 1e-3      # port int8 vs JAX int8, relative L2 (quant_act flips)
REL_VS_FP32 = 0.05      # int8 vs fp32 (tests/test_quant.py)
PIPE_MAX, PIPE_MEAN = 0.08, 0.002
INPUT_SIZE = 56


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _t(x):
    return torch.from_numpy(np.array(x))


TOY = ViTConfig(embed_dim=64, depth=4, num_heads=2)
J_TOY = JViTConfig(embed_dim=64, depth=4, num_heads=2)


def _toy_encoder(params):
    enc = DinoVisionTransformer(TOY)
    sd = state_dict_from_params({"pretrained": params}, TOY.depth)
    enc.load_state_dict({k[len("pretrained."):]: v for k, v in sd.items()}, strict=True)
    return enc.eval().requires_grad_(False)


# ---- primitives -----------------------------------------------------------

def test_quantize_weight_bit_equal():
    w = _rand((64, 96), 0, 0.05)          # JAX layout [K, N]
    w[:, 5] = 0.0                         # a dead channel: ws clamps to 1e-12
    jw, jws = jquant.quantize_weight(jnp.asarray(w))
    tw, tws = quant.quantize_weight(_t(w.T))   # port layout [out, in]
    assert tw.dtype == torch.int8 and tws.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy().T, np.asarray(jw))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))


def test_quant_act_bit_equal_with_saturation_and_ties():
    x = np.array([-10.0, -1.0, 0.0, 0.5, 10.0], np.float32)
    got = quant.quant_act(_t(x), torch.tensor(1.0))
    np.testing.assert_array_equal(got.numpy(), [-127, -127, 0, 64, 127])
    # amax 127: the scale is 1, so these are exact .5 ties (half to even).
    ties = np.array([-300.0, -127.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.5],
                    np.float32)
    for x, a in ((ties, 127.0), (_rand((4000,), 1), 2.0), (_rand((64, 33), 2), 0.7)):
        want = np.asarray(jquant.quant_act(jnp.asarray(x), jnp.float32(a)))
        got = quant.quant_act(_t(x), torch.tensor(a)).numpy()
        np.testing.assert_array_equal(got, want)
    assert list(quant.quant_act(_t(ties), torch.tensor(127.0)).numpy()) == \
        [-127, -127, -2, -2, 0, 0, 2, 2, 126, 127]


@pytest.mark.parametrize("bias", [True, False])
def test_qlinear_matches_jax(bias):
    w, x = _rand((64, 96), 3, 0.05), _rand((40, 64), 4)
    b = _rand((96,), 5, 0.01)
    amax = np.float32(np.abs(x).max() * 0.9)
    p = dict(zip(("w_i8", "ws"), jquant.quantize_weight(jnp.asarray(w))))
    if bias:
        p["b"] = jnp.asarray(b)
    ref = jquant.qlinear(p, jquant.quant_act(jnp.asarray(x), amax), amax, jnp.float32)
    lin = torch.nn.Linear(64, 96, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(_t(w.T))
        if bias:
            lin.bias.copy_(_t(b))
    got = quant.QLinear.from_linear(lin, amax)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_fused_qkv_quantization_equals_jax_per_projection():
    """The port's fused attn.qkv [3D, D] quantizes per output channel, so
    its int8 weights, scales and product are JAX's q, k and v ones
    concatenated (convert.py order)."""
    params = jdinov2.init_encoder_params(np.random.default_rng(6), J_TOY)
    attn = {n: {k: v[0] for k, v in site.items()}
            for n, site in params["blocks"]["attn"].items()}
    amax = np.float32(3.0)
    q = quant.QLinear.from_linear(_toy_encoder(params).blocks[0].attn.qkv, amax)
    jq = {n: jquant._quantize_site(attn[n]) for n in "qkv"}
    np.testing.assert_array_equal(q.w_i8.numpy().T, np.concatenate(
        [np.asarray(jq[n]["w_i8"]) for n in "qkv"], axis=1))
    np.testing.assert_array_equal(q.ws.numpy(), np.concatenate(
        [np.asarray(jq[n]["ws"]) for n in "qkv"]))
    x = _rand((3, 20, 64), 7)
    xq = jquant.quant_act(jnp.asarray(x), amax)
    want = np.concatenate([np.asarray(jquant.qlinear(jq[n], xq, amax, jnp.float32))
                           for n in "qkv"], axis=-1)
    np.testing.assert_array_equal(q(_t(x)).numpy(), want)


def test_geglu_quantization_equals_jax_column_slices():
    """One GEGLU proj [8C, C] quantized and chunked gives exactly the JAX
    package's two column-slice products (models/motion.py::_geglu_ff)."""
    c = 32
    site = {"w": jnp.asarray(_rand((c, 8 * c), 8, 0.1)), "b": jnp.asarray(_rand((8 * c,), 9, 0.1))}
    x = _rand((50, c), 10)
    amax = np.float32(np.abs(x).max())
    jsite = jquant._quantize_site(site)
    xq = jquant.quant_act(jnp.asarray(x), amax)
    val = jquant.linear_maybe_q(_col_slice(jsite, 0, 4 * c), jnp.asarray(x), amax, x_i8=xq)
    gate = jquant.linear_maybe_q(_col_slice(jsite, 4 * c, 8 * c), jnp.asarray(x), amax, x_i8=xq)
    lin = torch.nn.Linear(c, 8 * c)
    with torch.no_grad():
        lin.weight.copy_(_t(np.asarray(site["w"]).T))
        lin.bias.copy_(_t(site["b"]))
    tval, tgate = quant.QLinear.from_linear(lin, amax)(_t(x)).chunk(2, dim=-1)
    np.testing.assert_array_equal(tval.numpy(), np.asarray(val))
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(gate))


def test_int8_product_shape_checks_raise_on_the_card_shapes():
    """On the card, shapes torch._int_mm cannot take raise (no quiet float
    fallback); the check is a pure function of the shape."""
    quant._check_int_mm(17, 64, 64, torch.device("cuda"))
    for m, k, n in ((16, 64, 64), (32, 60, 64), (32, 64, 12)):
        with pytest.raises(ValueError, match="int8 product"):
            quant._check_int_mm(m, k, n, torch.device("cuda"))
    quant._check_int_mm(5, 60, 12, torch.device("cpu"))


# ---- encoder ----------------------------------------------------------------

def _taps_close(got, ref, rel):
    for (gp, gc), (rp, rc) in zip(got, ref):
        assert _rel(gp.numpy(), rp) < rel, _rel(gp.numpy(), rp)
        assert _rel(gc.numpy(), rc) < rel, _rel(gc.numpy(), rc)


def test_toy_encoder_int8_matches_jax():
    """Toy encoder (dh = 32: K3's dequantized fallback on both sides)."""
    params = jax.tree.map(np.asarray, jdinov2.init_encoder_params(np.random.default_rng(1), J_TOY))
    jp = jax.tree.map(jnp.asarray, params)
    x = _rand((2, 56, 56, 3), 11)
    taps = [1, 3]
    ref = jdinov2.get_intermediate_layers(jp, jnp.asarray(x), J_TOY, taps, use_pallas=False)
    _, jstats = jdinov2.calibrate_encoder_stats(jp, jnp.asarray(x), J_TOY, taps, use_pallas=False)
    jq = jdinov2.get_intermediate_layers(jquant.quantize_encoder(jp, jstats, 4), jnp.asarray(x),
                                         J_TOY, taps, use_pallas=False)
    enc = _toy_encoder(params)
    with torch.no_grad():
        plain = enc.get_intermediate_layers(_t(x), taps)
        feats, stats = enc.calibrate(_t(x), taps)
        for (a, _), (b, _) in zip(plain, feats):   # one shared pass
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert sorted(stats) == sorted(jstats)
        for k, v in jstats.items():
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(v), rtol=1e-5, err_msg=k)
        got = quant.quantize_encoder(copy.deepcopy(enc), jax.device_get(jstats)).get_intermediate_layers(_t(x), taps)
    _taps_close(got, jq, REL_VS_INT8)
    _taps_close(got, ref, REL_VS_FP32)


@pytest.fixture(scope="module")
def vits():
    cfg = j_config("vits")
    params = perturbed_params(cfg)
    x = _rand((1, 4, 112, 112, 3), 12)
    jstats = jax.device_get(jvd.calibrate_stats(jax.tree.map(jnp.asarray, params),
                                                jnp.asarray(x), cfg, use_pallas=False))
    return cfg, params, model_from_params(params, t_config("vits")), x, jstats


def test_calibrate_stats_matches_jax(vits):
    """Every stat at rtol 1e-5, in a tree of the JAX tree's keys and shapes
    (so a side file of either package reads in the other)."""
    _, _, model, x, jstats = vits
    with torch.no_grad():
        stats = tinfer._numpy_tree(model.calibrate_stats(_t(x)))
    want, got = flatten_tree(jstats), flatten_tree(stats)
    assert sorted(got) == sorted(want)
    assert set(stats["encoder"]) == set(quant.ACT_SITES)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _scaled(tree, f):
    return {k: _scaled(v, f) if isinstance(v, dict) else np.float32(f) * np.asarray(v, np.float32)
            for k, v in tree.items()}


def test_vits_int8_blocks_match_jax(vits):
    """Each int8 block of vits (dh = 64, H = 6: the port runs K3's plain
    version, the JAX CPU path dequantizes q8 and k8 into plain attention)
    from the same input tokens: relative L2 < 1e-3. Only the flips of one
    block's quant_act calls separate the two."""
    _int8_blocks_match_jax(*vits)


def _int8_blocks_match_jax(cfg, params, model, x, jstats, floor=False):
    """Each int8 block from the JAX stream's input tokens, against JAX's
    ``_block_step``: at REL_VS_INT8, or (``floor``) within twice the block's
    flip floor, the port's own block with every absmax scaled by 1 + 1e-6."""
    jenc = jquant.quantize_encoder(jax.tree.map(jnp.asarray, params["pretrained"]),
                                   jstats["encoder"], cfg.vit.depth)
    enc = quant.quantize_model(model, jstats).pretrained
    nudged = quant.quantize_model(model, _scaled(jstats, 1 + 1e-6)).pretrained if floor else None
    assert isinstance(model.pretrained.blocks[0].attn.qkv, torch.nn.Linear)  # a copy
    tokens = jdinov2._embed_tokens(jenc, jnp.asarray(x[0]), cfg.vit)
    for i in range(cfg.vit.depth):
        bp = jax.tree.map(lambda a: a[i], jenc["blocks"])
        want, _ = jdinov2._block_step(tokens, bp, num_heads=cfg.vit.num_heads, use_pallas=False)
        with torch.no_grad():
            got = enc.blocks[i](_t(tokens)).numpy()
            limit = (REL_VS_INT8 if nudged is None
                     else 2 * _rel(nudged.blocks[i](_t(tokens)).numpy(), got))
        assert _rel(got, want) < limit, (i, _rel(got, want), limit)
        tokens = want


def test_vits_encoder_int8_taps(vits):
    """The composed int8 encoder. Against JAX fp32: relative L2 < 0.05.
    Against JAX int8 the flips compound over 12 blocks: rescaling every
    absmax by 1 + 1e-6 moves the port's own taps by 3e-3 (first tap) to
    1e-2 (last), and its cls tokens by 2e-2 to 4e-2, as far as JAX int8
    lies from the port (1.8e-3 to 9e-3; cls 1.6e-2 to 3.3e-2). So each tap
    is held to twice that flip floor, measured here."""
    cfg, params, model, x, jstats = vits
    jp = jax.tree.map(jnp.asarray, params)
    frames = jnp.asarray(x[0])
    taps = cfg.intermediate_layer_idx
    ref = jdinov2.get_intermediate_layers(jp["pretrained"], frames, cfg.vit, taps, use_pallas=False)
    jpq = jquant.quantize_encoder(jp["pretrained"], jstats["encoder"], cfg.vit.depth)
    jq = jdinov2.get_intermediate_layers(jpq, frames, cfg.vit, taps, use_pallas=False)
    with torch.no_grad():
        got = quant.quantize_model(model, jstats).encode(_t(x[0]))
        nudged = quant.quantize_model(model, _scaled(jstats, 1 + 1e-6)).encode(_t(x[0]))
    for (gp, gc), (jp_, jc), (rp, rc), (np_, nc) in zip(got, jq, ref, nudged):
        for g, j, r, n in ((gp, jp_, rp, np_), (gc, jc, rc, nc)):
            g, n = g.numpy(), n.numpy()
            assert _rel(g, r) < REL_VS_FP32, _rel(g, r)
            assert _rel(g, j) < 2 * _rel(n, g), (_rel(g, j), _rel(n, g))


@pytest.mark.parametrize("key", ["0", "3"])
def test_motion_module_int8_matches_jax(vits, key):
    """Motion module 0 (dh = 24) and 3 (dh = 8), proj_out randomised: the
    stats tree, then the int8 module against JAX int8 and JAX fp32."""
    _motion_module_int8_matches_jax(vits, key)


def _motion_module_int8_matches_jax(fixture, key):
    """Motion module ``key`` on random maps at its width: the stats tree at
    rtol 1e-5, the int8 module against JAX int8 (REL_VS_INT8) and fp32."""
    _, params, model, _, _ = fixture
    p = jax.tree.map(jnp.asarray, params["head"]["motion_modules"][key])
    c = params["head"]["motion_modules"][key]["temporal_transformer"]["proj_in"]["w"].shape[0]
    b, t = 1, 4
    x = _rand((b * t, 5, 6, c), 13)
    ref, jst = j_temporal_module(p, jnp.asarray(x), b, t, collect_stats=True)
    jst = jax.device_get(jst)
    jq = j_temporal_module(jquant.quantize_motion_module(p, jst), jnp.asarray(x), b, t)
    mod = model.head.motion_modules[int(key)]
    stats: dict = {}
    with torch.no_grad():
        mod(_t(x), b, t, stats)
        st, want = flatten_tree(tinfer._numpy_tree(stats)), flatten_tree(jst)
        assert sorted(st) == sorted(want)
        for k in want:
            np.testing.assert_allclose(st[k], want[k], rtol=1e-5, err_msg=k)
        got = quant.quantize_motion_module(copy.deepcopy(mod), jst)(_t(x), b, t).numpy()
    assert _rel(got, jq) < REL_VS_INT8, _rel(got, jq)
    assert _rel(got, ref) < REL_VS_FP32, _rel(got, ref)


def _vitl_cut(config):
    """vitl's widths (1024 channels, 16 heads of dh 64, the 3072 fused qkv;
    the head at 256 features, motion modules at 1024 and 256) cut to 2
    blocks, tapped (0, 0, 1, 1)."""
    base = config("vitl")
    return dataclasses.replace(base, taps=(0, 0, 1, 1),
                               vit_override=dataclasses.replace(base.vit, depth=2))


@pytest.fixture(scope="module")
def vitl():
    cfg = _vitl_cut(j_config)
    params = perturbed_params(cfg)
    x = _rand((1, 4, 112, 112, 3), 14)
    jstats = jax.device_get(jvd.calibrate_stats(jax.tree.map(jnp.asarray, params),
                                                jnp.asarray(x), cfg, use_pallas=False))
    return cfg, params, model_from_params(params, _vitl_cut(t_config)), x, jstats


def test_vitl_int8_blocks_match_jax(vitl):
    """vitl's int8 blocks (dh = 64, H = 16: K3's plain version on the port's
    side, the fused 3072-wide qkv product) from JAX's input tokens. At this
    width one block's flips alone pass 1e-3: scaling every absmax by
    1 + 1e-6 moves block 0 by 2.5e-3 relative L2, the port's and JAX's
    alike, and the port lies 1.8e-3 from JAX. So each block is held within
    twice that flip floor, measured here (vits' blocks stay at 1e-3)."""
    _int8_blocks_match_jax(*vitl, floor=True)


@pytest.mark.parametrize("key", ["0", "3"])
def test_vitl_motion_module_int8_matches_jax(vitl, key):
    """vitl's motion modules 0 (1024 channels, dh 128) and 3 (256, dh 32)
    in int8 against JAX int8 and fp32, proj_out randomised."""
    _motion_module_int8_matches_jax(vitl, key)


# ---- pipeline -----------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes(vits, tmp_path_factory):
    cfg, params, model, _, _ = vits
    frames = synthetic_video(n=50, hw=(70, 98), seed=3)
    jparams = jax.tree.map(jnp.asarray, params)
    d32, _ = JaxPipeline(cfg, jparams, use_pallas=False).infer_video_depth(
        frames, input_size=INPUT_SIZE, fp32=True)
    path = str(tmp_path_factory.mktemp("calib") / "jax.int8calib.npz")
    j8, _ = JaxPipeline(cfg, jparams, use_pallas=False, quant="int8", calib_path=path
                        ).infer_video_depth(frames, input_size=INPUT_SIZE, fp32=True)
    return model, frames, np.asarray(d32), np.asarray(j8), path


def test_pipeline_int8_reads_jax_side_file_and_matches_jax_int8(pipes, monkeypatch, tmp_path):
    """fp32 activations and the JAX-written side file (identical scales):
    the port never calibrates, runs every encoder and motion-module linear
    and the spatial attention in int8, and lands within twice the flip
    floor of JAX int8. Over 3 windows of 32 frames the flips dominate:
    rescaling every absmax by 1 + 1e-6 moves the port's own depths by
    about as far as JAX int8 lies from the port, so the floor is measured
    here (utils/precision.py::flip_floor_report: aligned max and mean, and
    the unaligned relative L2). On these random weights the floor (relative
    L2 3.6e-2) is as large as int8's whole effect (the port's fp32 against
    its int8: 3.9e-2), so no output comparison can tell int8 from float
    here: the test asserts on the model it ran that every site is int8."""
    model, frames, _, j8, path = pipes

    def boom(*a, **k):
        raise AssertionError("calibration ran despite a matching side file")

    monkeypatch.setattr(VideoDepthAnything, "calibrate_stats", boom)
    pipe = VideoDepthPipeline(t_config("vits"), model, device="cpu", quant="int8",
                              calib_path=path)
    got, _ = pipe.infer_video_depth(frames, input_size=INPUT_SIZE, fp32=True)
    assert got.shape == j8.shape and np.isfinite(got).all()
    (qmodel,) = pipe._int8.values()
    for blk in qmodel.pretrained.blocks:
        assert all(isinstance(m, quant.QLinear)
                   for m in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2))
        assert blk.attn.q_amax is not None and blk.attn.k_amax is not None   # K3
    motion = qmodel.head.motion_modules
    assert not any(isinstance(m, torch.nn.Linear) for m in motion.modules())
    assert sum(isinstance(m, quant.QLinear) for m in motion.modules()) > 0
    nudged = str(tmp_path / "nudged.int8calib.npz")
    tinfer.scale_side_file(path, nudged, 1 + 1e-6)
    floor, _ = VideoDepthPipeline(t_config("vits"), model, device="cpu", quant="int8",
                                  calib_path=nudged).infer_video_depth(
                                      frames, input_size=INPUT_SIZE, fp32=True)
    rep = flip_floor_report(j8, got, floor)
    assert rep["ok"], rep


@pytest.mark.parametrize("cache", [True, False])
def test_pipeline_int8_within_budget_of_jax_fp32(pipes, cache):
    """bf16 int8 (the default --int8 run), calibrating itself, in the
    keyframe-cache and the plain mode."""
    model, frames, d32, _, _ = pipes
    pipe = VideoDepthPipeline(t_config("vits"), model, device="cpu", quant="int8")
    got, _ = pipe.infer_video_depth(frames, input_size=INPUT_SIZE,
                                    cache_keyframe_features=cache)
    assert np.isfinite(got).all()
    rep = precision_drift_report(got, d32)
    assert rep["max_err_frac"] < PIPE_MAX and rep["mean_err_frac"] < PIPE_MEAN, rep


# ---- side file ------------------------------------------------------------------

def _stats_tree(seed=0):
    rng = np.random.default_rng(seed)
    enc = {k: rng.random(3).astype(np.float32) for k in quant.ACT_SITES}
    mod = {"proj_in": np.float32(rng.random()), "proj_out": np.float32(rng.random()),
           "blocks": {"0": {"attn": {str(j): {"qkv": np.float32(rng.random()),
                                              "out": np.float32(rng.random())}
                                     for j in range(2)},
                            "ff_proj": np.float32(rng.random()),
                            "ff_g": np.float32(rng.random())}}}
    return {"encoder": enc, "motion": {str(i): copy.deepcopy(mod) for i in range(4)}}


def _same_tree(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


def test_side_file_interchange_both_ways(tmp_path):
    stats, hw = _stats_tree(), (56, 70)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jinfer._save_calib(jpath, stats, hw, jnp.bfloat16)
    _same_tree(tinfer._load_calib(jpath, hw, torch.bfloat16), stats)
    assert tinfer._load_calib(jpath, hw, torch.float32) is None
    assert tinfer._load_calib(jpath, (56, 56), torch.bfloat16) is None
    tinfer._save_calib(tpath, stats, hw, torch.float32)
    _same_tree(jax.device_get(jinfer._load_calib(tpath, hw, jnp.float32)), stats)
    assert jinfer._load_calib(tpath, hw, jnp.bfloat16) is None
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)


TOY_MODEL = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2),
                        features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))


@pytest.fixture
def toy():
    return build_model(TOY_MODEL, seed=0), synthetic_video(n=30, hw=(42, 56), seed=4)


def _net_hw(frames, input_size):
    from video_depth_anything_torch.pipeline import preprocess
    h, w = frames.shape[1:3]
    return preprocess.network_input_hw(h, w, preprocess.effective_input_size(h, w, input_size))


def test_side_file_roundtrip_skips_calibration(toy, tmp_path, monkeypatch):
    model, frames = toy
    path = str(tmp_path / "ckpt.int8calib.npz")
    d1, _ = VideoDepthPipeline(TOY_MODEL, model, device="cpu", quant="int8",
                               calib_path=path).infer_video_depth(frames, input_size=28)
    assert os.path.exists(path)

    def boom(*a, **k):
        raise AssertionError("calibration re-ran despite persisted scales")

    monkeypatch.setattr(VideoDepthAnything, "calibrate_stats", boom)
    d2, _ = VideoDepthPipeline(TOY_MODEL, model, device="cpu", quant="int8",
                               calib_path=path).infer_video_depth(frames, input_size=28)
    np.testing.assert_array_equal(d1, d2)


def test_side_file_geometry_mismatch_recalibrates(toy, tmp_path):
    model, frames = toy
    path = str(tmp_path / "ckpt.int8calib.npz")
    hw28, hw42 = _net_hw(frames, 28), _net_hw(frames, 42)
    assert hw28 != hw42
    VideoDepthPipeline(TOY_MODEL, model, device="cpu", quant="int8",
                       calib_path=path).infer_video_depth(frames, input_size=28)
    assert tinfer._load_calib(path, hw28, torch.bfloat16) is not None
    assert tinfer._load_calib(path, hw42, torch.bfloat16) is None
    assert tinfer._load_calib(path, hw28, torch.float32) is None
    pipe = VideoDepthPipeline(TOY_MODEL, model, device="cpu", quant="int8", calib_path=path)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pipe.infer_video_depth(frames, input_size=42)
    assert any("recalibrating" in str(w.message) for w in rec)
    assert tinfer._load_calib(path, hw42, torch.bfloat16) is not None
    assert tinfer._load_calib(path, hw28, torch.bfloat16) is None
    with np.load(path) as d:      # a legacy meta-less file is incompatible
        legacy = {k: d[k] for k in d.files if not k.startswith("__calib_meta__")}
    np.savez_compressed(path, **legacy)
    assert tinfer._load_calib(path, hw42, torch.bfloat16) is None


def test_side_file_corrupt_recalibrates(toy, tmp_path):
    model, frames = toy
    path = str(tmp_path / "ckpt.int8calib.npz")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 not actually a zip")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tinfer._load_calib(path, (28, 28), torch.bfloat16) is None
    assert any("recalibrating" in str(w.message) for w in rec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d, _ = VideoDepthPipeline(TOY_MODEL, model, device="cpu", quant="int8",
                                  calib_path=path).infer_video_depth(frames, input_size=28)
    assert np.isfinite(d).all()
    with np.load(path) as data:
        assert any(k.startswith("__calib_meta__") for k in data.files)


def test_side_file_written_atomically(tmp_path, monkeypatch):
    """The file appears by os.replace of a complete temp file; a write that
    fails leaves the old file and no temp file behind."""
    path = str(tmp_path / "ckpt.int8calib.npz")
    stats = _stats_tree(1)
    tinfer._save_calib(path, stats, (28, 28), torch.bfloat16)
    before = open(path, "rb").read()

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tinfer.np, "savez_compressed", fail)
    with pytest.raises(OSError):
        tinfer._save_calib(path, _stats_tree(2), (28, 28), torch.bfloat16)
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["ckpt.int8calib.npz"]
    monkeypatch.undo()
    replaced = []
    real = os.replace
    monkeypatch.setattr(tinfer.os, "replace",
                        lambda a, b: (replaced.append((a, b)), real(a, b)))
    tinfer._save_calib(path, _stats_tree(2), (28, 28), torch.bfloat16)
    assert len(replaced) == 1 and replaced[0][1] == path and ".tmp." in replaced[0][0]
    assert os.listdir(tmp_path) == ["ckpt.int8calib.npz"]
    _same_tree(tinfer._load_calib(path, (28, 28), torch.bfloat16), _stats_tree(2))
