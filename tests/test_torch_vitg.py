"""vitg's fused SwiGLU FFN in the port against the JAX package, on the CPU.

vitg (1536 wide, 40 blocks, 24 heads) is too large for a CPU test, so a
toy encoder of its kind stands in: ``ViTConfig(128, depth 2, 2 heads,
ffn_layer="swiglufused")``, head dim 64 like vitg's, so the port runs K1's
plain version (and K3's in int8), as vitg does on the card. JAX weights
come from ``init_params`` (the model perturbed as in test_torch_model.py)
and cross over by ``convert.state_dict_from_params`` with a strict load.

Tolerances: fp32 rtol = atol = 1e-4 for the FFN, a block and the taps;
the full forward rtol 1e-3, atol 1e-4 * max(depth range, 1), as
test_torch_model.py holds vits; bf16 within the drift budget of
utils/precision.py. At vitg's own width (4 blocks, 112²) the fp32 forward
is held to JAX's as above and the bf16 drift to JAX's bf16 drift. int8 follows test_torch_quant.py's rules: calibration
stats at rtol 1e-5, one int8 block within 1e-3 relative L2 of JAX int8,
the pipeline on the JAX-written side file within twice the flip floor.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_depth_anything_tpu.config import ModelConfig as JModelConfig
from video_depth_anything_tpu.config import ViTConfig as JViTConfig
from video_depth_anything_tpu.models import dinov2 as jdinov2
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.ops import quant as jquant
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
from video_depth_anything_tpu.pipeline import infer as jinfer
from video_depth_anything_tpu.utils.precision import (MAX_ERR_FRAC, MEAN_ERR_FRAC,
                                                      precision_drift_report)
from video_depth_anything_tpu.utils.torch_convert import export_torch_state_dict
from video_depth_anything_torch.config import ModelConfig, ViTConfig, get_model_config
from video_depth_anything_torch.convert import model_from_params, state_dict_from_params
from video_depth_anything_torch.models import VideoDepthAnything
from video_depth_anything_torch.models.dinov2 import SwiGLUFFNFused, swiglu_hidden
from video_depth_anything_torch.ops import quant
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.pipeline import infer as tinfer
from video_depth_anything_torch.utils.precision import flip_floor_report, synthetic_video
from video_depth_anything_torch.utils.tree import flatten_tree

from test_torch_model import perturbed_params
from test_torch_quant import _scaled

TOL = dict(rtol=1e-4, atol=1e-4)
REL_VS_INT8 = 1e-3
J_VIT = JViTConfig(embed_dim=128, depth=2, num_heads=2, ffn_layer="swiglufused")
T_VIT = ViTConfig(embed_dim=128, depth=2, num_heads=2, ffn_layer="swiglufused")
J_CFG = JModelConfig(encoder="_tinytorchswiglu", vit_override=J_VIT, features=32,
                     out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
T_CFG = ModelConfig(encoder="vits", vit_override=T_VIT, features=32,
                    out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
INPUT = 28


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads beside the JAX CPU client (test_torch_streaming.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def toy():
    params = perturbed_params(J_CFG)
    return params, model_from_params(params, T_CFG)


def _block(params, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), params["pretrained"]["blocks"])


def test_swiglu_hidden_size():
    """(int(hidden * 2 / 3) + 7) // 8 * 8: 4096 for vitg, so w12 is 1536 ->
    8192; the toy's 344."""
    assert swiglu_hidden(1536, 4.0) == 4096
    assert swiglu_hidden(128, 4.0) == 344
    with torch.device("meta"):
        m = VideoDepthAnything(get_model_config("vitg"))
    mlp = m.pretrained.blocks[0].mlp
    assert isinstance(mlp, SwiGLUFFNFused)
    assert tuple(mlp.w12.weight.shape) == (8192, 1536) and tuple(mlp.w3.weight.shape) == (1536, 4096)
    assert len(m.pretrained.blocks) == 40 and m.pretrained.blocks[0].attn.num_heads == 24
    n = sum(p.numel() for p in m.pretrained.parameters())
    assert 1.13e9 < n < 1.14e9, n


def test_swiglu_ffn_matches_jax(toy):
    params, model = toy
    bp = _block(params, 0)
    y = _rand((3, 17, 128), 1)
    ref = jdinov2._ffn(bp, jnp.asarray(y), "swiglufused")
    with torch.no_grad():
        got = model.pretrained.blocks[0].mlp(_t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_swiglu_block_matches_jax(toy):
    params, model = toy
    x = _rand((2, 17, 128), 2)
    for i in range(2):
        ref, _ = jdinov2._block_step(jnp.asarray(x), _block(params, i), num_heads=2,
                                     use_pallas=False, ffn_layer="swiglufused")
        with torch.no_grad():
            got = model.pretrained.blocks[i](_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_swiglu_encoder_taps_match_jax(toy):
    params, model = toy
    x = _rand((4, 56, 56, 3), 3)
    ref = jdinov2.get_intermediate_layers(jax.tree.map(jnp.asarray, params["pretrained"]),
                                          jnp.asarray(x), J_VIT, [0, 1], use_pallas=False)
    with torch.no_grad():
        got = model.pretrained.get_intermediate_layers(_t(x), [0, 1])
    for (gp, gc), (rp, rc) in zip(got, ref):
        np.testing.assert_allclose(gp.numpy(), np.asarray(rp), **TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), **TOL)


@pytest.fixture(scope="module")
def forward_pair(toy):
    params, model = toy
    x = _rand((1, 4, 56, 56, 3), 4)
    ref = np.asarray(jvd.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), J_CFG,
                                 use_pallas=False))
    return model, x, ref


def test_swiglu_full_forward_matches_jax(forward_pair):
    model, x, ref = forward_pair
    with torch.no_grad():
        got = model(_t(x)).numpy()
    assert got.shape == ref.shape == (1, 4, 56, 56)
    atol = 1e-4 * max(float(ref.max() - ref.min()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol)


def test_swiglu_bf16_forward_within_drift_budget(forward_pair):
    model, x, ref = forward_pair
    with torch.no_grad():
        got = copy.deepcopy(model).to(torch.bfloat16)(_t(x).bfloat16()).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    rep = precision_drift_report(got, ref)
    assert rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC, rep


def test_convert_strict_load_of_w12_w3(toy):
    """The port's conversion equals the JAX export key for key (mlp.w12 /
    mlp.w3, the reference SwiGLUFFNFused names), and the model's own
    state_dict has exactly those keys."""
    params, _ = toy
    ours = state_dict_from_params(params, J_VIT.depth)
    ref = export_torch_state_dict(jax.tree.map(jnp.asarray, params), J_CFG)
    assert sorted(ours) == sorted(ref)
    assert "pretrained.blocks.1.mlp.w12.weight" in ref and "pretrained.blocks.1.mlp.w3.bias" in ref
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    model = VideoDepthAnything(T_CFG)
    assert sorted(model.state_dict()) == sorted(ref)
    model.load_state_dict({k: _t(v) for k, v in ref.items()}, strict=True)
    bad = dict(ours)
    bad["pretrained.blocks.0.mlp.fc1.weight"] = bad.pop("pretrained.blocks.0.mlp.w12.weight")
    with pytest.raises(RuntimeError, match="w12"):
        VideoDepthAnything(T_CFG).load_state_dict(bad, strict=True)


# ---- int8 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(toy):
    params, model = toy
    x = _rand((1, 4, 56, 56, 3), 5)
    jstats = jax.device_get(jvd.calibrate_stats(jax.tree.map(jnp.asarray, params),
                                                jnp.asarray(x), J_CFG, use_pallas=False))
    return x, jstats


def test_swiglu_calibration_stats_match_jax(toy, calibrated):
    """The fc1 / fc2 slots carry the w12 and w3 inputs' absmaxes, as JAX's
    do; every stat at rtol 1e-5, in JAX's tree."""
    _, model = toy
    x, jstats = calibrated
    with torch.no_grad():
        stats = tinfer._numpy_tree(model.calibrate_stats(_t(x)))
    want, got = flatten_tree(jstats), flatten_tree(stats)
    assert sorted(got) == sorted(want)
    assert set(stats["encoder"]) == set(quant.ACT_SITES)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_swiglu_int8_blocks_match_jax(toy, calibrated):
    """Each int8 SwiGLU block from the same tokens: relative L2 < 1e-3 of
    JAX int8 (the quantized w12 -> silu * x2 -> w3 branch of _block_step);
    every site of the block is int8."""
    params, model = toy
    x, jstats = calibrated
    jenc = jquant.quantize_encoder(jax.tree.map(jnp.asarray, params["pretrained"]),
                                   jstats["encoder"], J_VIT.depth)
    enc = quant.quantize_model(model, jstats).pretrained
    tokens = jdinov2._embed_tokens(jenc, jnp.asarray(x[0]), J_VIT)
    for i, blk in enumerate(enc.blocks):
        assert all(isinstance(m, quant.QLinear)
                   for m in (blk.attn.qkv, blk.attn.proj, blk.mlp.w12, blk.mlp.w3))
        assert blk.attn.q_amax is not None
        bp = jax.tree.map(lambda a: a[i], jenc["blocks"])
        want, _ = jdinov2._block_step(tokens, bp, num_heads=2, use_pallas=False,
                                      ffn_layer="swiglufused")
        with torch.no_grad():
            got = blk(_t(tokens)).numpy()
        assert _rel(got, want) < REL_VS_INT8, (i, _rel(got, want))
        tokens = want


@pytest.fixture(scope="module")
def jax_int8(toy, tmp_path_factory):
    params, _ = toy
    frames = synthetic_video(n=40, hw=(42, 56), seed=6)
    path = str(tmp_path_factory.mktemp("swiglu") / "jax.int8calib.npz")
    j8, _ = JaxPipeline(J_CFG, jax.tree.map(jnp.asarray, params), use_pallas=False,
                        quant="int8", calib_path=path).infer_video_depth(
                            frames, input_size=INPUT, fp32=True)
    return frames, np.asarray(j8), path


def test_swiglu_int8_pipeline_within_flip_floor(toy, jax_int8, tmp_path):
    """The port's int8 pipeline on the JAX-written side file: every encoder
    site int8 (w12 and w3 included), within twice the flip floor of JAX
    int8 (test_torch_quant.py's rule)."""
    _, model = toy
    frames, j8, path = jax_int8
    pipe = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8", calib_path=path)
    got, _ = pipe.infer_video_depth(frames, input_size=INPUT, fp32=True)
    assert got.shape == j8.shape and np.isfinite(got).all()
    (qmodel,) = pipe._int8.values()
    for blk in qmodel.pretrained.blocks:
        assert all(isinstance(m, quant.QLinear)
                   for m in (blk.attn.qkv, blk.attn.proj, blk.mlp.w12, blk.mlp.w3))
    assert not any(isinstance(m, torch.nn.Linear) for m in qmodel.pretrained.modules())
    nudged = str(tmp_path / "nudged.int8calib.npz")
    tinfer.scale_side_file(path, nudged, 1 + 1e-6)
    floor, _ = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8",
                                  calib_path=nudged).infer_video_depth(
                                      frames, input_size=INPUT, fp32=True)
    rep = flip_floor_report(j8, got, floor)
    assert rep["ok"], rep


def test_swiglu_side_file_interchange_both_ways(toy, jax_int8, tmp_path):
    """The side file JAX wrote for the SwiGLU model reads in the port with
    the port's own calibration's keys and values (rtol 1e-5); the port's
    file reads in JAX."""
    _, model = toy
    frames, _, jpath = jax_int8
    from video_depth_anything_torch.pipeline import preprocess
    net_hw = preprocess.network_input_hw(42, 56, preprocess.effective_input_size(42, 56, INPUT))
    jstats = tinfer._load_calib(jpath, net_hw, torch.float32)
    assert jstats is not None
    tpath = str(tmp_path / "port.int8calib.npz")
    VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8", calib_path=tpath
                       ).infer_video_depth(frames, input_size=INPUT, fp32=True)
    tstats = tinfer._load_calib(tpath, net_hw, torch.float32)
    want, got = flatten_tree(jstats), flatten_tree(tstats)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    back = jax.device_get(jinfer._load_calib(tpath, net_hw, jnp.float32))
    assert sorted(flatten_tree(back)) == sorted(want)


def test_vitg_model_config_matches_jax():
    """The port's vitg tables are the JAX package's."""
    from video_depth_anything_tpu.config import get_model_config as j_config
    j, t = j_config("vitg"), get_model_config("vitg")
    assert dataclasses.asdict(t.vit) == dataclasses.asdict(j.vit)
    assert t.intermediate_layer_idx == j.intermediate_layer_idx == [9, 19, 29, 39]
    assert (t.features, tuple(t.out_channels)) == (j.features, tuple(j.out_channels)) == (
        384, (1536,) * 4)


def test_vitg_width_forward_and_drift_match_jax():
    """vitg's width (1536, 24 heads, SwiGLU; head features 384, out channels
    1536) cut to 4 blocks, T = 4 at 112²: the fp32 forward matches JAX's at
    rtol 1e-3 / atol 1e-4 of the range; the port's bf16 drifts from its
    fp32 by no more than JAX's bf16 drifts from JAX's fp32, times 1.25, in
    the max and the mean of utils/precision.py's report; int8 on JAX's
    calibration stats lies within twice the flip floor of JAX int8. The
    drift is the function's own: on these random weights JAX's bf16 sits
    near the mean budget at this width, so the port is held to JAX's drift
    rather than to the budget."""
    over = dict(features=384, out_channels=(1536,) * 4, taps=(0, 1, 2, 3), num_frames=4)
    jcfg = JModelConfig(encoder="_tinytorchvitgwidth", **over,
                        vit_override=JViTConfig(1536, depth=4, num_heads=24, ffn_layer="swiglufused"))
    tcfg = ModelConfig(encoder="vits", **over,
                       vit_override=ViTConfig(1536, depth=4, num_heads=24, ffn_layer="swiglufused"))
    params = perturbed_params(jcfg)
    x = _rand((1, 4, 112, 112, 3), 9)
    jp = jax.tree.map(jnp.asarray, params)
    j32 = np.asarray(jvd.forward(jp, jnp.asarray(x), jcfg, use_pallas=False))
    j16 = np.asarray(jvd.forward(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
                                 jnp.asarray(x).astype(jnp.bfloat16), jcfg, use_pallas=False))
    model = model_from_params(params, tcfg)
    with torch.no_grad():
        t32 = model(_t(x)).numpy()
        t16 = copy.deepcopy(model).to(torch.bfloat16)(_t(x).bfloat16()).numpy()
    atol = 1e-4 * max(float(j32.max() - j32.min()), 1.0)
    np.testing.assert_allclose(t32, j32, rtol=1e-3, atol=atol)
    jrep, trep = precision_drift_report(j16, j32), precision_drift_report(t16, t32)
    for k in ("max_err_frac", "mean_err_frac"):
        assert trep[k] <= 1.25 * jrep[k], (k, trep, jrep)
    # int8 (fp32 activations, JAX's stats carried across): within twice the
    # flip floor of JAX int8 (test_torch_quant.py's rule), uncapped, since
    # at this width the floor's mean reaches the int8 budget by itself.
    jstats = jax.device_get(jvd.calibrate_stats(jp, jnp.asarray(x), jcfg, use_pallas=False))
    j8 = np.asarray(jvd.forward(jvd.quantize_model(jp, jstats, jcfg), jnp.asarray(x), jcfg,
                                use_pallas=False))
    with torch.no_grad():
        t8 = quant.quantize_model(model, jstats)(_t(x)).numpy()
        floor = quant.quantize_model(model, _scaled(jstats, 1 + 1e-6))(_t(x)).numpy()
    rep = flip_floor_report(j8, t8, floor, cap=False)
    assert rep["ok"], rep


def test_flip_floor_cap_only_lifts_the_budget_cap():
    """flip_floor_report(cap=False) holds to twice the floor without the
    int8-budget cap (chip_smoke (k) on vitg's width, where the floor's own
    mean reaches the budget); the default keeps the cap."""
    rng = np.random.default_rng(5)
    ref = rng.random((4, 8, 8)).astype(np.float32)
    floor = ref + 0.2 * rng.standard_normal(ref.shape).astype(np.float32)
    cand = ref + 0.25 * rng.standard_normal(ref.shape).astype(np.float32)
    capped, free = flip_floor_report(cand, ref, floor), flip_floor_report(cand, ref, floor, cap=False)
    assert capped["limit"]["mean_err_frac"] == 0.002 and capped["limit"]["max_err_frac"] == 0.08
    for k in ("max_err_frac", "mean_err_frac", "rel_l2"):
        assert free["limit"][k] == 2 * free["floor"][k]
    assert capped["limit"]["rel_l2"] == free["limit"]["rel_l2"]
    assert not capped["ok"] and free["ok"] == all(
        free["got"][k] < free["limit"][k] for k in free["limit"])
