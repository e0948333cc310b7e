"""The port's stage tools (``video_depth_anything_torch/tools/bench_*.py``)
on the CPU, where they measure nothing.

- Every card tool exits 2 without a card.
- Their shape and constant lists are the JAX tools', restated here with
  the JAX file and line (the JAX tools are not imported: several read
  ``sys.argv`` or allocate at import).
- bench_ablate: each variant's stubs keep their site's shape, dtype and
  device and write a dense output where the site does (every call of a
  stubbed site is run both ways and compared; the order of the dims in
  memory may differ), the ablated forward keeps the output's shape and dtype, and
  leaving the variant restores the model bit for bit, also after an error.
- bench_segments' and bench_head_fine's stage functions, composed, equal
  the port's forward bit for bit; on weights converted from JAX
  (``convert.model_from_params``) the same stages equal the JAX functions
  those JAX tools call, in fp32 at rtol = atol = 1e-4.

Toy sizes only: vits at 56^2 (4 frames) for the ablations, 112^2 for the
JAX comparison.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.models import dinov2 as jdinov2
from video_depth_anything_tpu.models import dpt as jdpt
from video_depth_anything_tpu.models import video_depth as jvd
from video_depth_anything_tpu.models.motion import temporal_module as j_temporal_module
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.convert import model_from_params
from video_depth_anything_torch.tools import (
    bench_ablate, bench_attn_kernel, bench_drift_518, bench_head_convs, bench_head_fine,
    bench_int8_conv, bench_memory, bench_mxu_geometry, bench_residue, bench_segments,
    bench_stock_flash, bench_temporal_kernel, bench_temporal_swap, timing)

CARD_TOOLS = [bench_ablate, bench_segments, bench_head_fine, bench_head_convs, bench_memory,
              bench_mxu_geometry, bench_int8_conv, bench_residue, bench_drift_518,
              bench_temporal_swap, bench_temporal_kernel, bench_stock_flash, bench_attn_kernel]
TOL = dict(rtol=1e-4, atol=1e-4)

torch.set_num_threads(2)


@pytest.mark.parametrize("tool", CARD_TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_card_tool_exits_2_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [tool.__name__])
    assert tool.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _defaults(fn):
    import inspect
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def _ablate():
    # tools/bench_ablate.py:26-33 (encoder, modes, T, SIZE, CHAIN, ITERS), :236 (head stages)
    assert (bench_ablate.T, bench_ablate.SIZE, bench_ablate.CHAIN, bench_ablate.ITERS) == (
        32, 518, 3, 5)
    assert bench_ablate.MODES == ("default", "head", "temporal", "encoder")
    cfg = get_model_config("vitl")
    assert [v[1] for v in bench_ablate.variants("head", cfg)] == [
        "conv1", "resize", "conv2a", "conv2b"]
    assert [v[1] for v in bench_ablate.variants("default", cfg)] == [   # :290-294
        "temporal modules", "refinenet RCUs", "output head", "scratch_rn", "dpt resize interp"]


def _segments():
    # tools/bench_segments.py:25-27 (T, SIZE, CHAIN), :30 (iters=5)
    assert (bench_segments.T, bench_segments.SIZE, bench_segments.CHAIN,
            bench_segments.ITERS) == (32, 518, 3, 5)


def _head_fine():
    # tools/bench_head_fine.py:26-29; the motion modules' shapes :100-105 (vitl, ph = 37)
    assert (bench_head_fine.T, bench_head_fine.SIZE, bench_head_fine.CHAIN,
            bench_head_fine.ITERS) == (32, 518, 3, 5)
    assert bench_head_fine.tm_shapes(get_model_config("vitl"), 32, 37, 37) == {
        "0": (32, 37, 37, 1024), "1": (32, 19, 19, 1024), "2": (32, 37, 37, 256),
        "3": (32, 74, 74, 256)}


def _head_convs():
    # tools/bench_head_convs.py:20-21 (N, CHAIN), :38 (iters=4), :65-96 (stages, flops)
    n = 32
    assert (bench_head_convs.N, bench_head_convs.CHAIN, bench_head_convs.ITERS) == (n, 6, 4)
    assert bench_head_convs.STAGES == [
        ("output_conv1 3x3 256->128 @296^2", (n, 296, 296, 256), 2 * n * 296 * 296 * 9 * 256 * 128),
        ("output tail 3x3 128->32 + 1x1 32->1 @518^2", (n, 518, 518, 128),
         2 * n * 518 * 518 * (9 * 128 * 32 + 32)),
        ("layer1_rn 3x3 256->256 @148^2", (n, 148, 148, 256), 2 * n * 148 * 148 * 9 * 256 * 256),
        ("bilinear 296->518 @128ch", (n, 296, 296, 128), 0)]


def _memory():
    # tools/bench_memory.py:22-26 (the reference's A100 rows)
    assert bench_memory.REF_VRAM_GB == {("vits", "float32"): 7.3, ("vits", "bfloat16"): 6.8,
                                        ("vitl", "float32"): 26.7, ("vitl", "bfloat16"): 23.6}


def _mxu_geometry():
    # tools/bench_mxu_geometry.py:32-34 (EST_TF, margin, repeats), :88-113 (shapes)
    assert (bench_mxu_geometry.EST_TF, timing.TARGET_MARGIN_S, timing.ITERS) == (
        120e12, 0.25, 5)
    m = 32 * 1408
    assert [(s[1], *s[2:]) for s in bench_mxu_geometry.SHAPES] == [
        ("bf16 4096^3", 4096, 4096, 4096, "bfloat16"), ("bf16 2048^3", 2048, 2048, 2048, "bfloat16"),
        ("int8 4096^3", 4096, 4096, 4096, "int8"),
        ("qkv", m, 1024, 3072, "bfloat16"), ("mlp-up", m, 1024, 4096, "bfloat16"),
        ("mlp-dn", m, 4096, 1024, "bfloat16"), ("proj", m, 1024, 1024, "bfloat16"),
        ("qk64", 1408, 64, 1408, "bfloat16"), ("qk128", 1408, 128, 1408, "bfloat16"),
        ("pv128", 1408, 1408, 128, "bfloat16"), ("pv256", 1408, 1408, 256, "bfloat16"),
        ("pv512", 1408, 1408, 512, "bfloat16")]
    assert bench_mxu_geometry.OVER_PEAK == 1.05


def _int8_conv():
    # tools/bench_int8_conv.py:11-13 (B, H, W, C, K, CHAIN), :25 (iters=5)
    t = bench_int8_conv
    assert (t.B, t.H, t.W, t.C, t.K, t.CHAIN, t.ITERS) == (32, 148, 148, 256, 3, 8, 5)


def _residue():
    # tools/bench_residue.py:44-48 (the CLI's defaults)
    assert _defaults(bench_residue.measure) == dict(iters=6, chain=3, size=518, dummy_programs=4,
                                                    dummy_trees=3)


def _drift_518():
    # tools/bench_drift_518.py:30-36 (the CLI's defaults)
    d = _defaults(bench_drift_518.measure)
    assert (d["encoder"], d["frames"], tuple(d["src_hw"]), d["input_size"], d["seed"]) == (
        "vitl", 50, (644, 644), 518, 3)


def _temporal_swap():
    # tools/bench_temporal_swap.py:29-32; the routed shape :63-68 (grouped 128 lanes of
    # 4 heads: dh 32, which is C 256 at 8 heads ungrouped)
    t = bench_temporal_swap
    assert (t.T, t.SIZE, t.CHAIN, t.ITERS) == (32, 518, 3, 5)
    assert (t.SITE_C, t.SITE_DH) == (4 * 64, 128 // 4)
    with torch.device("meta"):
        from video_depth_anything_torch.models import VideoDepthAnything
        assert t.kernel_sites(VideoDepthAnything(get_model_config("vitl"))) == [2, 3]
        assert t.kernel_sites(VideoDepthAnything(get_model_config("vits"))) == []


def _temporal_kernel():
    # tools/bench_temporal_kernel.py:28-31 (T, HEADS, CHAIN, ITERS), :36-41 (shapes; m2, m3
    # grouped: P x 2 pixels of 4 heads x 128 lanes, i.e. P pixels of 8 heads x 32)
    t = bench_temporal_kernel
    assert (t.T, t.HEADS, t.CHAIN, t.ITERS) == (32, 8, 64, 3)
    jax_shapes = [(1369, 1024, 8), (361, 1024, 8), (2738, 128, 4), (10952, 128, 4)]
    ungrouped = [(p, c, h) if c != 128 else (p // 2, 2 * c, 2 * h) for p, c, h in jax_shapes]
    assert [s[1:] for s in t.SHAPES] == ungrouped


def _stock_flash():
    # tools/bench_stock_flash.py:25-30 (B, S, H, DH, CHAIN, ITERS)
    t = bench_stock_flash
    assert (t.B, t.S, t.H, t.DH, t.CHAIN, t.ITERS) == (32, 1370, 16, 64, 8, 8)


def _attn_kernel():
    # tools/bench_attn_kernel.py:30-35 (B, S, H, DH, CHAIN, ITERS)
    t = bench_attn_kernel
    assert (t.B, t.S, t.H, t.DH, t.CHAIN, t.ITERS) == (32, 1370, 16, 64, 8, 8)


CONSTANTS = {"bench_ablate": _ablate, "bench_segments": _segments, "bench_head_fine": _head_fine,
             "bench_head_convs": _head_convs, "bench_memory": _memory,
             "bench_mxu_geometry": _mxu_geometry, "bench_int8_conv": _int8_conv,
             "bench_residue": _residue, "bench_drift_518": _drift_518,
             "bench_temporal_swap": _temporal_swap, "bench_temporal_kernel": _temporal_kernel,
             "bench_stock_flash": _stock_flash, "bench_attn_kernel": _attn_kernel}


@pytest.mark.parametrize("tool", sorted(CONSTANTS))
def test_shapes_and_constants_are_the_jax_tools(tool):
    CONSTANTS[tool]()


# ---------------------------------------------------------------- bench_ablate's stubs


@pytest.fixture(scope="module")
def toy():
    """vits (seeded, fp32, CPU) and a 1x4x56x56 window, with its output."""
    _, model, x = bench_ablate.window("vits", frames=4, size=56, device="cpu",
                                      dtype=torch.float32)
    with torch.no_grad():
        return model, x, model(x)


def _dense(t) -> bool:
    """Whether t's elements fill its extent in some order of its dims (a
    written-out tensor, contiguous or permuted), not a view into more."""
    expect = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda d: d[1]):
        if size > 1 and stride != expect:
            return False
        expect *= size
    return True


def _layout(t):
    if isinstance(t, torch.Tensor):
        return (tuple(t.shape), t.dtype, t.device, _dense(t))
    return type(t), [_layout(u) for u in t]


def _spied(patches, seen):
    """Each patch's value wrapped so that a call runs the real site and the
    stub on the same arguments, records both layouts and returns the real
    output."""
    out = []
    for owner, name, stub in patches:
        real = owner.__dict__[name]

        def spy(*args, real=real, stub=stub, name=name, **kwargs):
            got = real(*args, **kwargs)
            seen.append((name, _layout(got), _layout(stub(*args, **kwargs))))
            return got
        out.append((owner, name, spy))
    return out


VARIANTS = [(mode, i) for mode in bench_ablate.MODES
            for i in range(len(bench_ablate.variants(mode, get_model_config("vits"))))]


@pytest.mark.parametrize("mode,i", VARIANTS)
def test_ablation_stub_keeps_layout_and_is_restored(toy, mode, i):
    model, x, ref = toy
    label, key, sign, patches = bench_ablate.variants(mode, model.cfg)[i]
    before = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    seen = []
    with torch.no_grad():
        with bench_ablate.patched(_spied(patches, seen)):
            spied = model(x)
        assert torch.equal(spied, ref)
        assert seen, f"{label}: no stubbed site was reached"
        for name, real, stub in seen:
            assert real == stub, (label, name)
        with bench_ablate.patched(patches):
            out = model(x)
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert bool(torch.isfinite(out).all())
        if sign == 1:     # a plain version computes its kernel's function
            assert not torch.equal(out, ref), f"{label}: the stub changed nothing"
        assert all(owner.__dict__[name] is v for owner, name, v in before)
        assert torch.equal(model(x), ref)


def _output_head_unsplit(sc, path_1, out_hw, train=False):
    """``Scratch.output_head`` as one body, before its stages became
    methods (the --head ablation patches those methods)."""
    from video_depth_anything_torch.models.dpt import resize_bilinear_align_corners
    from video_depth_anything_torch.ops import nn as vnn

    c1 = sc.output_conv1
    out = vnn.conv2d(path_1, c1.weight, c1.bias, padding=1)
    out = resize_bilinear_align_corners(out, out_hw)
    c2a, c2b = sc.output_conv2[0], sc.output_conv2[2]
    if out.dtype == torch.float32 or train:
        out = vnn.relu(vnn.conv2d(out.float(), c2a.weight, c2a.bias, padding=1))
        return vnn.relu(vnn.conv2d(out, c2b.weight, c2b.bias))
    out = vnn.conv2d(out, c2a.weight, None, padding=1)
    out = torch.relu(out.float() + c2a.bias.float()).to(torch.bfloat16)
    out = torch.matmul(out.float(), c2b.weight.float().reshape(-1, 1))
    return torch.relu(out + c2b.bias.float())


@pytest.mark.parametrize("dtype,train", [(torch.float32, False), (torch.bfloat16, False),
                                         (torch.bfloat16, True)],
                         ids=["fp32", "bf16", "bf16-train"])
def test_split_output_head_is_the_unsplit_one(toy, dtype, train):
    import copy

    model = toy[0]
    sc = copy.deepcopy(model.head.scratch).to(dtype)
    gen = torch.Generator().manual_seed(5)
    path_1 = torch.randn(3, 8, 8, sc.output_conv1.weight.shape[1], generator=gen).to(dtype)
    with torch.no_grad():
        got = sc.output_head(path_1, (56, 56), train=train)
        want = _output_head_unsplit(sc, path_1, (56, 56), train=train)
    assert got.dtype == want.dtype == torch.float32 and got.shape == (3, 56, 56, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_output_head_frees_the_full_resolution_map_as_the_unsplit_one(toy, dtype, monkeypatch):
    """The resized map (vits bf16 at 1x32x518²: 0.51 GiB) dies where the
    unsplit body let it die: in the bf16 path once output_conv2's 3x3 has
    read it, before the fp32 temporaries; in the fp32 island before the 1x1.
    Holding it through the stages raised the vits bf16 window's peak from
    3.29 to 3.80 GiB on the card."""
    import copy
    import weakref

    from video_depth_anything_torch.models import dpt

    sc = copy.deepcopy(toy[0].head.scratch).to(dtype)
    path_1 = torch.randn(2, 8, 8, sc.output_conv1.weight.shape[1],
                         generator=torch.Generator().manual_seed(6)).to(dtype)
    resized, alive = [], []
    head_resize, head_conv2b, relu = dpt.Scratch.head_resize, dpt.Scratch.head_conv2b, torch.relu

    def spy_resize(self, x, out_hw):
        out = head_resize(self, x, out_hw)
        resized.append(weakref.ref(out))
        return out

    def spy_relu(x):        # bf16: the fp32 bias add's ReLU in head_conv2a, then the last
        alive.append(("relu", resized[0]() is not None))
        return relu(x)

    def spy_conv2b(self, x, island):
        alive.append(("conv2b", resized[0]() is not None))
        return head_conv2b(self, x, island)

    monkeypatch.setattr(dpt.Scratch, "head_resize", spy_resize)
    monkeypatch.setattr(dpt.Scratch, "head_conv2b", spy_conv2b)
    monkeypatch.setattr(torch, "relu", spy_relu)
    with torch.no_grad():
        sc.output_head(path_1, (56, 56))
    want = [("conv2b", False)] if dtype == torch.float32 else [("relu", False), ("conv2b", False),
                                                                ("relu", False)]
    assert alive == want


def test_patched_restores_after_an_error(toy):
    model, x, ref = toy
    patches = bench_ablate.variants("default", model.cfg)[0][3]
    before = patches[0][0].__dict__[patches[0][1]]
    with pytest.raises(RuntimeError, match="inside"):
        with bench_ablate.patched(patches):
            raise RuntimeError("inside")
    assert patches[0][0].__dict__[patches[0][1]] is before
    with torch.no_grad():
        assert torch.equal(model(x), ref)


def test_k2_only_at_routes_by_module_and_restores(toy, monkeypatch):
    from video_depth_anything_torch.models import motion

    model, x, ref = toy
    calls = []
    real = motion.temporal_attention

    def counted(q, *a, **kw):
        calls.append(q.shape[-1])
        return real(q, *a, **kw)

    monkeypatch.setattr(motion, "temporal_attention", counted)
    with torch.no_grad(), bench_temporal_swap.k2_only_at(model, [2, 3]):
        out = model(x)
    assert torch.equal(out, ref)   # on the CPU both routes are the plain version
    assert calls == [64, 64, 64, 64]   # the kernel's route at modules 2 and 3 (C 64) alone
    assert not any("forward" in m.__dict__ for m in model.head.motion_modules)


# ---------------------------------------------------------------- stage functions


def test_stage_functions_compose_to_the_forward(toy):
    """bench_segments' stages (the taps, the head, finish) and bench_head_fine's
    (project, tmod, Scratch.rn, cascade, output_head) make the forward."""
    from video_depth_anything_torch.models.video_depth import finish

    model, x, ref = toy
    b, t, h, w, _ = x.shape
    ph, pw = h // 14, w // 14
    hd = model.head
    with torch.no_grad():
        feats = bench_segments.encoder_taps(model, x)
        depth = model.head(feats, ph, pw, b, t)
        assert torch.equal(finish(depth, b, t, h, w), ref)
        l1, l2, l3, l4 = hd.project(hd.grids(feats, ph, pw))
        rns = hd.scratch.rn([l1, l2, hd.tmod(0, l3, b, t), hd.tmod(1, l4, b, t)])
        path_1 = hd.cascade(rns, lambda i, p: hd.tmod(i, p, b, t))
        assert torch.equal(hd.scratch.output_head(path_1, (14 * ph, 14 * pw)), depth)


@pytest.fixture(scope="module")
def converted():
    """vits from JAX's init_params(0) (proj_out perturbed, so the motion
    modules do work), a 1x4x112x112 window and the taps of both."""
    cfg = j_config("vits")
    params = jax.tree.map(np.asarray, jvd.init_params(0, cfg))
    rng = np.random.default_rng(7)
    for mm in params["head"]["motion_modules"].values():
        po = mm["temporal_transformer"]["proj_out"]
        for k in po:
            po[k] = (po[k] + 0.02 * rng.standard_normal(po[k].shape)).astype(np.float32)
    model = model_from_params(params, get_model_config("vits"))
    x = rng.standard_normal((1, 4, 112, 112, 3)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    return cfg, jp, model, x


def test_stages_match_the_jax_functions(converted):
    cfg, jp, model, x = converted
    b, t, h, w, _ = x.shape
    ph, pw = h // 14, w // 14
    hd = model.head
    with torch.no_grad():
        feats = bench_segments.encoder_taps(model, torch.from_numpy(x))
    jfeats = jdinov2.get_intermediate_layers(jp["pretrained"], jnp.asarray(x.reshape(-1, h, w, 3)),
                                             cfg.vit, cfg.intermediate_layer_idx,
                                             use_pallas=False)
    for (gp, gc), (rp, rc) in zip(feats, jfeats):
        np.testing.assert_allclose(gp.numpy(), np.asarray(rp), **TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), **TOL)
    # The head on the same (JAX's) taps.
    tfeats = [(torch.from_numpy(np.array(p)), torch.from_numpy(np.array(c)))
              for p, c in jfeats]
    with torch.no_grad():
        depth = model.head(tfeats, ph, pw, b, t)
    np.testing.assert_allclose(depth.numpy(), np.asarray(
        jvd._head_forward(jp["head"], jfeats, ph, pw, b, t, cfg)), **TOL)
    # bench_head_fine's stages on the same inputs: motion modules 0 and 2,
    # the scratch convs, the output head.
    with torch.no_grad():
        layers = hd.project(hd.grids(tfeats, ph, pw))
    mkw = dict(num_heads=cfg.num_attention_heads, pe=cfg.pe,
               num_transformer_block=cfg.num_transformer_block,
               num_attention_blocks=cfg.num_attention_blocks)
    for i, layer in ((0, layers[2]), (2, layers[2][..., :cfg.features].contiguous())):
        with torch.no_grad():
            got = hd.tmod(i, layer, b, t)
        ref = j_temporal_module(jp["head"]["motion_modules"][str(i)], jnp.asarray(layer.numpy()),
                                b, t, **mkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with torch.no_grad():
        rns = hd.scratch.rn(list(layers))
    jrns = jdpt.scratch_rn(jp["head"], [jnp.asarray(v.numpy()) for v in layers])
    for got, ref in zip(rns, jrns):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with torch.no_grad():
        path_1 = hd.cascade(rns, lambda i, p: p)
        out = hd.scratch.output_head(path_1, (14 * ph, 14 * pw))
    ref = jdpt.output_head(jp["head"], jnp.asarray(path_1.numpy()), (14 * ph, 14 * pw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
