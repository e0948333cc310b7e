"""The port's CUDA kernels and its pipeline on the card.

Each test needs a CUDA card and skips without one (a CUDA kernel has no
interpret mode). This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances (max abs error, unit-normal v): fp32 1e-4; bf16 2e-2, which
covers the bf16 rounding of the unnormalised probabilities against a
running (kernel) versus a global (plain) row max. At these short
sequences (77 to 200 keys) the outputs are of order 1 (max |o| about 0.7
to 2), so 2e-2 is 1 % to 3 % of the largest output; chip_smoke.py holds the
encoder shapes, whose outputs are ten times smaller, to 4e-3. The int8
pipeline: the card's and the CPU's fp32 rounding flip a
few quant_act roundings by one step, and those flips compound
(tests/test_torch_quant.py); the card is held to twice the flip floor
measured on the CPU (the same run with every absmax scaled by 1 + 1e-6,
utils/precision.py::flip_floor_report).
"""
import copy
import functools

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from video_depth_anything_torch import kernels
from video_depth_anything_torch.config import ViTConfig, get_model_config
from video_depth_anything_torch.kernels import attention_head_major as k4
from video_depth_anything_torch.kernels import attention_variants as t2
from video_depth_anything_torch.kernels import fused_rcu as k6
from video_depth_anything_torch.kernels import head_output_tail as k7
from video_depth_anything_torch.kernels import qk_probes as qp
from video_depth_anything_torch.kernels import spatial_attention as k1
from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3
from video_depth_anything_torch.kernels import spatial_attention_qkv as k5
from video_depth_anything_torch.kernels import swiglu as k8
from video_depth_anything_torch.kernels import temporal_attention as k2
from video_depth_anything_torch.models import build_model
from video_depth_anything_torch.models.dinov2 import SwiGLUFFNFused
from video_depth_anything_torch.models.dpt import FeatureFusionBlock
from video_depth_anything_torch.ops import quant
from video_depth_anything_torch.pipeline import VideoDepthPipeline, infer
from video_depth_anything_torch.utils import profiling
from video_depth_anything_torch.utils.precision import synthetic_video


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def counts(**launched):
    """Every kernel's launch count: 0 but for those named."""
    return {name: launched.get(name, 0) for name in kernels.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_versions(card, dt, tol):
    kernels.reset_launch_counts()
    qkv = torch.randn(3, 200, 3 * 384, device="cuda", generator=card).to(dt)
    q, k, v = qkv[..., :384], qkv[..., 384:768], qkv[..., 768:]
    got = k1.spatial_attention(q, k, v, num_heads=6, scale=0.125)
    ref = k1.spatial_attention_plain(q, k, v, num_heads=6, scale=0.125)
    assert (got.float() - ref.float()).abs().max().item() <= tol
    for t, c in ((32, 192), (4, 1024), (7, 64)):
        q, k, v = (torch.randn(50, t, c, device="cuda", generator=card).to(dt)
                   for _ in range(3))
        dh = c // 8
        got = k2.temporal_attention(q, k, v, num_heads=8, scale=dh ** -0.5)
        ref = k2.temporal_attention_plain(q, k, v, num_heads=8, scale=dh ** -0.5)
        assert (got.float() - ref.float()).abs().max().item() <= tol
    assert kernels.launch_counts() == counts(spatial_attention=1, temporal_attention=3)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    """dh = 32 is K4's now (launched, not raised); a head dim K4 does not
    take still raises: no plain fallback on the card."""
    x = torch.zeros(2, 10, 64, device="cuda")
    kernels.reset_launch_counts()
    k1.spatial_attention(x, x, x, num_heads=2, scale=0.125)
    assert kernels.launch_counts() == counts(attention_head_major=1)
    z = torch.zeros(2, 10, 136, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        k1.spatial_attention(z, z, z, num_heads=1, scale=0.125)
    y = torch.zeros(2, 33, 64, device="cuda")
    with pytest.raises(ValueError, match="T=33"):
        k2.temporal_attention(y, y, y, num_heads=8, scale=0.125)
    w = torch.zeros(1, 8, 8, 448, device="cuda")   # wider than a block's shared memory
    ops = k6.kernel_weight(torch.zeros(448, 448, 3, 3, device="cuda"), w.dtype)
    b = torch.zeros(448, device="cuda")
    with pytest.raises(ValueError, match="multiple of 64"):
        k6.fused_rcu(w, ops, b, ops, b)


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_the_cpu_plain_path(card):
    """fp32 on the card (no TF32) against the plain path on the CPU, within
    1e-3 of the depth range; the default device is the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config("vits")
    model = build_model(cfg, seed=0)
    cpu = VideoDepthPipeline(cfg, copy.deepcopy(model), device="cpu")
    gpu = VideoDepthPipeline(cfg, model)
    assert gpu.device.type == "cuda"
    frames = synthetic_video(n=30, hw=(70, 98))
    kernels.reset_launch_counts()
    got, _ = gpu.infer_video_depth(frames, input_size=56, fp32=True)
    assert kernels.launch_counts() == counts(spatial_attention=24, temporal_attention=16)
    ref, _ = cpu.infer_video_depth(frames, input_size=56, fp32=True)
    rng = float(ref.max() - ref.min())
    assert np.abs(got - ref).max() <= 1e-3 * rng


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k3_matches_plain_version(card, dt, tol):
    kernels.reset_launch_counts()
    scales = torch.tensor([0.013 / 8, 0.021], device="cuda")
    for b, s, h in ((3, 200, 6), (2, 77, 4)):
        c = h * 64
        q8, k8 = (torch.randint(-127, 128, (b, s, c), device="cuda", generator=card,
                                dtype=torch.int8) for _ in range(2))
        v = torch.randn(b, s, 3 * c, device="cuda", generator=card).to(dt)[..., 2 * c:]
        got = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=h)
        ref = k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=h)
        assert got.dtype == dt and (got.float() - ref.float()).abs().max().item() <= tol
    assert kernels.launch_counts()["spatial_attention_qk8"] == 2
    q8, k8 = (torch.randint(-127, 128, (1, 90, 192), device="cuda", generator=card,
                            dtype=torch.int8) for _ in range(2))
    v = torch.randn(1, 90, 192, device="cuda", generator=card).to(dt)
    got = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=3)   # odd H: K1 fallback
    assert kernels.launch_counts()["spatial_attention"] == 1
    ref = k1.spatial_attention_plain(q8.to(dt) * scales[0].to(dt), k8.to(dt) * scales[1].to(dt),
                                     v, num_heads=3, scale=1.0)
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_int8_pipeline_on_the_card_matches_the_cpu_plain_path(card, tmp_path):
    """--int8 --fp32 on the card (K3 in every block) against the CPU plain
    path on the card's own side file, within the flip floor; the first call
    calibrates (K1 and K2 in the float forward), the second reads the side
    file. Model and clip are chip_smoke.py's reduced check (weights drawn
    on the card, network input 112). With the seed-0 weights drawn on the
    CPU, flips alone move the mean error by more than the int8 budget of
    0.2 % of the depth range (0.22 % at input 56, 0.28 % at 112), so no
    limit there tells a fault from a flip."""
    from video_depth_anything_torch.pipeline.infer import scale_side_file
    from video_depth_anything_torch.utils.precision import flip_floor_report

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config("vits")
    model = build_model(cfg, seed=0, device="cuda")
    path = str(tmp_path / "vits.int8calib.npz")
    frames = synthetic_video(n=40, hw=(140, 196), seed=5)    # 2 windows
    kernels.reset_launch_counts()
    got, _ = VideoDepthPipeline(cfg, model, quant="int8", calib_path=path
                                ).infer_video_depth(frames, input_size=112, fp32=True)
    assert kernels.launch_counts() == counts(spatial_attention=12, temporal_attention=24,
                                             spatial_attention_qk8=24)
    kernels.reset_launch_counts()
    again, _ = VideoDepthPipeline(cfg, model, quant="int8", calib_path=path
                                  ).infer_video_depth(frames, input_size=112, fp32=True)
    assert kernels.launch_counts() == counts(temporal_attention=16, spatial_attention_qk8=24)
    np.testing.assert_array_equal(got, again)
    cpu_model = copy.deepcopy(model).to("cpu")
    ref, _ = VideoDepthPipeline(cfg, cpu_model, device="cpu", quant="int8", calib_path=path
                                ).infer_video_depth(frames, input_size=112, fp32=True)
    nudged = str(tmp_path / "nudged.int8calib.npz")
    scale_side_file(path, nudged, 1 + 1e-6)
    floor, _ = VideoDepthPipeline(cfg, cpu_model, device="cpu", quant="int8", calib_path=nudged
                                  ).infer_video_depth(frames, input_size=112, fp32=True)
    rep = flip_floor_report(got, ref, floor)
    assert rep["ok"], rep


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k4_and_k5_match_plain_versions(card, dt, tol):
    """K4 at every head-dim tile, head-major and on split-head views of a
    fused qkv (odd H, S not a multiple of 64); K5 at dh = 64 (K1's entry)
    and dh = 32 (K4)."""
    kernels.reset_launch_counts()
    for b, h, s, d in ((2, 3, 77, 8), (2, 4, 130, 32), (1, 5, 200, 64), (2, 3, 90, 128)):
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=card).to(dt)
                   for _ in range(3))
        got = k4.attention_head_major(q, k, v, scale=d ** -0.5)
        ref = k4.attention_head_major_plain(q, k, v, scale=d ** -0.5)
        assert got.dtype == dt and (got.float() - ref.float()).abs().max().item() <= tol
    qkv = torch.randn(2, 150, 3 * 96, device="cuda", generator=card).to(dt)
    q, k, v = (qkv[..., i * 96:(i + 1) * 96] for i in range(3))
    got = k1.spatial_attention(q, k, v, num_heads=3, scale=32 ** -0.5)    # dh = 32: K4
    ref = k4.attention_head_major_plain(*(t.unflatten(-1, (3, 32)).transpose(1, 2)
                                          for t in (q, k, v)), scale=32 ** -0.5)
    assert (got.float() - ref.transpose(1, 2).reshape(2, 150, 96).float()).abs().max() <= tol
    assert kernels.launch_counts() == counts(attention_head_major=5)
    kernels.reset_launch_counts()
    for h, d in ((3, 64), (4, 32)):
        qkv = torch.randn(2, 140, 3 * h * d, device="cuda", generator=card).to(dt)
        got = k5.spatial_attention_qkv_fused(qkv, num_heads=h)
        ref = k5.spatial_attention_qkv_fused_plain(qkv, num_heads=h)
        assert (got.float() - ref.float()).abs().max().item() <= tol
    assert kernels.launch_counts() == counts(spatial_attention_qkv_fused=1,
                                             attention_head_major=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_k6_matches_plain_version_and_counts_the_opt_in(card, dt):
    """K6 at several tiles (ragged edges, C = 128 and 256); then a fusion
    block with use_kernel=True launches it twice (both units) and without
    it not at all. Tolerance: fp32 1e-4; bf16 2^-7 of the max |y|."""
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_launch_counts()
    for shape in ((2, 9, 16, 128), (1, 21, 37, 256), (3, 19, 19, 128)):
        c = shape[3]
        w1, w2 = (k6.kernel_weight(0.05 * torch.randn(c, c, 3, 3, device="cuda", generator=card),
                                   dt) for _ in range(2))
        b1, b2 = (0.1 * torch.randn(c, device="cuda", generator=card) for _ in range(2))
        x = torch.randn(shape, device="cuda", generator=card).to(dt)
        got = k6.fused_rcu(x, w1, b1, w2, b2)
        ref = k6.fused_rcu_plain(x, w1, b1, w2, b2)
        tol = 1e-4 if dt == torch.float32 else 2 ** -7 * ref.float().abs().max().item()
        assert got.dtype == dt and (got.float() - ref.float()).abs().max().item() <= tol
    assert kernels.launch_counts() == counts(fused_rcu=3)
    block = FeatureFusionBlock(128).to("cuda", dt)
    x, skip = (torch.randn(2, 10, 12, 128, device="cuda", generator=card).to(dt)
               for _ in range(2))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = block(x, skip, size=(19, 23), use_kernel=True)
        assert kernels.launch_counts() == counts(fused_rcu=2)
        ref = block(x, skip, size=(19, 23))
    assert kernels.launch_counts() == counts(fused_rcu=2)
    rng = (ref.float().max() - ref.float().min()).item()
    assert (got.float() - ref.float()).abs().max().item() <= (1e-4 if dt == torch.float32
                                                              else 0.05) * rng


@pytest.mark.cuda
def test_head_dim_32_pipeline_on_the_card_runs_k4(card):
    """chip_smoke.py's (e''): a head-dim-32 encoder, fp32, every spatial
    attention on K4, against the CPU plain path within 1e-3 of the range."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config("vits", taps=(0, 1, 2, 3),
                           vit_override=ViTConfig(embed_dim=128, depth=4, num_heads=4))
    model = build_model(cfg, seed=0, device="cuda")
    frames = synthetic_video(n=40, hw=(140, 196), seed=5)    # 2 windows
    kernels.reset_launch_counts()
    got, _ = VideoDepthPipeline(cfg, model).infer_video_depth(frames, input_size=112, fp32=True)
    assert kernels.launch_counts() == counts(attention_head_major=8, temporal_attention=16)
    ref, _ = VideoDepthPipeline(cfg, copy.deepcopy(model).to("cpu"), device="cpu"
                                ).infer_video_depth(frames, input_size=112, fp32=True)
    rng = float(ref.max() - ref.min())
    assert np.abs(got - ref).max() <= 1e-3 * rng


@pytest.mark.cuda
def test_probes_match_plain_versions(card):
    """T1's four phase probes (and the side sum of qk+sm) and T3's two QK
    probes, bf16, 3 steps of 192 rows x 256 keys. Tolerance: one bf16 step
    of the max |o| (2^-7 of it), two for qk+sm (it also rounds each
    exponential); fp32 outputs and the side sum 1e-4 of the max (the fp32
    sums run in another order)."""
    def uniform(*shape):
        return (torch.rand(shape, device="cuda", generator=card) - 0.5).to(torch.bfloat16)

    def held(got, ref, frac):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert (got.float() - ref.float()).abs().max().item() <= frac * ref.float().abs().max().item()

    q, k = uniform(3, 192, 128), uniform(3, 256, 128)
    kernels.reset_launch_counts()
    for name, heads in (("qk64x2", 2), ("qk128", 1)):
        held(qp.phase_probe(name, q, k), qp.qk_first128_plain(q, k, heads=heads), 2 ** -7)
    got, side = qp.phase_probe("qk+sm x2", q, k, side=True)
    ref, ref_side = qp.qk_softmax_plain(q, k)
    held(got, ref, 2 ** -6)
    held(side, ref_side, 1e-4)
    p, p2, v = uniform(3, 192, 256), uniform(3, 192, 256), uniform(3, 256, 128)
    held(qp.phase_probe("pv128x2", p, p2, v), qp.pv_plain(p, p2, v), 2 ** -7)
    for heads in (2, 1):
        held(qp.qk_probe(q, k, heads=heads), qp.qk_colsum_plain(q, k, heads=heads), 1e-4)
    assert kernels.launch_counts() == counts(phase_probes=4, qk_probes=2)
    with pytest.raises(TypeError, match="bfloat16"):
        qp.qk_probe(q.float(), k.float(), heads=2)


@pytest.mark.cuda
def test_t2_schedules_match_plain_version_and_k1(card):
    """T2 under each schedule at S = 200 and 130 (ragged key tiles; an odd
    tile count leaves kchunk's second chain one tile short), bf16, against
    its plain version and against K1 on the same inputs, within 2^-6 of the
    max |o| (two bf16 steps there)."""
    kernels.reset_launch_counts()
    for s in (200, 130):
        q, k, v = (torch.randn(2, s, 256, device="cuda", generator=card).to(torch.bfloat16)
                   for _ in range(3))
        ref = t2.attention_variant_plain(q, k, v, num_heads=4).float()
        k1_out = k1.spatial_attention(q, k, v, num_heads=4, scale=0.125).float()
        for sched in t2.SCHEDULES:
            got = t2.attention_variant(q, k, v, num_heads=4, schedule=sched).float()
            assert (got - ref).abs().max().item() <= 2 ** -6 * ref.abs().max().item()
            assert (got - k1_out).abs().max().item() <= 2 ** -6 * k1_out.abs().max().item()
    assert kernels.launch_counts() == counts(attention_variants=6, spatial_attention=2)
    with pytest.raises(TypeError, match="bfloat16"):
        t2.attention_variant(q.float(), k.float(), v.float(), num_heads=4, schedule="base")


def _bf16_err_ok(got, ref, tol):
    return got.dtype == ref.dtype and (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 19, 19, 256), (1, 37, 37, 128), (1, 21, 45, 384),
                                   (3, 19, 19, 128), (1, 8, 16, 256), (1, 9, 17, 64)])
def test_k6_tile_edges_match_plain_version(card, shape):
    """The wgmma K6 in bf16 where H or W is not a multiple of the 8 x 16
    tile, at N = 1 and N = 3 (the 2-block cluster over frames then has a
    block past the last frame, which loads zeros and stores nothing), and at
    C = 64, 128, 256 and 384 (128-wide passes; 64-wide at C = 64).
    Tolerance 2^-7 of the max |y|, as chip_smoke.py holds K6."""
    c = shape[3]
    w1, w2 = (k6.kernel_weight(0.05 * torch.randn(c, c, 3, 3, device="cuda", generator=card),
                               torch.bfloat16) for _ in range(2))
    b1, b2 = (0.1 * torch.randn(c, device="cuda", generator=card) for _ in range(2))
    x = torch.randn(shape, device="cuda", generator=card).to(torch.bfloat16)
    kernels.reset_launch_counts()
    got = k6.fused_rcu(x, w1, b1, w2, b2)
    ref = k6.fused_rcu_plain(x, w1, b1, w2, b2)
    assert kernels.launch_counts() == counts(fused_rcu=1)
    assert _bf16_err_ok(got, ref, 2 ** -7 * ref.float().abs().max().item())


def k7_arithmetic(x, w1, b1, w2, b2, out_hw, frames=8):
    """K7's function at its own rounding points in plain PyTorch: the
    upsample through ``interp_table`` (two taps, fp32 sum, bf16; rows, then
    columns), the 3x3 conv in fp32 (TF32 off) with b1 added before the bf16
    rounding, the fp32 1x1. ``frames`` at a time, to bound the fp32 maps."""
    import torch.nn.functional as F

    (h, w), (oh, ow) = x.shape[1:3], out_hw
    rt, ct = (torch.from_numpy(np.array(k7.interp_table(i, o))).to(x.device)
              for i, o in ((h, oh), (w, ow)))
    rlo, clo = rt[:, 0].view(torch.int32).long(), ct[:, 0].view(torch.int32).long()
    outs = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for xs in x.split(frames):
            xf = xs.float()
            r = rt[:, 1, None, None] * xf[:, rlo] + rt[:, 2, None, None] * xf[:, rlo + 1]
            r = r.to(torch.bfloat16).float()
            u = ct[:, 1, None] * r[:, :, clo] + ct[:, 2, None] * r[:, :, clo + 1]
            u = u.to(torch.bfloat16).float().permute(0, 3, 1, 2)
            a = F.conv2d(u, w1.to(torch.bfloat16).float(), b1.float(), padding=1)
            a = torch.relu(a).to(torch.bfloat16).float().permute(0, 2, 3, 1)
            outs.append(torch.relu(a @ w2.float().reshape(-1, 1) + b2.float()))
    return torch.cat(outs)


def k7_operands(c, gen, device="cuda"):
    """output_conv2's weights at the init's scale (3x3 C -> 32, 1x1 32 -> 1),
    in bf16."""
    w1 = torch.randn(32, c, 3, 3, device=device, generator=gen) * (9 * c) ** -0.5
    b1 = 0.1 * torch.randn(32, device=device, generator=gen)
    w2 = torch.randn(1, 32, 1, 1, device=device, generator=gen) * 32 ** -0.5
    b2 = 0.1 * torch.randn(1, device=device, generator=gen)
    return tuple(t.to(torch.bfloat16) for t in (w1, b1, w2, b2))


K7_CASES = {   # C, N, (h, w): output (14 h / 8, 14 w / 8) for the model's maps, else 2x
    "2x3": (64, 1, (2, 3)),                 # the least map: one tile, mostly outside
    "ragged": (128, 3, (40, 56)),           # 70 x 98: neither a multiple of a tile
    "c48": (48, 2, (40, 56)),               # 16-channel chunks
    "c192": (192, 2, (72, 40)),             # vitg's width: 4-row tiles
    "vitl-518x924": (128, 32, (296, 528)), "vits-518x924": (32, 128, (296, 528)),
    "vitl-518": (128, 32, (296, 296)), "vits-518": (32, 128, (296, 296)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_matches_plain_version(card, case):
    """K7 against its plain version (the PyTorch chain it replaces, which
    rounds the conv before its bias) within 2e-2 of max |y|, and against
    its own arithmetic (``k7_arithmetic``: the bias first) within 4e-3 of
    max |y|, the bf16 kernels' tolerance: the conv's fp32 sums in another
    order flip a rounding of relu(conv + b1) to bf16 here and there. The two
    roundings differ by 0.35-0.7 % of max |y| at the model's weights on the
    CPU (tests/test_torch_head_tail.py). One launch per call."""
    c, n, in_hw = K7_CASES[case]
    torch.backends.cudnn.allow_tf32 = False
    out_hw = tuple(14 * (s // 8) if s % 8 == 0 else 2 * s for s in in_hw)
    x = torch.randn(n, *in_hw, c, device="cuda", generator=card).to(torch.bfloat16)
    ops = k7_operands(c, card)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = k7.head_output_tail(x, *ops, out_hw)
        assert kernels.launch_counts() == counts(head_output_tail=1)
        plain = k7.head_output_tail_plain(x, *ops, out_hw)
    exact = k7_arithmetic(x, *ops, out_hw)
    assert got.shape == (n, *out_hw, 1) and got.dtype == torch.float32
    top = exact.abs().max().item()
    err_plain = (got - plain).abs().max().item() / top
    err_exact = (got - exact).abs().max().item() / top
    print(f"K7 {case} C {c} N {n} {in_hw} -> {out_hw}: max err / max |y| {err_exact:.2e} "
          f"(own arithmetic, tol 4e-3), {err_plain:.2e} (plain version, tol 2e-2)")
    assert err_exact <= 4e-3 and err_plain <= 2e-2


@pytest.mark.cuda
def test_k7_runs_on_the_cards_mixed_island_only(card):
    """The head's dispatch: a bf16 forward launches K7 once per head call,
    on a map laid out as the pipeline's (not contiguous); ``train``, fp32 and
    a C the kernel does not take launch none; the bf16 head within 2e-2 of
    max |y| of its stages run one by one."""
    from video_depth_anything_torch.models.dpt import Scratch

    sc = Scratch([32] * 4, 64).to("cuda", torch.bfloat16).eval()
    path_1 = torch.randn(2, 24, 16, 64, device="cuda", generator=card).to(torch.bfloat16)
    path_1 = path_1.transpose(1, 2)   # as the resize before it leaves it: H and W swapped
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = sc.output_head(path_1, (28, 42))
        assert kernels.launch_counts() == counts(head_output_tail=1)
        ref = sc.head_conv2b(sc.head_conv2a(sc.head_resize(sc.head_conv1(path_1), (28, 42)),
                                            False), False)
        sc.output_head(path_1, (28, 42), train=True)
        copy.deepcopy(sc).float().output_head(path_1.float(), (28, 42))
        odd = Scratch([40] * 4, 40).to("cuda", torch.bfloat16)
        odd.output_head(torch.randn(1, 8, 8, 40, device="cuda").to(torch.bfloat16), (14, 14))
    assert kernels.launch_counts() == counts(head_output_tail=1)
    assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_k7_library_holds_wgmma_and_tma(card):
    """K7's SASS: bf16 wgmma (HGMMA) and TMA loads (UTMALDG), no mma.sync."""
    from video_depth_anything_torch.kernels import build

    sass = build.sass_counts("head_output_tail")
    print(f"K7 SASS: {sass}")
    assert sass["HGMMA"] > 0 and sass["UTMALDG"] > 0 and sass["HMMA"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 65, 129, 1370])
def test_attention_body_sequence_edges_match_plain_versions(card, s):
    """The wgmma attention body (K1, K4, K5) in bf16 at sequence lengths
    around its 128-row query and key tiles: K1 on the strided column views
    of a fused qkv with an odd head count, K5 on the fused array, K4 on
    split-head views at head dims below their tile (8 of 16, 40 of 64, 72
    of 128) and head-major at 32. Tolerance 2e-2 (this file's bf16 bound)
    up to 129 keys, 4e-3 at 1370 keys where the outputs are ten times
    smaller (chip_smoke.py's bound there)."""
    tol = 4e-3 if s > 1000 else 2e-2
    kernels.reset_launch_counts()
    qkv = torch.randn(2, s, 3 * 192, device="cuda", generator=card).to(torch.bfloat16)
    q, k, v = qkv[..., :192], qkv[..., 192:384], qkv[..., 384:]
    assert _bf16_err_ok(k1.spatial_attention(q, k, v, num_heads=3, scale=0.125),
                        k1.spatial_attention_plain(q, k, v, num_heads=3, scale=0.125), tol)
    qkv[..., :192] *= 0.125   # K5 takes q pre-scaled
    assert _bf16_err_ok(k5.spatial_attention_qkv_fused(qkv, num_heads=3),
                        k5.spatial_attention_qkv_fused_plain(qkv, num_heads=3), tol)
    for h, d in ((5, 8), (3, 40), (3, 72)):
        qkv = torch.randn(2, s, 3 * h * d, device="cuda", generator=card).to(torch.bfloat16)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)).transpose(1, 2)
                   for i in range(3))
        out = torch.empty(2, s, h * d, device="cuda", dtype=torch.bfloat16)
        got = k4.attention_head_major(q, k, v, scale=d ** -0.5,
                                      out=out.unflatten(-1, (h, d)).transpose(1, 2))
        assert _bf16_err_ok(got, k4.attention_head_major_plain(q, k, v, scale=d ** -0.5), tol)
    q, k, v = (torch.randn(1, 5, s, 32, device="cuda", generator=card).to(torch.bfloat16)
               for _ in range(3))
    assert _bf16_err_ok(k4.attention_head_major(q, k, v, scale=32 ** -0.5),
                        k4.attention_head_major_plain(q, k, v, scale=32 ** -0.5), tol)
    assert kernels.launch_counts() == counts(spatial_attention=1, spatial_attention_qkv_fused=1,
                                             attention_head_major=4)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 1370, 1814])
def test_k3_sequence_edges_match_plain_version(card, s):
    """K3 at sequence lengths around its 128-row query and key tiles (bf16 v:
    the wgmma body's int8-QK instance; fp32 v: the mma.sync body), v a
    column view of a fused qkv, an even head count (the packed path).
    Tolerance: fp32 1e-4; bf16 2e-2 up to 129 keys, 4e-3 at 1370 and more,
    where the outputs are ten times smaller (chip_smoke.py's bound there)."""
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    kernels.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32):
        tol = 1e-4 if dt == torch.float32 else (4e-3 if s > 1000 else 2e-2)
        q8, k8 = (torch.randint(-127, 128, (2, s, 384), device="cuda", generator=card,
                                dtype=torch.int8) for _ in range(2))
        v = torch.randn(2, s, 3 * 384, device="cuda", generator=card).to(dt)[..., 768:]
        got = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=6)
        ref = k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=6)
        assert _bf16_err_ok(got, ref, tol)
    assert kernels.launch_counts() == counts(spatial_attention_qk8=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_k3_reads_scales_from_the_device(card, dt):
    """The score scale is read on the card at each launch: scales changed
    in place between two launches, with no synchronisation between them,
    change the second output (to the plain version's at the new scales)
    and not the first."""
    q8, k8 = (torch.randint(-127, 128, (2, 300, 256), device="cuda", generator=card,
                            dtype=torch.int8) for _ in range(2))
    v = torch.randn(2, 300, 256, device="cuda", generator=card).to(dt)
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    first = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=4)
    scales.mul_(3.0)
    second = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=4)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    want_second = k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=4)
    want_first = k3.spatial_attention_qk8_plain(q8, k8, v, scales / 3.0, num_heads=4)
    assert _bf16_err_ok(first, want_first, tol) and _bf16_err_ok(second, want_second, tol)
    assert (first.float() - second.float()).abs().max().item() > 10 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [4, 8, 24, 48, 128, 192])
@pytest.mark.parametrize("t", [1, 4, 7, 31, 32])
def test_k2_frames_and_head_dims_match_plain_version(card, t, dh):
    """K2 in bf16 (the tensor-core kernel; dh 4 through the wrapper's zero
    channels) and fp32 at T from 1 to 32 and head dims from 4 to 192, at
    37 pixels, a count that no tile of pixels divides. Tolerance: fp32
    1e-4, bf16 2e-2 (this file's bound)."""
    kernels.reset_launch_counts()
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = (torch.randn(37, t, 8 * dh, device="cuda", generator=card).to(dt)
                   for _ in range(3))
        got = k2.temporal_attention(q, k, v, num_heads=8, scale=dh ** -0.5)
        ref = k2.temporal_attention_plain(q, k, v, num_heads=8, scale=dh ** -0.5)
        assert got.shape == q.shape and _bf16_err_ok(got, ref, tol)
    assert kernels.launch_counts() == counts(temporal_attention=2)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 65, 129, 1370])
def test_attention_switches_match_plain_versions(card, s):
    """The body's option instances: K1 with mxu_denom, exp2 and both, K5
    with mxu_denom, K4 with mxu_denom at head dims below their tile (8 of
    16, 40 of 64, 72 of 128) and at 32, each against its plain version
    with the same switches, at the sequence edges of the default
    instances' test; bf16 at its tolerances there, fp32 at 1e-4."""
    kernels.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32):
        tol = 1e-4 if dt == torch.float32 else (4e-3 if s > 1000 else 2e-2)
        qkv = torch.randn(2, s, 3 * 192, device="cuda", generator=card).to(dt)
        q, k, v = qkv[..., :192], qkv[..., 192:384], qkv[..., 384:]
        for mxu_denom, exp2 in ((True, False), (False, True), (True, True)):
            got = k1.spatial_attention(q, k, v, num_heads=3, scale=0.125, mxu_denom=mxu_denom,
                                       exp2=exp2)
            ref = k1.spatial_attention_plain(q, k, v, num_heads=3, scale=0.125,
                                             mxu_denom=mxu_denom, exp2=exp2)
            assert _bf16_err_ok(got, ref, tol), (dt, mxu_denom, exp2)
        qkv[..., :192] *= 0.125
        assert _bf16_err_ok(k5.spatial_attention_qkv_fused(qkv, num_heads=3, mxu_denom=True),
                            k5.spatial_attention_qkv_fused_plain(qkv, num_heads=3,
                                                                 mxu_denom=True), tol)
        for h, d in ((5, 8), (3, 40), (3, 72), (5, 32)):
            q, k, v = (torch.randn(2, h, s, d, device="cuda", generator=card).to(dt)
                       for _ in range(3))
            assert _bf16_err_ok(k4.attention_head_major(q, k, v, scale=d ** -0.5, mxu_denom=True),
                                k4.attention_head_major_plain(q, k, v, scale=d ** -0.5,
                                                              mxu_denom=True), tol), (dt, d)
    assert kernels.launch_counts() == counts(spatial_attention=6, spatial_attention_qkv_fused=2,
                                             attention_head_major=8)
    x = torch.zeros(2, 10, 64, device="cuda")
    with pytest.raises(ValueError, match="exp2"):    # dh 32 goes to K4, which has no exp2
        k1.spatial_attention(x, x, x, num_heads=2, scale=0.125, exp2=True)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [130, 200, 1370])
def test_t2_stagger_is_k1_with_mxu_denom_bit_for_bit(card, s):
    """T2's stagger schedule is the body's instance K1 runs with
    mxu_denom=True; q pre-scaled by 1/8 and the scores scaled by 1/8 differ
    by a power of two only, so the outputs agree bit for bit."""
    q, k, v = (0.3 * torch.randn(2, s, 256, device="cuda", generator=card)
               for _ in range(3))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = t2.attention_variant(q, k, v, num_heads=4, schedule="stagger")
    want = k1.spatial_attention(q, k, v, num_heads=4, scale=0.125, mxu_denom=True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_t1_sink_changes_no_output(card):
    """The wgmma QK probes keep accumulating every key tile behind the sink
    pointer; passing it changes no output, and qk64x2 at the tools' row and
    key counts (1408, 11 key tiles) matches its plain version."""
    def uniform(*shape):
        return (torch.rand(shape, device="cuda", generator=card) - 0.5).to(torch.bfloat16)

    q, k = uniform(2, 1408, 128), uniform(2, 1408, 128)
    kernels.reset_launch_counts()
    for name, heads in (("qk64x2", 2), ("qk128", 1)):
        plain = qp.phase_probe(name, q, k)
        assert torch.equal(qp.phase_probe(name, q, k, sink=True), plain)
        ref = qp.qk_first128_plain(q, k, heads=heads)
        assert (plain.float() - ref.float()).abs().max() <= 2 ** -7 * ref.float().abs().max()
    assert kernels.launch_counts() == counts(phase_probes=4)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,m,n", [(1, 64, 128), (1, 192, 128), (3, 192, 640),
                                       (133, 128, 256)])
def test_t3_persistent_walk_matches_plain_version(card, steps, m, n):
    """T3's persistent grid at the edges of its walk: one half tile and a
    full plus a half tile (fewer tiles than SMs; rows past M loaded as
    zeros, not stored), 6 tiles against 5 key tiles each, and 133 tiles
    (one block takes two on a 132-SM card). Both probes, bf16 in, fp32 out,
    within 1e-4 of the max |o| (the fp32 sums run in another order)."""
    q = (torch.rand(steps, m, 128, device="cuda", generator=card) - 0.5).to(torch.bfloat16)
    k = (torch.rand(steps, n, 128, device="cuda", generator=card) - 0.5).to(torch.bfloat16)
    kernels.reset_launch_counts()
    for heads in (2, 1):
        got = qp.qk_probe(q, k, heads=heads)
        ref = qp.qk_colsum_plain(q, k, heads=heads)
        assert got.dtype == torch.float32 and got.shape == (steps, m, 128)
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert kernels.launch_counts() == counts(qk_probes=2)


def _stream(pipe, frames, **kw):
    return np.concatenate(list(pipe.infer_video_depth_streaming(iter(frames), **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4])
def test_overlapped_transfers_equal_blocking_copies(card, c, monkeypatch):
    """The long-video path's copies (pinned staging one chunk ahead on a copy
    stream, downloads read one chunk late) against blocking copies from
    pageable memory, bit for bit, over a 5-window video (a race shows up as
    wrong frames); streaming equals the batch API bit for bit; the launches
    are one encode and one head (its tail K7) per chunk."""
    cfg = get_model_config("vits")
    model = build_model(cfg, seed=0, device="cuda")
    frames = synthetic_video(n=100, hw=(140, 196), seed=7)
    kw = dict(input_size=112, windows_per_batch=c)
    monkeypatch.setattr(infer, "HostLink", functools.partial(infer.HostLink, overlap=False))
    ref, _ = VideoDepthPipeline(cfg, model).infer_video_depth(frames, **kw)
    monkeypatch.undo()
    pipe = VideoDepthPipeline(cfg, model)
    kernels.reset_launch_counts()
    got, _ = pipe.infer_video_depth(frames, **kw)
    steps = 5 if c == 1 else 2
    assert kernels.launch_counts() == counts(spatial_attention=12 * steps,
                                             temporal_attention=8 * steps,
                                             head_output_tail=steps)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(_stream(pipe, frames, **kw), got)
    hp = VideoDepthPipeline(cfg, model, transfer_fp16=True)
    h16, _ = hp.infer_video_depth(frames, **kw)
    assert np.abs(h16 - got).max() <= 2.0 ** -10 * np.abs(got).max()
    np.testing.assert_array_equal(_stream(hp, frames, **kw), h16)


@pytest.mark.cuda
def test_fully_resident_last_chunk_on_the_card(card):
    """n = 49 at C = 2: the last chunk's frames are all resident, so it runs
    the head alone (K1 would take no empty batch); stream equals batch."""
    cfg = get_model_config("vits")
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"))
    frames = synthetic_video(n=49, hw=(140, 196), seed=8)
    kernels.reset_launch_counts()
    got, _ = pipe.infer_video_depth(frames, input_size=112, windows_per_batch=2)
    assert kernels.launch_counts() == counts(spatial_attention=12, temporal_attention=16,
                                             head_output_tail=2)
    assert got.shape == frames.shape[:3] and np.isfinite(got).all()
    np.testing.assert_array_equal(
        _stream(pipe, frames, input_size=112, windows_per_batch=2), got)


@pytest.mark.cuda
def test_vitl_four_windows_per_batch_at_518(card):
    """vitl, C = 4 at 518 x 518 (the head on [4, 32]): its peak device memory
    is printed; within the bf16 drift budget of the sequential cache."""
    from video_depth_anything_torch.utils.precision import (MAX_ERR_FRAC, MEAN_ERR_FRAC,
                                                            precision_drift_report)

    cfg = get_model_config("vitl")
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"))
    frames = synthetic_video(n=100, hw=(518, 518), seed=9)
    seq, _ = pipe.infer_video_depth(frames)
    torch.cuda.reset_peak_memory_stats()
    got, _ = pipe.infer_video_depth(frames, windows_per_batch=4)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"vitl 518x518, 100 frames, windows_per_batch=4: peak {peak:.2f} GiB")
    rep = precision_drift_report(got, seq)
    assert rep["max_err_frac"] < MAX_ERR_FRAC and rep["mean_err_frac"] < MEAN_ERR_FRAC, rep


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1370, 1371])
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 4e-3)])
def test_k1_and_k3_at_vitg_width(card, s, dt, tol):
    """K1 on the column views of vitg's fused [32, S, 4608] qkv (24 heads of
    64: a row stride the TMA maps had not seen), and K3 at 24 heads, against
    their plain versions. At S 1370 (37^2 patches + cls) the outputs are
    averages over 1370 keys, about ten times smaller than at this file's
    short sequences: bf16 is held to chip_smoke.py's 4e-3."""
    b, h = 32, 24
    c = h * 64
    qkv = torch.randn(b, s, 3 * c, device="cuda", generator=card).to(dt)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    kernels.reset_launch_counts()
    got = k1.spatial_attention(q, k, v, num_heads=h, scale=0.125)
    ref = k1.spatial_attention_plain(q, k, v, num_heads=h, scale=0.125)
    assert _bf16_err_ok(got, ref, tol)
    del got, ref
    scales = torch.tensor([1.6 / 127 / 8, 1.6 / 127], device="cuda")
    q8, k8 = (torch.randint(-127, 128, (b, s, c), device="cuda", generator=card,
                            dtype=torch.int8) for _ in range(2))
    got = k3.spatial_attention_qk8(q8, k8, v, scales, num_heads=h)
    ref = k3.spatial_attention_qk8_plain(q8, k8, v, scales, num_heads=h)
    assert _bf16_err_ok(got, ref, tol)
    assert kernels.launch_counts() == counts(spatial_attention=1, spatial_attention_qk8=1)


@pytest.mark.cuda
@pytest.mark.parametrize("p,c", [(37 * 37, 1536), (19 * 19, 1536), (37 * 37, 384), (74 * 74, 384)])
def test_k2_at_vitg_motion_module_shapes(card, p, c):
    """K2 at vitg's four motion modules at 518^2 (dh 192 and 48), T 32,
    bf16 (2e-2) and fp32 (1e-4)."""
    kernels.reset_launch_counts()
    dh = c // 8
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = (torch.randn(p, 32, c, device="cuda", generator=card).to(dt) for _ in range(3))
        got = k2.temporal_attention(q, k, v, num_heads=8, scale=dh ** -0.5)
        ref = k2.temporal_attention_plain(q, k, v, num_heads=8, scale=dh ** -0.5)
        assert _bf16_err_ok(got, ref, tol)
    assert kernels.launch_counts() == counts(temporal_attention=2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 148, 148, 384), (32, 74, 74, 384), (32, 37, 37, 384),
                                   (32, 19, 19, 384)])
def test_k6_at_vitg_width(card, shape):
    """K6 at C 384, the kernel's widest (its shared memory at its largest),
    on vitg's four RefineNet shapes in bf16, 2^-7 of max |y|."""
    c = shape[3]
    w1, w2 = (k6.kernel_weight(0.04 * torch.randn(c, c, 3, 3, device="cuda", generator=card),
                               torch.bfloat16) for _ in range(2))
    b1, b2 = (0.1 * torch.randn(c, device="cuda", generator=card) for _ in range(2))
    x = torch.randn(shape, device="cuda", generator=card).to(torch.bfloat16)
    kernels.reset_launch_counts()
    got = k6.fused_rcu(x, w1, b1, w2, b2)
    ref = k6.fused_rcu_plain(x, w1, b1, w2, b2)
    assert kernels.launch_counts() == counts(fused_rcu=1)
    assert _bf16_err_ok(got, ref, 2 ** -7 * ref.float().abs().max().item())


@pytest.mark.cuda
def test_vitg_window_peak_memory(card):
    """One vitg window (22 frames at 518 x 518, one window of 32 rows, bf16)
    through the pipeline: 40 K1 and 40 K8 launches (one encode), 8 K2, one K7; finite depths;
    its peak device memory, with the fp32 weights (5.1 GiB with the head)
    and their bf16 copy resident, is printed."""
    cfg = get_model_config("vitg")
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0, device="cuda"))
    frames = synthetic_video(n=22, hw=(518, 518), seed=12)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got, _ = pipe.infer_video_depth(frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"vitg 518x518, one window, bf16: peak {peak:.2f} GiB")
    assert kernels.launch_counts() == counts(spatial_attention=40, temporal_attention=8,
                                             head_output_tail=1, swiglu=40)
    assert got.shape == (22, 518, 518) and np.isfinite(got).all()
    assert peak < 40


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 2443, 8192), (1, 8192), (7, 8192), (2443, 8192)])
def test_k8_is_silu_times_x2_bit_for_bit(card, shape):
    """K8 against ``F.silu(x1) * x2`` on the chunk views, bit for bit, at
    vitg's hidden 4096: a window's w12 output at 518 x 924 (32 frames of
    2443 tokens) and ragged row counts (1, 7, 2443 rows: under and past the
    kernel's 1024-vector tile). Inputs of 4 sigma reach silu's saturated
    tails; row 0 also holds zeros, +-inf's neighbours and subnormals."""
    y = (4 * torch.randn(shape, device="cuda", generator=card)).to(torch.bfloat16)
    edge = torch.tensor([0.0, -0.0, 3e38, -3e38, 1e-39, -1e-39, 88.0, -88.0, 100.0, -100.0],
                        device="cuda").to(torch.bfloat16)
    y.view(-1, shape[-1])[0, :edge.numel()] = edge
    y.view(-1, shape[-1])[0, 4096:4096 + edge.numel()] = edge.flip(0)
    kernels.reset_launch_counts()
    got = k8.swiglu(y)
    x1, x2 = y.chunk(2, dim=-1)
    assert kernels.launch_counts() == counts(swiglu=1)
    assert _bits_equal(got, F.silu(x1) * x2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2443, 9])
def test_k8_on_an_int8_w12_output_bit_for_bit(card, rows):
    """The same on the bf16 output of an int8 w12 (``QLinear``, vitg's
    1536 -> 2 x 4096), as the int8 encoder hands it to the gate (two frames:
    the int8 product takes M > 16)."""
    lin = torch.nn.Linear(1536, 8192, device="cuda").to(torch.bfloat16)
    x = torch.randn(2, rows, 1536, device="cuda", generator=card).to(torch.bfloat16)
    w12 = quant.QLinear.from_linear(lin, quant.amax(x))
    with torch.no_grad():
        y = quant.linear_maybe_q(w12, x)
    assert y.dtype == torch.bfloat16 and y.is_contiguous()
    kernels.reset_launch_counts()
    got = k8.swiglu(y)
    x1, x2 = y.chunk(2, dim=-1)
    assert kernels.launch_counts() == counts(swiglu=1)
    assert _bits_equal(got, F.silu(x1) * x2)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_swiglu_ffn_runs_k8_on_the_bf16_path(card, int8, monkeypatch):
    """vitg's FFN at its widths on the card: bf16 (float or int8 w12 and w3)
    runs K8 once a call, the calibration forward (``stats``) included, its
    output bit for bit the FFN's with PyTorch's gate, and
    ``vda.encoder.swiglu`` counts it fused; fp32 launches nothing."""
    ffn = SwiGLUFFNFused(1536, 4096).to("cuda")
    x = torch.randn(2, 300, 1536, device="cuda", generator=card)
    with torch.no_grad():
        kernels.reset_launch_counts()
        ffn16 = copy.deepcopy(ffn).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16)
        ffn(x)
        ffn(x, stats={})
        assert kernels.launch_counts() == counts()
        ffn16(x16, stats={})
        assert kernels.launch_counts() == counts(swiglu=1)
        kernels.reset_launch_counts()
        if int8:
            ffn16.w12 = quant.QLinear.from_linear(ffn16.w12, quant.amax(x16))
            ffn16.w3 = quant.QLinear.from_linear(ffn16.w3, torch.tensor(4.0))
        profiling.reset()
        with profiling.collecting():
            got = ffn16(x16)
        assert kernels.launch_counts() == counts(swiglu=1)
        row = profiling.totals()["vda.encoder.swiglu"]
        assert row["count"] == 1 and row["counters"]["fused"] == 1
        monkeypatch.setattr(SwiGLUFFNFused, "fused", staticmethod(lambda y: False))
        want = ffn16(x16)
    assert kernels.launch_counts() == counts(swiglu=1)
    assert _bits_equal(got, want)


# ---------------------------------------------------------------- training


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k2_under_grad_matches_plain_autograd(card, dt, tol):
    """The autograd Function: K2 forward (one launch), the backward kernel
    (one launch); dq / dk / dv within ``tol`` of each gradient's max."""
    x = [torch.randn(300, 20, 64, device="cuda", generator=card).to(dt) for _ in range(4)]
    a = [t.clone().requires_grad_() for t in x[:3]]
    b = [t.clone().requires_grad_() for t in x[:3]]
    kernels.reset_launch_counts()
    o = k2.temporal_attention(*a, num_heads=8, scale=8 ** -0.5)
    assert kernels.launch_counts() == counts(temporal_attention=1)
    ref = k2.temporal_attention_plain(*b, num_heads=8, scale=8 ** -0.5)
    o.backward(x[3])
    ref.backward(x[3])
    assert (o.detach().float() - ref.detach().float()).abs().max().item() <= tol
    for u, w in zip(a, b):
        err = (u.grad.float() - w.grad.float()).abs().max().item()
        assert err <= tol * w.grad.float().abs().max().item()
    assert kernels.launch_counts() == counts(temporal_attention=1, temporal_attention_backward=1)


# (P, T, C, heads): vits' four motion modules at the train step's T = 20,
# vitl's dh 128 and dh 32 at T = 32, T = 1 and 7, 4 local heads of a (1, 2)
# mesh, and a head dim the bf16 wrapper pads (12 -> 16). Then the bf16
# kernel's tiling at its edges: P that leaves a partial last tile (3 units
# of 8 heads a tile at T 7; 2 of 4 at T 20), P = 1; dh 512 (one unit a
# tile, a ring of one at T 32, of two at T 16); frame columns in 2, 3 and
# 4 blocks of 8 at T 12, 17, 24 and 25; q, k, v, do as views 2 or 4
# bytes off 16-byte alignment ("view"), which the wrapper copies; and dh 8
# and 24 (the instances whose width is a compile-time constant) at 2 and 4
# frame blocks, T 12 and 32.
K2_BACKWARD_SHAPES = [(37 * 37, 20, 192, 8), (19 * 19, 20, 384, 8), (37 * 37, 20, 64, 8),
                      (74 * 74, 20, 64, 8), (37 * 37, 32, 1024, 8), (37 * 37, 32, 256, 8),
                      (300, 1, 192, 8), (300, 7, 384, 8), (37 * 37, 20, 96, 4),
                      (300, 20, 96, 8),
                      (1001, 7, 64, 8), (1001, 20, 32, 4), (1, 20, 192, 8), (40, 32, 4096, 8),
                      (40, 16, 4096, 8), (500, 12, 128, 8), (300, 17, 192, 8),
                      (300, 24, 64, 8), (300, 25, 256, 8), (300, 20, 192, 8, "view"),
                      (300, 12, 64, 8), (300, 32, 64, 8), (300, 12, 192, 8), (300, 32, 192, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_BACKWARD_SHAPES)
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k2_backward_kernel_matches_plain_version(card, shape, dt, tol):
    """The backward kernel's dq / dk / dv against the plain version's
    (the plain forward's gradient under autograd), within ``tol`` of each
    gradient's max |g|; one launch per call."""
    p, t, c, h, *view = shape
    off = 1 if view else 0   # one element past the allocation's 16-byte alignment
    q, k, v, do = (torch.randn(p * t * c + off, device="cuda", generator=card).to(dt)[off:]
                   .view(p, t, c) for _ in range(4))
    if view:
        assert all(x.data_ptr() % 16 for x in (q, k, v, do))
    scale = (c // h) ** -0.5
    kernels.reset_launch_counts()
    got = k2.temporal_attention_backward(q, k, v, do, num_heads=h, scale=scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == counts(temporal_attention_backward=1)
    ref = k2.temporal_attention_backward_plain(q, k, v, do, num_heads=h, scale=scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype and bool(torch.isfinite(g).all())
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), (shape, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(74 * 74, 20, 64, 8), (37 * 37, 7, 192, 8)])
@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k2_backward_kernel_keeps_a_non_finite_pixel_to_itself(card, shape, which, dt, tol):
    """An Inf in one pixel's q, k, v or do leaves every other pixel's dq /
    dk / dv finite and equal to the plain version's, within ``tol`` of
    each gradient's max |g|: the blocks walk many tiles through the same
    staging slots (P well past the grid), and a pixel's non-finite values
    must not reach the slots' padded frame rows that later pixels sum
    over."""
    p, t, c, h = shape
    x = [torch.randn(p, t, c, device="cuda", generator=card).to(dt) for _ in range(4)]
    x["qkvd".index(which[0])][0, t // 2, 5] = float("inf")
    scale = (c // h) ** -0.5
    got = k2.temporal_attention_backward(*x, num_heads=h, scale=scale)
    ref = k2.temporal_attention_backward_plain(*x, num_heads=h, scale=scale)
    for g, r in zip(got, ref):
        g, r = g[1:].float(), r[1:].float()
        assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(r).all())
        err = (g - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), (which, err)


@pytest.mark.cuda
def test_k2_backward_has_no_hidden_plain_path(card, monkeypatch):
    """With the plain version made to raise, a backward on CUDA tensors
    still runs: it launches the kernels and nothing else."""
    x = [torch.randn(300, 20, 192, device="cuda", generator=card).bfloat16() for _ in range(4)]
    a = [t.clone().requires_grad_() for t in x[:3]]

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(k2, "temporal_attention_plain", refuse)
    kernels.reset_launch_counts()
    k2.temporal_attention(*a, num_heads=8, scale=24 ** -0.5).backward(x[3])
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(u.grad).all()) for u in a)
    assert kernels.launch_counts() == counts(temporal_attention=1, temporal_attention_backward=1)


@pytest.mark.cuda
def test_forward_only_kernels_refuse_grad(card):
    dt = torch.bfloat16
    qkv = torch.randn(2, 77, 3 * 384, device="cuda", generator=card).to(dt).requires_grad_()
    q, k, v = qkv.split(384, dim=-1)
    q8 = torch.randint(-127, 128, (2, 77, 384), device="cuda", generator=card, dtype=torch.int8)
    scales = torch.tensor([0.002, 0.01], device="cuda")
    x = torch.randn(1, 8, 8, 256, device="cuda", generator=card).to(dt).requires_grad_()
    w = k6.kernel_weight(torch.randn(256, 256, 3, 3, device="cuda", generator=card) * 0.02, dt)
    b = torch.zeros(256, device="cuda")
    calls = [lambda: k1.spatial_attention(q, k, v, num_heads=6, scale=0.125),
             lambda: k1.launch(q, k, v, num_heads=6, scale=0.125),
             lambda: k3.spatial_attention_qk8(q8, q8, v, scales, num_heads=6),
             lambda: k4.attention_head_major(*(t.unflatten(-1, (6, 64)).transpose(1, 2)
                                               for t in (q, k, v)), scale=0.125),
             lambda: k5.spatial_attention_qkv_fused(qkv, num_heads=6),
             lambda: k6.fused_rcu(x, w, b, w, b),
             lambda: k7.head_output_tail(x[..., :64].contiguous(), *k7_operands(64, card),
                                         (14, 14))]
    kernels.reset_launch_counts()
    for call in calls:
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    assert kernels.launch_counts() == counts()
    with torch.no_grad():   # the same calls without a gradient launch
        k1.spatial_attention(q, k, v, num_heads=6, scale=0.125)
    assert kernels.launch_counts() == counts(spatial_attention=1)


@pytest.mark.cuda
def test_fp32_train_step_card_vs_cpu(card):
    """vits at full width and depth, 20 frames at 112^2, fp32 (TF32 off),
    tools/bench_train_step.py's weights and clip, the CPU taking the card's
    side at every kink (utils/kinks.py; chip_smoke.py's KINK_X): the loss
    within 1e-4, every head gradient within 1e-3 of its leaf's max, and
    none zero but refinenet4's unused first unit (zero in JAX too). The
    output bias's gradient is 0 in exact arithmetic while no output is
    clipped (the losses do not see a shift): it is held to 0, within 1e-3
    of the largest head gradient on both sides (chip_smoke.py's SHIFT_FREE)."""
    from video_depth_anything_torch.tools.bench_train_step import (synthetic_batch,
                                                                   synthetic_model)
    from video_depth_anything_torch.training import train_state as ts
    from video_depth_anything_torch.utils import kinks

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = get_model_config("vits", num_frames=20)
        tc = ts.TrainConfig(compute_dtype="float32")
        model = synthetic_model(cfg, 0)
        gpu = ts.create_train_state(copy.deepcopy(model).to("cuda"), tc)
        cpu = ts.create_train_state(model, tc)
        batch = synthetic_batch(1, 20, 112, "cpu", seed=3)
        kernels.reset_launch_counts()
        sides, flips = [], []
        with kinks.record(sides):
            gpu, gm = ts.train_step(gpu, {k: v.cuda() for k, v in batch.items()}, cfg, tc)
        assert kernels.launch_counts() == counts(spatial_attention=12, temporal_attention=8,
                                                 temporal_attention_backward=8)
        with kinks.replay(sides, flips):
            cpu, cm = ts.train_step(cpu, batch, cfg, tc)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert abs(float(gm["loss"]) - float(cm["loss"])) <= 1e-4 * abs(float(cm["loss"]))
    assert max(x for _, x in flips) <= 1e-4
    gmax = max(t.grad.abs().max().item() for t in cpu.head.values())
    for name, t in gpu.head.items():
        g, r = t.grad.cpu(), cpu.head[name].grad
        if name == "scratch.output_conv2.2.bias":
            assert max(g.abs().max().item(), r.abs().max().item()) <= 1e-3 * gmax
            continue
        err = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-3 * gmax)
        assert err <= 1e-3, (name, err)
        unused = name.startswith("scratch.refinenet4.resConfUnit1.")
        assert (g.abs().max().item() == 0) == unused, name


@pytest.mark.cuda
@pytest.mark.parametrize("traced_on", ["cuda", "cpu"])
def test_serving_artifact_launches_the_kernels_and_raises_without_them(card, traced_on,
                                                                        monkeypatch, tmp_path):
    """A toy window program exported on the card (or on the CPU and moved
    there) equals the live program bit for bit with the same launches per
    call; with its kernel library unavailable it raises, as live does."""
    from video_depth_anything_torch.config import ModelConfig
    from video_depth_anything_torch.kernels import build
    from video_depth_anything_torch.utils import serving_export as se

    cfg = ModelConfig(encoder="vits", vit_override=ViTConfig(128, depth=2, num_heads=2),
                      features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
    model = build_model(cfg, seed=0, device="cuda")
    path = se.save_exported(se.export_window_program(cfg, (42, 56), input_size=28,
                                                     device=traced_on), str(tmp_path / "a.pt2"))
    run = se.artifact_module(se.load_exported(path, device="cuda"))
    win = torch.randint(0, 256, (1, 32, 42, 56, 3), device="cuda", generator=card,
                        dtype=torch.uint8)
    net = se.geometry((42, 56), 28)
    live = infer.PlainWindows(copy.deepcopy(model).to(torch.bfloat16), net, (42, 56),
                              torch.bfloat16)
    state = se.cast_params(model.state_dict())
    with torch.no_grad():
        kernels.reset_launch_counts()
        want = live(win[0], None, 1)
        want_n = kernels.launch_counts()
        kernels.reset_launch_counts()
        got = run(state, win)
        assert kernels.launch_counts() == want_n == counts(spatial_attention=2,
                                                            temporal_attention=8,
                                                            head_output_tail=1)
        assert torch.equal(got, want)

        def missing(name):
            raise build.KernelBuildError(f"{name}: no library")

        monkeypatch.setattr(build, "library", missing)
        with pytest.raises(build.KernelBuildError):
            run(state, win)
        with pytest.raises(build.KernelBuildError):
            live(win[0], None, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "head", "temporal", "encoder"])
def test_ablation_restores_the_model_bit_for_bit(card, mode):
    """bench_ablate's stage_deltas on vits bf16 (one 1x8x112x112 window):
    its unablated forward is the model's, and after every variant the
    forward equals it again bit for bit, every stub put back; K1 and K2
    launched."""
    from video_depth_anything_torch.tools import bench_ablate

    _, model, x = bench_ablate.window("vits", frames=8, size=112)
    with torch.no_grad():
        ref = model(x)
    kernels.reset_launch_counts()
    rec = bench_ablate.stage_deltas(model, x, mode, iters=1, chain=1)
    launched = kernels.launch_counts()
    assert torch.equal(rec["forward"], ref)
    assert rec["restored"] and all(rec["restored"].values()), rec["restored"]
    assert launched["spatial_attention"] > 0 and launched["temporal_attention"] > 0
    with torch.no_grad():
        assert torch.equal(model(x), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fp32", [False, True])
def test_bench_memory_accounting(card, fp32):
    """bench_memory at vits 112^2: the allocator's requested bytes for the
    model and the window are their tensors' bytes exactly; the output is
    the [1, 32, 112, 112] fp32 depth; the peak lies above weights, frames
    and output and below the card's memory."""
    from video_depth_anything_torch.tools import bench_memory

    rec = bench_memory.measure("vits", 112, fp32)
    assert rec["weights_plus_frames_bytes"] == rec["accounted_bytes"]
    assert rec["output_bytes"] == 32 * 112 * 112 * 4 and rec["output_finite"]
    assert (rec["weights_plus_frames_bytes"] + rec["output_bytes"] < rec["peak_bytes"]
            <= rec["allocated_peak_bytes"] < rec["card_bytes"])
    assert rec["ref_a100_vram_gb"] is None and rec["metric"] == "vits_hbm_gib_112"


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2])
def test_collect_timings_reads_device_intervals_without_a_synchronise(card, c, monkeypatch):
    """collect_timings=True on the card: the same depths and launches as an
    untimed call, no torch.cuda.synchronize, window_forward one device
    interval per chunk (CUDA events, resolved once the call returns), and
    device seconds in the totals of the chunk, encoder and head spans."""
    from video_depth_anything_torch.utils import profiling

    cfg = get_model_config("vits")
    pipe = VideoDepthPipeline(cfg, build_model(cfg, seed=0))
    frames = synthetic_video(n=100, hw=(70, 98))
    kernels.reset_launch_counts()
    want, _ = pipe.infer_video_depth(frames, input_size=56, windows_per_batch=c)
    launched = kernels.launch_counts()
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: synced.append(1))
    profiling.reset()
    kernels.reset_launch_counts()
    got, _ = pipe.infer_video_depth(frames, input_size=56, windows_per_batch=c,
                                     collect_timings=True)
    assert np.array_equal(got, want) and kernels.launch_counts() == launched
    assert synced == []
    chunks = 5 if c == 1 else 3
    summary = pipe.timer.summary()
    assert summary["window_forward"]["count"] == summary["gather_upload"]["count"] == chunks
    t = profiling.totals()
    assert t["vda.pipeline.chunk"]["count"] == chunks
    assert summary["window_forward"]["total_ms"] == pytest.approx(
        1e3 * t["vda.pipeline.chunk"]["device_s"])
    for name in ("vda.pipeline.chunk", "vda.encoder", "vda.head"):
        assert t[name]["device_s"] > 0, name
    clip = t["vda.clip"]["counters"]
    assert clip["frames"] == 100 and "cuda_mallocs" in clip
    profiling.reset()
