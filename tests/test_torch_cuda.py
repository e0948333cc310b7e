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

import numpy as np
import pytest
import torch

from video_depth_anything_torch import kernels
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.kernels import spatial_attention as k1
from video_depth_anything_torch.kernels import spatial_attention_qk8 as k3
from video_depth_anything_torch.kernels import temporal_attention as k2
from video_depth_anything_torch.models import build_model
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.utils.precision import synthetic_video


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    return torch.Generator(device="cuda").manual_seed(0)


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
    assert kernels.launch_counts() == {"spatial_attention": 1, "temporal_attention": 3,
                                       "spatial_attention_qk8": 0}


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros(2, 10, 64, device="cuda")
    with pytest.raises(ValueError, match="head dim"):   # no plain fallback on the card
        k1.spatial_attention(x, x, x, num_heads=2, scale=0.125)
    y = torch.zeros(2, 33, 64, device="cuda")
    with pytest.raises(ValueError, match="T=33"):
        k2.temporal_attention(y, y, y, num_heads=8, scale=0.125)


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
    assert kernels.launch_counts() == {"spatial_attention": 24, "temporal_attention": 16,
                                       "spatial_attention_qk8": 0}
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
    assert kernels.launch_counts() == {"spatial_attention": 12, "temporal_attention": 24,
                                       "spatial_attention_qk8": 24}
    kernels.reset_launch_counts()
    again, _ = VideoDepthPipeline(cfg, model, quant="int8", calib_path=path
                                  ).infer_video_depth(frames, input_size=112, fp32=True)
    assert kernels.launch_counts() == {"spatial_attention": 0, "temporal_attention": 16,
                                       "spatial_attention_qk8": 24}
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
