"""The port's CUDA kernels and its pipeline on the card.

Each test needs a CUDA card and skips without one (a CUDA kernel has no
interpret mode). This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances (max abs error, unit-normal inputs): fp32 1e-4; bf16 2e-2,
which covers the bf16 rounding of the unnormalised probabilities against
a running (kernel) versus a global (plain) row max.
"""
import copy

import numpy as np
import pytest
import torch

from video_depth_anything_torch import kernels
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.kernels import spatial_attention as k1
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
    assert kernels.launch_counts() == {"spatial_attention": 1, "temporal_attention": 3}


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
    assert kernels.launch_counts() == {"spatial_attention": 24, "temporal_attention": 16}
    ref, _ = cpu.infer_video_depth(frames, input_size=56, fp32=True)
    rng = float(ref.max() - ref.min())
    assert np.abs(got - ref).max() <= 1e-3 * rng
