"""The reference (``vdabench/reference/``) against the program's plain CPU
path at a tiny size, float32, on the same seeded state dict: the
encoder's taps, the head, and a stitched clip of three windows."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from vdabench import infer, traffic, weights
from vdabench.reference import model as ref_model
from vdabench.reference import pipeline as ref_pipeline
from vdabench.tests import tiny

CFG = dict(tiny.CONFIG, dtype="float32")


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    sd = weights.state_dict(infer.reference_shapes(CFG), 2**31 + 17, torch.device("cpu"),
                            torch.float32)
    return (infer.program_model(CFG, sd, "cpu"), infer.reference_model(CFG, sd, "cpu"), sd)


def test_state_dict_has_the_checkpoint_keys(models):
    port, ref, sd = models
    assert set(sd) == set(port.state_dict()) == set(ref.state_dict())
    assert all(k.startswith(("pretrained.", "head.")) for k in sd)
    assert sd[weights.LAST_BIAS].min() > weights.OUTPUT_BIAS - 1


def test_encoder_and_head_agree(models):
    port, ref, _ = models
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 42, 56, 3, generator=g)
    with torch.no_grad():
        got = port.encode(x)
        want = ref.encode(x.permute(0, 3, 1, 2))
        for (gt, gc), (wt, wc) in zip(got, want):
            assert torch.allclose(gt, wt, atol=2e-5, rtol=1e-4)
            assert torch.allclose(gc, wc, atol=2e-5, rtol=1e-4)
        frames = torch.randn(1, 32, 42, 56, 3, generator=g)
        got = port(frames)
        want = ref(frames.permute(0, 1, 4, 2, 3))
    assert torch.allclose(got, want, atol=1e-4 * float(want.abs().max()))


def test_stitched_clip_agrees(models):
    from video_depth_anything_torch.pipeline.infer import VideoDepthPipeline

    port, ref, _ = models
    tr = dict(tiny.TRAFFIC)
    pool = traffic.frame_pool(tr, 4, torch.device("cpu"))
    clip = pool[:60]                      # three windows: the cache and two stitches
    pipe = VideoDepthPipeline(infer.port_config(CFG), port, device="cpu")
    got, _ = pipe.infer_video_depth(clip, input_size=tr["input_size"], fp32=True)
    want = ref_pipeline.infer_video_depth(ref, torch.from_numpy(clip), tr["input_size"]).numpy()
    assert got.shape == want.shape == (60, *tr["source_hw"])
    assert np.abs(got - want).max() <= 1e-4 * (want.max() - want.min())


def test_network_size_is_the_programs():
    from video_depth_anything_torch.pipeline import preprocess

    for hw in ((720, 1280), (1080, 1920), (480, 640), (1280, 720), (56, 98), (400, 1000)):
        eff = preprocess.effective_input_size(*hw, 518)
        assert ref_pipeline.network_size(*hw, 518) == preprocess.network_input_hw(*hw, eff)
    assert ref_pipeline.network_size(720, 1280) == (518, 924)


def test_cubic_matrix_rows_sum_to_one():
    m = ref_pipeline.cubic_matrix(720, 518)
    assert np.allclose(m.sum(1), 1.0)


def test_reference_model_keys_need_no_program():
    with torch.device("meta"):
        m = ref_model.VideoDepthAnything(CFG)
    assert any(k.endswith("pos_encoder.pe") for k in m.state_dict())
