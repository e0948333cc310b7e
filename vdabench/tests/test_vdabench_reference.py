"""The reference (``vdabench/reference/``) against the program's plain CPU
path at a tiny size, float32, on the same seeded state dict: the
encoder's taps, the head, and a stitched clip of three windows, with
each FFN kind a configuration may name (``ffn_layer``); and the vitg
encoder's module tree at its published widths on the meta device."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from vdabench import infer, traffic, weights
from vdabench.reference import model as ref_model
from vdabench.reference import pipeline as ref_pipeline
from vdabench.tests import tiny

CFG = dict(tiny.CONFIG, dtype="float32")


# vitg at its published widths: DINOv2 ViT-g/14 (dinov2_vitg14, vit_giant2,
# ffn_layer "swiglufused"), the head of Depth-Anything-V2's
# model_configs['vitg'] and Video-Depth-Anything's intermediate_layer_idx.
VITG = {"source": "the vitg encoder's published widths", "encoder": "vitg",
        "embed_dim": 1536, "depth": 40, "num_heads": 24, "mlp_ratio": 4, "patch_size": 14,
        "img_size": 518, "taps": [9, 19, 29, 39], "features": 384, "out_channels": [1536] * 4,
        "motion_heads": 8, "num_frames": 32, "dtype": "bfloat16", "ffn_layer": "swiglufused",
        "reduced": [], "assumed": {}}


@pytest.fixture(scope="module", params=["mlp", "swiglufused"])
def models(request):
    cfg = dict(CFG, ffn_layer=request.param)
    torch.manual_seed(0)
    sd = weights.state_dict(infer.reference_shapes(cfg), 2**31 + 17, torch.device("cpu"),
                            torch.float32)
    return (infer.program_model(cfg, sd, "cpu"), infer.reference_model(cfg, sd, "cpu"), sd, cfg)


def test_state_dict_has_the_checkpoint_keys(models):
    port, ref, sd, cfg = models
    assert set(sd) == set(port.state_dict()) == set(ref.state_dict())
    assert all(k.startswith(("pretrained.", "head.")) for k in sd)
    assert sd[weights.LAST_BIAS].min() > weights.OUTPUT_BIAS - 1
    ffn = {k.split(".mlp.")[1] for k in sd if ".mlp." in k}
    assert ffn == ({"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
                   if cfg["ffn_layer"] == "mlp" else
                   {"w12.weight", "w12.bias", "w3.weight", "w3.bias"})


def test_encoder_and_head_agree(models):
    port, ref, _, _ = models
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

    port, ref, _, cfg = models
    tr = dict(tiny.TRAFFIC)
    pool = traffic.frame_pool(tr, 4, torch.device("cpu"))
    clip = pool[:60]                      # three windows: the cache and two stitches
    pipe = VideoDepthPipeline(infer.port_config(cfg), port, device="cpu")
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


def test_vitg_module_tree_is_the_programs_at_published_widths():
    from video_depth_anything_torch.models.video_depth import VideoDepthAnything

    ref = infer.reference_shapes(VITG)
    with torch.device("meta"):
        port = VideoDepthAnything(infer.port_config(VITG))
    want = {k: tuple(t.shape) for k, t in ref.state_dict().items()}
    assert want == {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert want["pretrained.blocks.39.mlp.w12.weight"] == (8192, 1536)
    assert want["pretrained.blocks.0.mlp.w3.weight"] == (1536, 4096)
    assert len([k for k in want if k.endswith(".mlp.w12.weight")]) == 40
    assert set(weights.rules(ref)) == set(want)


def test_an_unknown_ffn_layer_is_refused():
    with pytest.raises(ValueError, match="ffn_layer"):
        infer.reference_shapes(dict(CFG, ffn_layer="geglu"))
