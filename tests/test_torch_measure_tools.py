"""The port's measurement tools on the CPU: bench_memory's accounting,
bench_int8_conv's integer conv, bench_drift_518's report and bench_decode.

- bench_memory's weights-plus-frames bytes (every parameter and buffer and
  the uint8 window) and output bytes equal the argument and output sizes
  of JAX's compiled window program (``memory_analysis``, as the JAX tool
  reads it) on the same config, but for the leaves jit drops because the
  program never reads them (named in UNREAD); the card
  reads the same count from the allocator (tests/test_torch_cuda.py).
- bench_int8_conv's im2col + integer product equals an int64 reference
  conv exactly.
- bench_drift_518's report has the JAX tool's keys (restated from
  tools/bench_drift_518.py:71-79), with finite numbers, on a toy run.
- bench_decode runs cv2 against the ffmpeg backend with
  tests/test_torch_video_io.py's stub imageio_ffmpeg, and exits non-zero,
  naming the module, when cv2 or imageio_ffmpeg is missing.
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.models import build_model
from video_depth_anything_torch.tools import bench_decode, bench_drift_518, bench_int8_conv
from video_depth_anything_torch.tools import bench_memory

torch.set_num_threads(2)
# The leaves the window forward never reads: the mask token (masked
# training only) and refinenet4's first unit (it fuses no skip).
UNREAD = ("pretrained.mask_token",
          *(f"head.scratch.refinenet4.resConfUnit1.conv{i}.{p}" for i in (1, 2)
            for p in ("weight", "bias")))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_memory_accounting_equals_the_jax_programs_arguments(dtype):
    from video_depth_anything_tpu.config import get_model_config as j_config
    from video_depth_anything_tpu.models.video_depth import forward, param_shapes
    from video_depth_anything_tpu.pipeline import preprocess

    size, frames = 56, 32
    jdt = jnp.dtype(dtype)
    cfg = j_config("vits")
    p_shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jdt if s.dtype == jnp.float32 else s.dtype), param_shapes(cfg))
    win = jax.ShapeDtypeStruct((1, frames, size, size, 3), jnp.uint8)

    def fn(params, win_u8):   # the JAX tool's program (tools/bench_memory.py:50-52)
        return forward(params, preprocess.preprocess_frames(win_u8, (size, size), dtype=jdt),
                       cfg)

    mem = jax.jit(fn).lower(p_shapes, win).compile().memory_analysis()
    out_bytes = mem.output_size_in_bytes or sum(   # the CPU reports 0 (:59-61)
        s.size * s.dtype.itemsize for s in jax.tree.leaves(jax.eval_shape(fn, p_shapes, win)))

    tdt = getattr(torch, dtype)
    model = build_model(get_model_config("vits")).to(tdt)
    twin = torch.zeros((1, frames, size, size, 3), dtype=torch.uint8)
    ours = bench_memory.argument_bytes(model, twin)
    leaves = {jax.tree_util.keystr(p): s.size * s.dtype.itemsize
              for p, s in jax.tree_util.tree_leaves_with_path(p_shapes)}
    # Each JAX leaf is the port's tensor of that name (blocks stacked in
    # JAX), the window one argument on both sides. jit drops the arguments
    # the program never reads, which the port's model holds on the card.
    assert ours["window"] == win.size == frames * size * size * 3
    assert sum(ours.values()) - ours["window"] == sum(leaves.values())
    assert sum(ours.values()) - sum(ours[n] for n in UNREAD) == mem.argument_size_in_bytes
    with torch.no_grad():
        out = bench_memory.forward_fn(model, size, tdt)(twin)
    assert out.numel() * out.element_size() == out_bytes


def test_int8_conv_is_exact():
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (2, 9, 7, 16), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (24, 16, 3, 3), generator=gen, dtype=torch.int8)
    got = bench_int8_conv.conv_int8(x, bench_int8_conv.int8_weight(w))
    assert got.dtype == torch.int32 and got.shape == (2, 9, 7, 24)
    xp = F.pad(x.long(), (0, 0, 1, 1, 1, 1))
    ref = sum(torch.einsum("nhwc,oc->nhwo", xp[:, dy:dy + 9, dx:dx + 7, :], w[:, :, dy, dx].long())
              for dy in range(3) for dx in range(3))
    assert torch.equal(got.long(), ref)


def test_drift_report_has_the_jax_keys():
    cfg = get_model_config("vits")
    rec = bench_drift_518.measure(frames=34, src_hw=(42, 56), input_size=56, device="cpu",
                                  cfg=cfg)
    assert list(rec) == ["metric", "frames", "src_hw", "backend", "bf16_max_err_frac",
                         "bf16_mean_err_frac", "int8_max_err_frac", "int8_mean_err_frac"]
    assert rec["metric"] == "vits_drift_56" and rec["backend"] == "cpu"
    assert all(math.isfinite(v) for k, v in rec.items() if k.endswith("_frac"))


def test_drift_report_on_numpy_weights():
    """``numpy_weights``: numpy_state_dict's weights, named by their
    SHA-256, and the int8 run with fp32 activations beside the JAX keys."""
    from video_depth_anything_torch.models import numpy_state_dict, state_dict_sha256

    cfg = get_model_config("vits")
    rec = bench_drift_518.measure(frames=34, src_hw=(42, 56), input_size=56, device="cpu",
                                  cfg=cfg, numpy_weights=1)
    assert list(rec)[-4:] == ["int8_fp32_max_err_frac", "int8_fp32_mean_err_frac",
                              "numpy_weights", "weights_sha256"]
    assert rec["weights_sha256"] == state_dict_sha256(numpy_state_dict(cfg, 1))
    assert all(math.isfinite(v) for k, v in rec.items() if k.endswith("_frac"))


def test_decode_runs_both_backends(monkeypatch, capsys):
    pytest.importorskip("cv2")
    from test_torch_video_io import stub_ffmpeg
    from video_depth_anything_torch.utils.precision import synthetic_video

    video = synthetic_video(bench_decode.CLIP_FRAMES, bench_decode.CLIP_HW, 3)
    mod, log = stub_ffmpeg(video, fps=bench_decode.CLIP_FPS)
    monkeypatch.setitem(sys.modules, "imageio_ffmpeg", mod)
    assert bench_decode.main([]) == 0
    out = capsys.readouterr().out
    assert "cv2" in out and "ffmpeg" in out and "pixel delta" in out, out
    assert f"{bench_decode.CLIP_FRAMES} frames" in out
    assert len(log["calls"]) == 2 and log["closed"] == 2   # the probe and the read


@pytest.mark.parametrize("missing", ["cv2", "imageio_ffmpeg"])
def test_decode_names_a_missing_module(missing, monkeypatch, capsys):
    from test_torch_video_io import stub_ffmpeg

    monkeypatch.setitem(sys.modules, "imageio_ffmpeg", stub_ffmpeg(np.zeros((1, 2, 2, 3),
                                                                            np.uint8))[0])
    monkeypatch.setitem(sys.modules, missing, None)
    assert bench_decode.main([]) != 0
    assert f"the {missing} module is not installed" in capsys.readouterr().err
