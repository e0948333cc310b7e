"""Kernel K7, the output head's full-resolution tail
(``kernels/head_output_tail.py``), on the CPU: the kernel runs only on a
card (tests/test_torch_cuda.py), so this file holds what surrounds it.

- Its tables: per output row and column, the two nonzeros of the bf16
  interpolation matrix ``device_matrix("linear", ...)``, bit for bit, at
  the model's maps for 518x924, 518² and a 4:3 input; and the two-pass
  upsample through them equals the resize the plain path runs, bit for bit.
- The dispatch (``Scratch.fused_tail``): the kernel on the mixed island on a
  card or in a trace; the CPU, fp32, ``train``, a C the kernel does not
  take and a map that is not upsampled keep the stages.
- The op: its CPU implementation equals the stages bit for bit (the
  tolerance of "today's tail" is zero); ``torch.library.opcheck``; the
  fake implementation on the meta device; a bf16 serving artifact holds
  it once.
- Its arithmetic (tests/test_torch_cuda.py::k7_arithmetic, the card test's
  reference: the bias before the rounding) against the plain version at
  the model's weights: the reason for the card test's 2e-2 of max |y|.
- The benchmark's reader of the counter ``fused``.
"""
import types

import numpy as np
import pytest
import torch

from test_torch_cuda import k7_arithmetic, k7_operands
from vdabench import spec
from video_depth_anything_torch import kernels
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.kernels import head_output_tail as k7
from video_depth_anything_torch.models import build_model, dpt
from video_depth_anything_torch.ops.resize import device_matrix, resize_bilinear_align_corners
from video_depth_anything_torch.utils import profiling

# (map, output) of output_conv1 at input 518: 8 and 14 times the patch grid.
SIZES = {"518x924 and 518² rows": (296, 518), "518x924 cols": (528, 924),
         "4:3 cols (518x686)": (392, 686), "2 -> 4": (2, 4)}


@pytest.mark.parametrize("size", list(SIZES))
def test_tables_are_the_matrix_nonzeros(size):
    h, oh = SIZES[size]
    m = device_matrix("linear", h, oh, None, torch.device("cpu"), torch.bfloat16).float().numpy()
    tab = k7.interp_table(h, oh)
    lo = tab[:, 0].view(np.int32).astype(np.int64)
    assert tab.dtype == np.float32 and tab.shape == (oh, 4) and (tab[:, 3] == 0).all()
    assert (lo >= 0).all() and (lo + 1 < h).all() and (np.diff(lo) >= 0).all()
    rows = np.arange(oh)
    np.testing.assert_array_equal(tab[:, 1].view(np.int32), m[rows, lo].view(np.int32))
    np.testing.assert_array_equal(tab[:, 2].view(np.int32), m[rows, lo + 1].view(np.int32))
    rest = m.copy()
    rest[rows, lo] = rest[rows, lo + 1] = 0
    assert not rest.any()          # every other entry of each row is zero


def test_two_passes_through_the_tables_are_the_resize():
    """Rows, then columns, each two products summed in fp32 and rounded to
    bf16: the einsums of ``resize_bilinear_align_corners`` bit for bit."""
    x = (3 * torch.randn(2, 40, 56, 16, generator=torch.Generator().manual_seed(1))
         ).to(torch.bfloat16)
    rt, ct = (torch.from_numpy(np.array(k7.interp_table(i, o))) for i, o in ((40, 70), (56, 98)))
    xf, rlo, clo = x.float(), rt[:, 0].view(torch.int32).long(), ct[:, 0].view(torch.int32).long()
    r = (rt[:, 1, None, None] * xf[:, rlo] + rt[:, 2, None, None] * xf[:, rlo + 1])
    r = r.to(torch.bfloat16).float()
    u = (ct[:, 1, None] * r[:, :, clo] + ct[:, 2, None] * r[:, :, clo + 1]).to(torch.bfloat16)
    assert torch.equal(u, resize_bilinear_align_corners(x, (70, 98)))


def _stand_in(dtype=torch.bfloat16, shape=(2, 16, 24, 64), cuda=True):
    """What ``fused_tail`` reads of path_1, on a card that is not here."""
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=shape)


@pytest.mark.parametrize("case, want", [
    ("card bf16", True), ("cpu", False), ("fp32", False), ("train", False),
    ("C 20", False), ("C 224", False), ("not upsampled", False)])
def test_dispatch(case, want):
    sc = dpt.Scratch([32] * 4, {"C 20": 40, "C 224": 448}.get(case, 64))
    path_1 = _stand_in(dtype=torch.float32 if case == "fp32" else torch.bfloat16,
                       shape=(2, 16, 24, sc.output_conv1.weight.shape[1]), cuda=case != "cpu")
    out_hw = (16, 24) if case == "not upsampled" else (28, 42)
    assert sc.fused_tail(path_1, out_hw, train=case == "train") is want


def test_the_cpu_keeps_the_stages(monkeypatch):
    """On the CPU ``output_head`` never reaches the op (its stages run), and
    the op's CPU implementation equals them bit for bit."""
    sc = dpt.Scratch([32] * 4, 64).to(torch.bfloat16)
    path_1 = torch.randn(2, 16, 24, 64, generator=torch.Generator().manual_seed(2)
                         ).to(torch.bfloat16)
    c2a, c2b = sc.output_conv2[0], sc.output_conv2[2]
    with torch.no_grad():
        x = sc.head_conv1(path_1)
        op = k7.head_output_tail(x, c2a.weight, c2a.bias, c2b.weight, c2b.bias, (28, 42))

        def refuse(*a, **k):
            raise AssertionError("the CPU path reached K7's op")

        monkeypatch.setattr(dpt, "head_output_tail", refuse)
        got = sc.output_head(path_1, (28, 42))
    assert op.shape == (2, 28, 42, 1) and op.dtype == torch.float32
    assert torch.equal(op, got)
    assert k7.head_output_tail.launches == 0


def test_opcheck_and_the_meta_device():
    x = torch.randn(2, 8, 12, 32, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    ops = k7_operands(32, torch.Generator().manual_seed(4), device="cpu")
    torch.library.opcheck(k7.head_output_tail_op, (x, *ops, 14, 21))
    meta = k7.head_output_tail(x.to("meta"), *(t.to("meta") for t in ops), (14, 21))
    assert meta.device.type == "meta" and meta.shape == (2, 14, 21, 1)
    assert meta.dtype == torch.float32


def test_the_wrapper_refuses_a_gradient():
    x = torch.randn(1, 4, 4, 16).to(torch.bfloat16)
    w1, b1, w2, b2 = k7_operands(16, torch.Generator().manual_seed(5), device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        k7.head_output_tail(x, w1.requires_grad_(), b1, w2, b2, (7, 7))


@pytest.mark.parametrize("encoder", ["vits", "vitl"])
def test_the_kernels_rounding_is_within_the_card_tolerance(encoder):
    """The kernel's arithmetic (the bias added before the bf16 rounding)
    against the plain version on the model's seeded weights: 0.35-0.7 % of
    max |y| at these seeds; the card test holds the kernel to 2e-2."""
    cfg = get_model_config(encoder)
    sc = build_model(cfg, seed=0).head.scratch.to(torch.bfloat16)
    path_1 = torch.randn(2, 24, 32, cfg.features, generator=torch.Generator().manual_seed(6)
                         ).to(torch.bfloat16)
    c2a, c2b = sc.output_conv2[0], sc.output_conv2[2]
    ops = (c2a.weight, c2a.bias, c2b.weight, c2b.bias)
    with torch.no_grad():
        x = sc.head_conv1(path_1)
        plain = k7.head_output_tail_plain(x, *ops, (42, 56))
        exact = k7_arithmetic(x, *ops, (42, 56))
    err = ((plain - exact).abs().max() / exact.abs().max()).item()
    assert 0 < err <= 1e-2


def test_a_bf16_artifact_holds_the_op_once():
    """A trace takes the op whatever its device (the artifact launches K7 on
    a card as the live program does); the fp32 island holds none."""
    from video_depth_anything_torch.config import ViTConfig
    from video_depth_anything_torch.utils import serving_export as se

    cfg = get_model_config("vits", vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2),
                           taps=(0, 0, 1, 1))
    for fp32, want in ((False, 1), (True, 0)):
        ep = se.export_window_program(cfg, (42, 56), input_size=28, fp32=fp32, device="cpu")
        assert se.vda_op_counts(ep).get("head_output_tail", 0) == want


@pytest.mark.parametrize("name", ["model.head_output_fused_share",
                                  "model.head_output_fused_share.short"])
def test_the_fused_share_reads_the_output_spans_counter(name, monkeypatch):
    from vdabench.trace import Profile

    def row(count, **counters):
        return {"count": count, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
                "counters": counters}

    read = spec.metric_reader(name)
    ctx = types.SimpleNamespace(profile=Profile(window_s=2.0, busy_s=1.0, gaps={}))
    for totals, want in (({"vda.head.output": row(8, fused=6)}, 75.0),
                         ({"vda.head.output": row(8, fused=0)}, 0.0),
                         ({"vda.head.output": row(8)}, None),      # a program without it
                         ({}, None)):
        monkeypatch.setattr(profiling, "totals", lambda t=totals: t)
        assert read(ctx) == want
    assert read(types.SimpleNamespace(profile=None)) is None
    monkeypatch.delattr(profiling, "totals")
    assert read(ctx) is None
    assert kernels.KERNELS["head_output_tail"] is k7.head_output_tail
