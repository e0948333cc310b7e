"""The benchmark's operation and byte counts against the bounds PERF.md's
kernel table states, and FlopCounterMode's count of a vits window and of
a tiny fused-SwiGLU encoder against a hand count."""
from __future__ import annotations

import pytest

from vdabench import counts, spec
from vdabench.tests import tiny


def test_k1_bound_at_the_table_shape():
    ops, nbytes = counts.k1(22, 1814, 384, 6)
    assert counts.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.1124, abs=5e-5)
    assert ops / counts.PEAK_FLOPS > nbytes / counts.PEAK_BYTES     # bound by operations


def test_k2_backward_per_vits_step():
    cfg = spec.load_cell("vits-720p-shortclips-c4").config
    ops, nbytes = counts.k2_head(cfg, 37, 37, 1, 20, backward=True)
    assert nbytes == pytest.approx(470e6, rel=2e-3)
    assert ops == pytest.approx(6.7e9, rel=5e-3)
    bound = sum(2 * counts.bound_s(*counts.k2_backward(px, 20, c))
                for px, c in counts.motion_shapes(cfg, 37, 37))
    assert bound * 1e3 == pytest.approx(0.1403, abs=5e-5)


def test_k2_forward_at_the_table_shape():
    ops, nbytes = counts.k2(7252, 32, 64)
    assert counts.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0355, abs=5e-5)


def test_motion_shapes_at_518_square_and_720p():
    cfg = spec.load_cell("vits-720p-shortclips-c4").config
    assert counts.motion_shapes(cfg, 37, 37) == [(1369, 192), (361, 384), (1369, 64), (5476, 64)]
    assert counts.motion_shapes(cfg, 37, 66) == [(2442, 192), (19 * 33, 384), (2442, 64),
                                                 (4 * 2442, 64)]


def test_flop_counter_matches_a_hand_count_of_the_vits_encoder():
    cfg = spec.load_cell("vits-720p-shortclips-c4").config
    f = counts.model_flops(cfg, (518, 518), 32)
    d, s, blocks = cfg["embed_dim"], 1 + 37 * 37, max(cfg["taps"]) + 1
    linears = 2 * s * (3 * d * d + d * d + 2 * 4 * d * d)
    attention = 4 * s * s * d
    patch = 2 * 37 * 37 * d * 3 * 14 * 14
    assert f["encoder"] == pytest.approx(blocks * (linears + attention) + patch, rel=1e-9)
    assert f["head"] > 0


def test_flop_counter_matches_a_hand_count_of_a_swiglu_encoder():
    cfg = dict(tiny.CONFIG, ffn_layer="swiglufused")
    f = counts.model_flops(cfg, (518, 518), 32)
    d, s, blocks = cfg["embed_dim"], 1 + 37 * 37, max(cfg["taps"]) + 1
    h = (int(int(d * cfg["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8
    assert h == 176
    linears = 2 * s * (3 * d * d + d * d) + 2 * s * (d * 2 * h + h * d)
    attention = 4 * s * s * d
    patch = 2 * 37 * 37 * d * 3 * 14 * 14
    assert f["encoder"] == pytest.approx(blocks * (linears + attention) + patch, rel=1e-9)


def test_train_flops_count_the_head_backward():
    cfg = spec.load_cell("vits-720p-shortclips-c4").config
    f = counts.model_flops(cfg, (518, 518), 20, train=True)
    assert 1.5 * f["head"] < f["head_backward"] < 2.5 * f["head"]
