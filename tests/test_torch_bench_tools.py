"""The port's A/B bench tool ``tools/bench_wgmma.py`` on the CPU: it exits 2
without a card (it measures nothing here), and its shape lists are
PERF.md's kernel-table shapes for K3 and K2, the ones the old / new runs
are compared at."""
import sys

import torch

from video_depth_anything_torch.tools import bench_wgmma


def test_bench_wgmma_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["bench_wgmma", "--label", "cpu"])
    assert bench_wgmma.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_bench_wgmma_k3_shapes_are_the_encoder_shapes():
    """(label, B, S, H): the int8 main path's cached window and the vits and
    vitl 518^2 windows, head dim 64."""
    assert [shape[1:] for shape in bench_wgmma.K3_SHAPES] == [
        (22, 1814, 6), (32, 1370, 6), (32, 1370, 16)]


def test_bench_wgmma_k2_shapes_are_the_motion_module_shapes():
    """(P, C) of motion modules 0-3 of vits 518^2, vitl 518^2 and vits
    518x686 (the main path's), each at T = 32 with 8 heads."""
    assert (bench_wgmma.K2_FRAMES, bench_wgmma.K2_HEADS) == (32, 8)
    assert [shape[1:] for shape in bench_wgmma.K2_SHAPES] == [
        (1369, 192), (361, 384), (1369, 64), (5476, 64),
        (1369, 1024), (361, 1024), (1369, 256), (5476, 256),
        (1813, 192), (475, 384), (1813, 64), (7252, 64)]
    assert len({shape[0] for shape in bench_wgmma.K2_SHAPES}) == 12   # labels tell them apart


def test_bench_wgmma_measurement_rows_are_the_bench_tools_shapes():
    """T1 at the phase bench's 64 steps of 1408 rows x 1408 keys (PV 24
    steps), T3's two probes at the same, T2 at its [32, 1370, 16 x 64]
    under the three schedules, and
    K1's denominator pair at the main path's cached window and vitl 518^2."""
    from video_depth_anything_torch.kernels.attention_variants import SCHEDULES
    from video_depth_anything_torch.kernels.qk_probes import PHASE_PROBES
    from video_depth_anything_torch.tools import bench_kernel_phases as phases

    assert [row[0] for row in bench_wgmma.T1_SHAPES] == list(PHASE_PROBES)
    for name, steps, m, n in bench_wgmma.T1_SHAPES:
        assert (steps, m, n) == ((phases.PV_STEPS if name == "pv128x2" else phases.QK_STEPS),
                                 phases.S_PAD, phases.S_PAD)
    assert bench_wgmma.T3_SHAPES == [("qk64 x2heads", 2, phases.QK_STEPS, phases.S_PAD,
                                      phases.S_PAD),
                                     ("qk128 x1", 1, phases.QK_STEPS, phases.S_PAD, phases.S_PAD)]
    assert bench_wgmma.T2_SHAPE == (phases.B, phases.S, phases.H)
    assert bench_wgmma.T2_SCHEDULES == SCHEDULES
    assert [shape[1:] for shape in bench_wgmma.K1_DENOM_SHAPES] == [(22, 1814, 6), (32, 1370, 16)]


def test_bench_tools_report_the_new_rows_keys(monkeypatch):
    """The phase bench's rows on the CPU with the card's calls replaced:
    T1's sink row and its ratio, T2's error against K1 with each
    denominator, K1 with mxu_denom; bench_kernel_ab's exp2 row."""
    from video_depth_anything_torch.tools import bench_kernel_ab as ab
    from video_depth_anything_torch.tools import bench_kernel_phases as phases

    monkeypatch.setattr(phases, "marginal_ms", lambda fn, *a, **kw: 0.1)
    monkeypatch.setattr(ab, "marginal_ms", lambda fn, *a, **kw: 0.1)
    rows = phases.probes(inputs={"qk": (torch.zeros(1, 64, 128), torch.zeros(1, 128, 128)),
                                 "pv": (torch.zeros(1, 64, 64),) * 2 + (torch.zeros(1, 64, 128),)})
    assert set(rows) == {"qk64x2", "qk128", "qk+sm x2", "pv128x2", "qk64x2 sink", "derived"}
    assert rows["derived"]["sink_over_plain"] == 1.0
    x = torch.zeros(1, 130, 1024)
    rows = phases.variants(inputs=(x, x, x))
    assert {"base", "stagger", "kchunk", "prod", "prod mxu_denom", "sdpa"} <= set(rows)
    assert {"err_vs_k1", "err_vs_k1_mxu_denom"} <= set(rows["stagger"])
    rows = ab.variants(inputs=(x, x, x))
    assert rows["exp2"]["over_prod"] == 1.0 and "prod mxu_denom" in rows


def test_bench_kernel_ab_probes_report_t3_against_its_bound(monkeypatch, capsys):
    """bench_kernel_ab's T3 rows on the CPU with the timing replaced: each
    probe's bound counts q and k in bf16 and the fp32 output (operations
    0.0328 ms, bytes 0.0275 ms at the tool's shape), and the ratio line
    names the wgmma chains it compares."""
    from video_depth_anything_torch.tools import bench_kernel_ab as ab

    monkeypatch.setattr(ab, "marginal_ms", lambda fn, *a, **kw: 0.05)
    rows = ab.probes(inputs={"qk": (torch.zeros(1, 64, 128), torch.zeros(1, 128, 128))})
    assert set(rows) == {"qk64 x2heads", "qk128 x1", "ratio"} and rows["ratio"] == 1.0
    for name in ("qk64 x2heads", "qk128 x1"):
        assert rows[name]["bound_by"] == "operations"
        assert abs(rows[name]["bound_ms"] - 0.0328) < 1e-4
        assert abs(rows[name]["bytes_ms"] - 0.0275) < 1e-4
    assert "two 4-step chains" in capsys.readouterr().out
