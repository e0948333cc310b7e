"""The port's A/B bench tool ``tools/bench_wgmma.py`` on the CPU: it exits 2
without a card (it measures nothing here), and its shape lists are
PERF.md's kernel-table shapes for K3 and K2, the ones the old / new runs
are compared at."""
import math
import sys

import pytest
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


def test_bench_wgmma_k2_backward_shapes_are_the_train_steps_motion_modules():
    """(P, T, C) of the K2 backward rows: vits's motion modules 0-3 at the
    train step's T (tools/bench_train_step.py's clip of 20 frames), then
    vitl's dh 128 and dh 32 modules (0 and 2) at T = 32, 8 heads."""
    import inspect

    from video_depth_anything_torch.tools import bench_train_step

    t = inspect.signature(bench_train_step.measure).parameters["clip_len"].default
    assert t == 20 and bench_wgmma.K2_BWD_HEADS == bench_wgmma.K2_HEADS == 8
    vits = [s[1:] for s in bench_wgmma.K2_SHAPES if s[0].startswith("vits 518^2")]
    vitl = [s[1:] for s in bench_wgmma.K2_SHAPES if s[0].startswith("vitl 518^2")]
    assert [s[1:] for s in bench_wgmma.K2_BWD_SHAPES] == (
        [(p, t, c) for p, c in vits] + [(p, bench_wgmma.K2_FRAMES, c) for p, c in vitl[::2]])
    assert [s[3] // 8 for s in bench_wgmma.K2_BWD_SHAPES] == [24, 48, 8, 8, 128, 32]
    assert len({s[0] for s in bench_wgmma.K2_BWD_SHAPES}) == 6


@pytest.mark.parametrize("group", ["rcu", "attention", "qk8", "temporal", "temporal_backward",
                                   "qk", "tail"])
def test_bench_variants_substitutions_are_in_the_sources(group):
    """Every text substitution of ``tools/bench_variants.py`` finds its
    text once in its source, and each variant builds a library the tool
    knows, so a variant is an edit of the shipped kernel and not a build
    error on the card."""
    import os

    from video_depth_anything_torch.kernels import build
    from video_depth_anything_torch.tools import bench_variants

    for name, (libs, subs) in bench_variants.VARIANTS[group].items():
        assert libs in bench_variants._LIBS, name
        for fname, old, new in subs:
            with open(os.path.join(build.CSRC, fname)) as f:
                assert f.read().count(old) == 1 and old != new, (name, old)


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


def test_drift_split_exits_2_without_a_card(monkeypatch, capsys):
    """tools/drift_split.py needs a card: without one it runs nothing."""
    import torch
    from video_depth_anything_torch.tools import drift_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert drift_split.main(["--encoder", "vitg"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_drift_split_takes_numpy_weights_and_exits_2_without_a_card(monkeypatch, capsys):
    """``--numpy_weights S`` parses (a seed, an integer) and the tool still
    runs nothing without a card."""
    import torch
    from video_depth_anything_torch.tools import drift_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert drift_split.main(["--encoder", "vitl", "--numpy_weights", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as err:
        drift_split.main(["--numpy_weights", "zero"])
    assert err.value.code == 2 and "--numpy_weights" in capsys.readouterr().err


def test_drift_split_on_numpy_weights_on_the_cpu():
    """``split`` on numpy_state_dict's weights, on the CPU at 56²: the three
    drifts finite, one pair of relative L2s per tap, the weights named by
    their SHA-256."""
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import numpy_state_dict, state_dict_sha256
    from video_depth_anything_torch.tools import drift_split

    cfg = get_model_config("vits")
    rec = drift_split.split("vits", device="cpu", numpy_weights=1, size=56)
    assert rec["card"] == "cpu" and rec["encoder"] == "vits" and rec["numpy_weights"] == 1
    assert rec["weights_sha256"] == state_dict_sha256(numpy_state_dict(cfg, 1))
    drifts = [rec[k][m] for k in ("all_bf16", "encoder_bf16", "head_bf16")
              for m in ("max_err_frac", "mean_err_frac")]
    assert all(math.isfinite(v) and v > 0 for v in drifts), rec
    assert len(rec["tap_rel_l2"]) == len(cfg.intermediate_layer_idx)
    assert all(0 < v < 0.1 for pair in rec["tap_rel_l2"] for v in pair), rec["tap_rel_l2"]
    assert rec["depth_range"] > 0


def test_drift_limits_exits_2_without_a_card(monkeypatch, capsys):
    """tools/drift_limits.py needs a card: without one it runs nothing."""
    import torch
    from video_depth_anything_torch.tools import drift_limits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert drift_limits.main(["--encoder", "vitg", "--seeds", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_drift_limits_plants_along_the_encoders_depth(monkeypatch):
    """Without ``--plant`` the planted blocks follow the encoder's depth:
    vitg's 0 10 20 30 39 as before, and vitl's 24 blocks 0 6 12 18 23."""
    import torch
    from video_depth_anything_torch.kernels import build
    from video_depth_anything_torch.tools import drift_limits

    assert drift_limits.default_plant(40) == [0, 10, 20, 30, 39]
    assert drift_limits.default_plant(24) == [0, 6, 12, 18, 23]
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "build_all", lambda: None)
    monkeypatch.setattr(drift_limits, "readings", lambda enc, seeds, plant, f: seen.append(plant))
    for argv in (["--encoder", "vitl"], ["--encoder", "vitl", "--plant", "3"],
                 ["--encoder", "vitl", "--plant"]):
        assert drift_limits.main(argv) == 0
    assert seen == [[0, 6, 12, 18, 23], [3], []]


def test_drift_limits_plants_one_block_swap(tmp_path):
    """The planted fault swaps one block's fc1 / fc2 absmax and nothing
    else; the faulted file still passes the pipeline's geometry check."""
    import numpy as np
    import torch
    from video_depth_anything_torch.pipeline import infer
    from video_depth_anything_torch.tools.drift_limits import swap_slots

    stats = {"encoder": {k: np.arange(4, dtype=np.float32) + 10 * j
                         for j, k in enumerate(("qkv", "proj", "fc1", "fc2"))},
             "motion": {"0": {"proj_in": np.float32(3.0)}}}
    src, dst = str(tmp_path / "a.int8calib.npz"), str(tmp_path / "b.int8calib.npz")
    infer._save_calib(src, stats, (28, 28), torch.float32)
    swap_slots(src, dst, 2)
    got = infer._load_calib(dst, (28, 28), torch.float32)
    enc = stats["encoder"]
    np.testing.assert_array_equal(got["encoder"]["fc1"], [20, 21, 32, 23])
    np.testing.assert_array_equal(got["encoder"]["fc2"], [30, 31, 22, 33])
    for k in ("qkv", "proj"):
        np.testing.assert_array_equal(got["encoder"][k], enc[k])
    assert got["motion"]["0"]["proj_in"] == 3.0


def test_block_rel_l2_sees_a_planted_fault_in_its_block(tmp_path):
    """``block_rel_l2`` (chip_smoke (k)'s full-depth int8 check): a sound
    int8 vits holds every block near int8's own error; a side file with one
    block's fc1 / fc2 absmax swapped, or its fc2 absmax halved, lifts that
    block alone past twice the largest sound block."""
    import numpy as np
    import torch
    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.pipeline import VideoDepthPipeline, preprocess
    from video_depth_anything_torch.tools.drift_limits import (
        block_rel_l2, scale_slot, swap_slots)
    from video_depth_anything_torch.utils.precision import synthetic_video

    torch.set_num_threads(2)
    cfg = get_model_config("vits")
    model = build_model(cfg, seed=0)
    frames = synthetic_video(n=8, hw=(42, 42), seed=1)
    net_hw = preprocess.network_input_hw(42, 42, preprocess.effective_input_size(42, 42, 28))
    bf16 = VideoDepthPipeline(cfg, model, device="cpu").model_in(torch.bfloat16)

    def errors(side):
        q = VideoDepthPipeline(cfg, model, device="cpu", quant="int8", calib_path=side)
        return block_rel_l2(bf16, q.quantized_model(frames, net_hw, torch.bfloat16),
                            frames, net_hw)

    side = str(tmp_path / "s.int8calib.npz")
    sound = errors(side)
    assert len(sound) == 12 and all(0 < e < 0.05 for e in sound), sound
    for i, plant in enumerate((lambda a, b: swap_slots(a, b, 5),
                               lambda a, b: scale_slot(a, b, 5, 0.5))):
        bad = str(tmp_path / f"bad{i}.int8calib.npz")
        plant(side, bad)
        got = errors(bad)
        assert got[5] > 2 * max(sound), (i, got)
        assert got[:5] + got[6:] == sound[:5] + sound[6:], (i, got)


def test_bench_train_step_record_on_the_cpu(capsys):
    """The train-step bench's one JSON line at a toy size on the CPU (no
    CUDA events there: no split, no K2 backward share)."""
    import json

    from video_depth_anything_torch.tools import bench_train_step

    assert bench_train_step.main(["--device", "cpu", "--clip_len", "2", "--size", "28",
                                  "--iters", "1", "--warmup", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "vits_train_step_28_clip2" and rec["unit"] == "ms/step"
    assert rec["value"] > 0 and rec["finite"] and len(rec["losses"]) == 2
    assert rec["launches_per_step"] == {} and rec["compute_dtype"] == "bfloat16"
    assert "split_ms" not in rec and "state" not in rec
