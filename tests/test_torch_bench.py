"""The port's bench (``python -m video_depth_anything_torch.bench``) on the
CPU, in the manner of test_bench_smoke.py: the full default flow at a toy
size prints one JSON line with the JAX bench's keys and no ``_error``;
without CUDA (and without ``--device cpu``) it prints the error record and
exits 1; a section that fails still prints the record, and the process
exits 1. The long-video bench tool exits 2 without a card.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["--encoder", "vits", "--size", "70", "--iters", "1", "--warmup", "0", "--chain", "1"]
# The keys of the JAX package's bench.py record (its default flow at --size 70).
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "batch_windows", "chain", "fps_per_chip",
            "e2e_ms_per_frame", "e2e_frames", "e2e_transfer_ms_per_frame",
            "e2e_transfer_pre_ms_per_frame", "e2e_transfer_post_ms_per_frame",
            "e2e_transfer_duplex_ms_per_frame", "steady_state_ms_per_frame",
            "steady_state_fps_per_chip", "steady_state_batched_ms_per_frame",
            "steady_state_batched_windows", "steady_state_batched_fps_per_chip",
            "vits_ms_per_frame_70_int8", "int8_vs_baseline", "int8_fps_per_chip")


def _bench(args):
    # Two intra-op threads: beside the other test workers, one thread per
    # core oversubscribes the cores and the run takes 10x longer.
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "video_depth_anything_torch.bench", *args],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)


def _one_record(stdout):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected one stdout line, got: {lines}"
    return json.loads(lines[0])


def test_bench_full_record_on_the_cpu():
    res = _bench(["--device", "cpu", *TOY, "--e2e_frames", "54"])
    assert res.returncode == 0, f"bench failed:\n{res.stdout}\n{res.stderr}"
    record = _one_record(res.stdout)
    missing = [k for k in JAX_KEYS if k not in record]
    assert not missing, (missing, record)
    assert not [k for k in record if k.endswith("_error")], record
    assert record["metric"] == "vits_ms_per_frame_70" and record["unit"] == "ms/frame"
    for key in JAX_KEYS[4:]:
        if key not in ("batch_windows", "chain", "e2e_frames", "steady_state_batched_windows"):
            assert record[key] > 0, (key, record)
    assert record["value"] > 0 and record["vs_baseline"] == pytest.approx(7.5 / record["value"])
    assert record["e2e_frames"] == 54 and record["steady_state_batched_windows"] == 4
    assert record["device"] == {"name": "cpu", "power_limit": None}


def test_bench_without_cuda_prints_the_error_record():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    res = _bench(TOY)
    assert res.returncode == 1
    record = _one_record(res.stdout)
    assert record["value"] is None and record["vs_baseline"] is None
    assert record["metric"] == "vits_ms_per_frame_70" and "CUDA" in record["error"]


def test_failed_section_still_prints_the_record_and_exits_1(monkeypatch, capsys):
    from video_depth_anything_torch import bench

    def broken(*a, **k):
        raise RuntimeError("copy engine gone")

    monkeypatch.setattr(bench, "transfer_floor", broken)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # beside the JAX CPU client's threads
    try:
        rc = bench.main(["--device", "cpu", *TOY, "--no_steady", "--no_int8"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 1
    record = _one_record(capsys.readouterr().out)
    assert record["e2e_error"] == "RuntimeError: copy engine gone"
    assert record["value"] > 0 and "e2e_ms_per_frame" not in record


def test_bench_takes_vitg_without_a_baseline(monkeypatch, capsys):
    """``--encoder vitg`` parses, and its records carry no baseline: the
    reference publishes no vitg row (as for vitb). The CPU runs vitg's
    layout (the SwiGLU encoder at dh 64) cut to two narrow blocks."""
    import dataclasses

    from video_depth_anything_torch import bench, config

    assert bench.parse_args(["--encoder", "vitg"]).encoder == "vitg"
    assert "vitg" not in bench.BASELINES_MS_PER_FRAME
    full = config.get_model_config

    def cut(name):
        cfg = full(name)
        vit = dataclasses.replace(cfg.vit, embed_dim=128, depth=2, num_heads=2)
        return dataclasses.replace(cfg, features=32, out_channels=(32, 32, 32, 32),
                                   taps=(0, 0, 1, 1), vit_override=vit)

    monkeypatch.setattr(config, "get_model_config", cut)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # beside the JAX CPU client's threads
    try:
        rc = bench.main(["--device", "cpu", "--encoder", "vitg", "--size", "28", "--iters", "1",
                         "--warmup", "0", "--chain", "1", "--no_e2e"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    record = _one_record(capsys.readouterr().out)
    assert record["metric"] == "vitg_ms_per_frame_28" and record["value"] > 0
    assert record["vs_baseline"] is None and record["int8_vs_baseline"] is None
    assert record["vitg_ms_per_frame_28_int8"] > 0
    assert record["steady_state_batched_windows"] == 2      # vitl's, as the JAX bench


def test_bench_help_names_what_is_not_ported():
    res = _bench(["--help"])
    assert res.returncode == 0
    assert "--no_pallas" in res.stdout and "--device_timeout" in res.stdout


def test_long_video_bench_exits_2_without_a_card(monkeypatch, capsys):
    from video_depth_anything_torch.tools import bench_long_video

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_long_video.main(["--frames", "10"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
