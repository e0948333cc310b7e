"""The harness end to end on a throwaway cell (files in a temporary copy,
no code edited), with the timed path sound and with it broken underneath;
and, on the card, the control at each cell's own size.

The CPU runs skip the harness's look for a card (``run_cell(...,
device="cpu")``) and drive the rest of a run on the program's plain path.
Each fault is planted in the program where the answer is produced and
must turn ``correct`` false:

- an answer altered: every later window's stitched frames scaled by 1.1;
- a step that returns its state unchanged: the sequential keyframe cache
  keeps the first window's features for good;
- half of the batch left out: the batched cache's head output for every
  second window replaced by the window before it;
- a lower precision in the encoder: its taps rounded to bfloat16, which
  the depth (through the head) barely shows and the taps do; and the
  program's own int8 path, which the encoder's branches show;
- the fused SwiGLU FFN's gate on the wrong half (``silu(x2) * x1``),
  which the encoder's branches show.

The files' options reach the program: the streaming entry, the metric
model's stitch, the encoder's FFN kind, and the pipeline's int8 option;
an FFN kind the harness does not run is refused.
"""
from __future__ import annotations

import pytest
import torch

from vdabench import check, run, spec
from vdabench.tests import tiny

LIMITS = {"mean_err_pct": 1.0, "max_err_pct": 6.0, "tap_err_pct": 2.0, "branch_err_pct": 1.0}
FP32 = {"dtype": "float32"}     # the taps to rounding: a fault in them shows


SEQUENTIAL_3 = {"clip_frames": [46, 50], "lengths": 2, "warmup_lengths": [46]}
BATCHED_3 = {"clip_frames": [46, 50], "lengths": 2, "warmup_lengths": [46, 50],
             "windows_per_batch": 4}


def _run(tmp_path, trace=False, **over):
    over["workload"] = dict({"limits": LIMITS}, **over.get("workload", {}))
    root, bench = tiny.make(str(tmp_path), **over)
    torch.set_num_threads(2)
    return run.run_cell("tiny-cell", 2**31 + 99, 0.5, trace, device="cpu", root=root,
                        benchmark=bench, setup_clock=lambda: 1.0)


def test_a_throwaway_cell_runs_without_an_edit(tmp_path):
    line = _run(tmp_path)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == {"setup_s", "peak_mem_gib", "clip_latency_p90_s"}
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(LIMITS)


@pytest.mark.parametrize("traffic", [SEQUENTIAL_3, BATCHED_3])
def test_the_faults_traffic_is_correct_when_sound(tmp_path, traffic):
    assert _run(tmp_path, traffic=traffic)["correct"]


def test_a_traced_run_reports_what_it_can_read(tmp_path):
    line = _run(tmp_path, trace=True)
    assert line["correct"]
    # On the CPU only the pipeline's spans exist: no events, no profiler.
    assert set(line["metrics"]) == {"pipeline.host_share.short"}


def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.pipeline import stitch

    orig = stitch.stitch_step

    def altered(carry, depths, metric=False):
        carry, emit = orig(carry, depths, metric)
        return carry, emit * 1.1

    monkeypatch.setattr(stitch, "stitch_step", altered)
    assert not _run(tmp_path)["correct"]


def test_a_cache_that_keeps_its_state_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.pipeline import infer as port_infer

    orig = port_infer.SequentialKeyframeCache.__call__

    def stale(self, frames, index, r, n=None):
        first = self.feats
        out = orig(self, frames, index, r, n)
        if first is not None:
            self.feats = first
        return out

    monkeypatch.setattr(port_infer.SequentialKeyframeCache, "__call__", stale)
    assert not _run(tmp_path, traffic=SEQUENTIAL_3)["correct"]


def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.pipeline import infer as port_infer

    orig = port_infer.BatchedKeyframeCache.__call__

    def half(self, frames, index, r, n=None):
        depth = orig(self, frames, index, r, n).clone()
        depth[1::2] = depth[0::2][:depth[1::2].shape[0]]
        return depth

    monkeypatch.setattr(port_infer.BatchedKeyframeCache, "__call__", half)
    assert not _run(tmp_path, traffic=BATCHED_3)["correct"]


def test_the_taps_are_those_of_the_clips_first_frames(tmp_path):
    line = _run(tmp_path, config=FP32)
    assert line["correct"] and line["checks"]["tap_err_pct"]["value"] < 1e-3
    assert line["checks"]["branch_err_pct"]["value"] < 1e-3


def test_an_encoder_in_a_lower_precision_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.models import video_depth

    orig = video_depth.VideoDepthAnything.encode

    def rounded(self, frames):
        return [(t.bfloat16().float(), c.bfloat16().float()) for t, c in orig(self, frames)]

    monkeypatch.setattr(video_depth.VideoDepthAnything, "encode", rounded)
    line = _run(tmp_path, config=FP32, workload={"limits": dict(LIMITS, tap_err_pct=0.1)})
    assert not line["correct"]
    assert line["checks"]["tap_err_pct"]["value"] > 0.1


@pytest.mark.parametrize("traffic,config", [
    ({"entry": "infer_video_depth_streaming"}, {}),
    (dict(BATCHED_3, entry="infer_video_depth_streaming"), {}),
    (SEQUENTIAL_3, {"metric": True}),
    ({}, {"ffn_layer": "swiglufused"}),
], ids=["streaming", "streaming-c4", "metric", "swiglu"])
def test_an_entry_or_model_option_from_the_files_is_correct(tmp_path, traffic, config):
    line = _run(tmp_path, traffic=traffic, config=dict(FP32, **config))
    assert line["correct"] and line["checks"]["tap_err_pct"]["value"] < 1e-3
    assert line["checks"]["branch_err_pct"]["value"] < 1e-3


def test_a_swiglu_gate_on_the_wrong_half_is_not_correct(tmp_path, monkeypatch):
    import torch.nn.functional as F

    from video_depth_anything_torch.models import dinov2

    def swapped(self, x, stats=None):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x2) * x1)

    monkeypatch.setattr(dinov2.SwiGLUFFNFused, "forward", swapped)
    line = _run(tmp_path, config=dict(FP32, ffn_layer="swiglufused"))
    assert not line["correct"]
    assert line["checks"]["branch_err_pct"]["value"] > LIMITS["branch_err_pct"]


def test_an_ffn_layer_the_harness_does_not_run_is_refused(tmp_path):
    with pytest.raises(ValueError, match="ffn_layer 'geglu'"):
        _run(tmp_path, config={"ffn_layer": "geglu"})


def test_the_pipelines_int8_path_is_not_correct(tmp_path):
    """The program's own int8 path, named in the traffic file, reaches the
    program and fails the encoder's branches (bf16 reads about 0.3 % here,
    int8 about 1.9 %), though its depth stays within the depth's limits."""
    line = _run(tmp_path, traffic={"pipeline": {"quant": "int8"}})
    checks = line["checks"]
    assert not line["correct"] and checks["branch_err_pct"]["value"] > LIMITS["branch_err_pct"]
    assert checks["mean_err_pct"]["value"] < LIMITS["mean_err_pct"]


def test_without_a_card_the_command_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    assert run.main(["--workload", "vitl-720p-clips", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    run.use_checkout_caches()
    from video_depth_anything_torch.utils.compile_cache import maybe_enable_from_env

    maybe_enable_from_env()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vitl-720p-clips", "vits-720p-shortclips-c4", "vits-train-518"])
def test_the_control_is_not_correct_at_the_cells_size(card, cell):
    """The controls (the program's int8 path; the reference with float8
    operands in the program's place) fail the cell's limits on three
    seeds, and so does a train cell's planted fault; the program passes
    them on the same inputs."""
    from vdabench import readings, train

    c = spec.load_cell(cell)
    fn = train.readings if c.traffic["mode"] == "train" else readings.readings
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        recs = {r["side"]: r["numbers"] for r in fn(c, seed, control=True)}
        assert check.judge(recs.pop("program"), c.workload["limits"])[0]
        assert recs and not any(check.judge(v, c.workload["limits"])[0] for v in recs.values())
