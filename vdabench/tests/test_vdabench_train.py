"""The train cell's harness on a throwaway tiny cell, on the program's
plain CPU path in float32: sound, it reads the reference's steps to
rounding; broken underneath, ``correct`` turns false for each fault a
train cell can have (no exchange between chips exists on one card):

- a step that returns its state unchanged (the head's tensors put back
  after every step): the change reads 1;
- half of the batch left out, the loss the mean over the rest (the first
  half of each clip's frames);
- an answer altered where it is produced (the loss scaled by 1.01);
- an update with the wrong sign (each step's change of the head undone
  and applied negated), which leaves every norm as it was: the
  difference's norm reads 2.
"""
from __future__ import annotations

import pytest
import torch

from vdabench import run, spec, train
from vdabench.tests import tiny

LIMITS = {"first_loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 5e-2, "grad_diff": 5e-2,
          "change_diff": 0.2}


def _run(tmp_path, trace=False):
    root, bench = tiny.make(str(tmp_path), config={"dtype": "float32"},
                            traffic=tiny.TRAIN_TRAFFIC,
                            workload={"traffic": "tiny-train", "limits": LIMITS})
    torch.set_num_threads(2)
    return run.run_cell("tiny-cell", 2**31 + 7, 0.5, trace, device="cpu", root=root,
                        benchmark=bench, setup_clock=lambda: 1.0)


def test_a_sound_train_cell_is_correct(tmp_path):
    line = _run(tmp_path)
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "train_step_ms", "peak_mem_gib"}
    assert all(c["value"] < c["limit"] / 10 for c in line["checks"].values())


def test_a_traced_train_run(tmp_path):
    line = _run(tmp_path, trace=True)
    assert line["correct"] and set(line["metrics"]) == {"mfu.train"}


def test_a_step_that_keeps_its_state_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.training import train_state as ts

    orig = ts.train_step

    def unchanged(state, batch, cfg, tc, phase=None):
        before = {k: v.detach().clone() for k, v in state.head.items()}
        out = orig(state, batch, cfg, tc, phase)
        with torch.no_grad():
            for k, v in state.head.items():
                v.copy_(before[k])
        return out

    monkeypatch.setattr(ts, "train_step", unchanged)
    line = _run(tmp_path)
    assert not line["correct"] and line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.training import train_state as ts

    orig = ts.loss_fn

    def half(state, batch, cfg, tc, phase=None):
        t = batch["video"].shape[1] // 2
        return orig(state, {k: v[:, :t] for k, v in batch.items()}, cfg, tc, phase)

    monkeypatch.setattr(ts, "loss_fn", half)
    assert not _run(tmp_path)["correct"]


def test_an_altered_loss_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.training import train_state as ts

    orig = ts.loss_fn

    def altered(*args, **kw):
        total, aux = orig(*args, **kw)
        return total * 1.01, aux

    monkeypatch.setattr(ts, "loss_fn", altered)
    assert not _run(tmp_path)["correct"]


def test_the_control_and_the_fault_read_far_from_the_program(tmp_path):
    """At the tiny size the float8 control and half a batch read at least
    ten times the float32 program on some number."""
    root, bench = tiny.make(str(tmp_path), config={"dtype": "float32"},
                            traffic=tiny.TRAIN_TRAFFIC, workload={"traffic": "tiny-train"})
    torch.set_num_threads(2)
    recs = {r["side"]: r["numbers"] for r in
            train.readings(spec.load_cell("tiny-cell", root, bench), 3, True, device="cpu")}
    for side in ("control_fp8", "fault_half_batch"):
        assert any(recs[side][k] > 10 * max(recs["program"][k], 1e-6) for k in LIMITS)


def test_an_update_with_the_wrong_sign_is_not_correct(tmp_path, monkeypatch):
    from video_depth_anything_torch.training import train_state as ts

    orig = ts.train_step

    def negated(state, batch, cfg, tc, phase=None):
        before = {k: v.detach().clone() for k, v in state.head.items()}
        out = orig(state, batch, cfg, tc, phase)
        with torch.no_grad():
            for k, v in state.head.items():
                v.copy_(2 * before[k] - v)
        return out

    monkeypatch.setattr(ts, "train_step", negated)
    line = _run(tmp_path)
    checks = line["checks"]
    assert not line["correct"] and checks["change_diff"]["value"] == pytest.approx(2.0, rel=0.05)
    assert checks["change_gap"]["value"] < 0.1      # the norms barely see it


def test_a_gradient_with_the_wrong_sign_is_not_correct(tmp_path, monkeypatch):
    """The first gradient negated as the optimizer gets it (and so every
    update reversed): the gradient's difference reads 2."""
    from video_depth_anything_torch.training import train_state as ts

    orig = ts.train_step

    def negated(state, batch, cfg, tc, phase=None):
        step = state.opt.step

        def reversed_step(*a, **k):
            for p in state.head.values():
                if p.grad is not None:
                    p.grad.neg_()
            return step(*a, **k)

        state.opt.step = reversed_step
        try:
            return orig(state, batch, cfg, tc, phase)
        finally:
            state.opt.step = step

    monkeypatch.setattr(ts, "train_step", negated)
    line = _run(tmp_path)
    checks = line["checks"]
    assert not line["correct"] and checks["grad_diff"]["value"] == pytest.approx(2.0, rel=0.05)
    assert checks["grad_gap"]["value"] < LIMITS["grad_gap"]
