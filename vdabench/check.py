"""The numbers that decide ``correct``: what the timed path returned for a
clip against the reference's answer for the same clip.

Each number is taken per clip and the worst clip of the sample is kept:

- ``max_err_pct``: the largest |program - reference| depth as a
  percentage of the reference's depth range (max - min) over the clip;
- ``mean_err_pct``: the mean |program - reference| depth, as a percentage
  of the same range;
- ``tap_err_pct``: the encoder's four taps (patch tokens and class token
  after the final norm) of a few frames of the clip's first window, as
  the timed path's ``encode`` returned them: the largest over the taps
  of ||program - reference|| / ||reference||, in %. The depth passes
  through the head's bf16 convolutions and resizes, which carry most of
  its error in every precision; the taps see the encoder's products
  alone, where a lower-precision path (int8) shows;
- ``branch_err_pct``: the attention and the MLP of the encoder's blocks
  at the taps, each on its own: the largest over them of ||program -
  reference|| / ||reference|| of the module's output for the first frame
  of the first window, as the timed path computed it, against the
  reference's module on the same input (``branch_errs_pct``). The
  reference follows the program there from the program's own state;
  ``tap_err_pct`` holds the whole encoder from the frames.

No alignment: the program and the reference stitch the same windows, so
a scale or a shift between them is an error too.
"""
from __future__ import annotations

import statistics

import torch

NAMES = ("max_err_pct", "mean_err_pct", "tap_err_pct", "branch_err_pct")


@torch.no_grad()
def clip_numbers(program: torch.Tensor, reference: torch.Tensor) -> dict[str, float]:
    """program, reference: [N, H, W] float32 on one device."""
    ref = reference.double()
    rng = float(ref.max() - ref.min())
    err = (program.double() - ref).abs()
    return {"max_err_pct": 100.0 * float(err.max()) / rng,
            "mean_err_pct": 100.0 * float(err.mean()) / rng}


@torch.no_grad()
def tap_errs_pct(program, reference) -> list[float]:
    """program, reference: per tap (patch tokens [n, P, D], cls [n, D]) of
    the same frames -> each tap's ||program - reference|| / ||reference||,
    in %."""
    out = []
    for (pt, pc), (rt, rc) in zip(program, reference, strict=True):
        got = torch.cat([pt.double().flatten(), pc.double().flatten()])
        want = torch.cat([rt.double().flatten(), rc.double().flatten()]).to(got.device)
        out.append(100.0 * float(torch.linalg.vector_norm(got - want)
                                 / torch.linalg.vector_norm(want)))
    return out


def tap_err_pct(program, reference) -> float:
    """The largest of ``tap_errs_pct``."""
    return max(tap_errs_pct(program, reference))


@torch.no_grad()
def branch_errs_pct(rows: dict, reference) -> dict[str, float]:
    """rows: {module name under ``pretrained``: (input, output)} of the
    program's encoder -> {name: ||output - ref(input)|| / ||ref(input)||, in
    %}: each module's own error, the reference's module (float32) run on
    the program's input."""
    out = {}
    for name, (x, y) in rows.items():
        mod = reference.pretrained.get_submodule(name)
        dev = next(mod.parameters()).device
        want = mod(x.to(dev, torch.float32)).double()
        out[name] = 100.0 * float(torch.linalg.vector_norm(y.to(dev).double() - want)
                                  / torch.linalg.vector_norm(want))
    return out


def worst(per_clip: list[dict]) -> dict[str, float]:
    return {k: max(d[k] for d in per_clip) for k in per_clip[0]}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}}); a
    number that is not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        out[name] = {"value": v, "limit": limit}
        ok = ok and v == v and v <= limit
    return ok, out


def train_numbers(got: dict, want: dict, floor: float = 1e-3) -> dict[str, float]:
    """The train cell's numbers, the program (``got``) against the
    reference (``want``), each {"losses": [...], "grads": {leaf: the first
    gradient}, "change": {leaf: its change over the first steps}} (host
    tensors):

    - ``first_loss_gap``: |loss - reference loss| / |reference loss| at the
      first step; ``loss_gap``: the largest over the first steps (after the
      first update the bf16 forward no longer sees every change of the
      fp32 masters that the reference sees). A cell holds a number only
      where its ``limits`` name it: the bf16 train cell holds neither, as
      the lower-precision control does not read 3x the program on either
      (PERF.md);
    - ``grad_gap``, ``change_gap``: over the head's tensors, the largest
      |norm - reference norm| over the larger of that tensor's reference
      norm and the median tensor's;
    - ``grad_diff``, ``change_diff``: the same with the norm of the
      difference, ||program - reference||, which also sees a gradient or
      an update with the wrong sign or in the wrong place.

    The change's numbers leave out the tensors whose reference gradient is
    under ``floor`` of the median tensor's: AdamW moves those by round-off
    alone.
    """
    gaps = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    def worst_leaf(a, b, keys):
        ref = {k: norm(b[k]) for k in keys}
        med = statistics.median(ref.values())
        gap = max(abs(norm(a[k]) - ref[k]) / max(ref[k], med) for k in keys)
        diff = max(norm(a[k].double() - b[k].double()) / max(ref[k], med) for k in keys)
        return gap, diff

    gref = {k: norm(g) for k, g in want["grads"].items()}
    gmed = statistics.median(gref.values())
    grad_gap, grad_diff = worst_leaf(got["grads"], want["grads"], list(gref))
    moved = [k for k, v in gref.items() if v >= floor * gmed]
    change_gap, change_diff = worst_leaf(got["change"], want["change"], moved)
    return {"first_loss_gap": gaps[0], "loss_gap": max(gaps), "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_diff": grad_diff, "change_diff": change_diff}
