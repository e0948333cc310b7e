"""Fail-fast probe that the CUDA card answers, before the first real call.

The port's counterpart of the JAX package's ``utils/platform_env.py``
(``backend_unreachable``): a CUDA initialisation and one small launch run
in a daemon thread, joined within a budget, so that a card that hangs in
its driver stops an entry point with a message instead of a silent wait.
``run.py`` calls it first, with the budget in ``VDA_DEVICE_TIMEOUT``
(default 90 s; 0 skips the call).

A budget that is not positive is an error, not a pass: the JAX package's
retry loop breaks out with no error when its deadline has already gone.
"""
from __future__ import annotations

import threading


def _cuda_probe() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    x = torch.ones(8, device="cuda")
    if float((x + 1).sum()) != 16.0:
        raise RuntimeError("a launch on the card returned a wrong sum")


def device_unreachable(timeout_s: float, probe=None) -> str | None:
    """None when the probe (default: CUDA init and one launch) finishes
    within ``timeout_s`` seconds, else an error string: the probe's own
    error, its time running out, or a budget that is not positive."""
    if not timeout_s > 0:
        return f"device probe budget must be positive, got {timeout_s!r}"
    result: dict = {}

    def run():
        try:
            (probe or _cuda_probe)()
            result["ok"] = True
        except Exception as e:   # reported to the caller, which exits
            result["error"] = repr(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return f"device probe did not finish within {timeout_s:g} s (card or driver hung?)"
    if "ok" not in result:
        return result.get("error", "device probe ended without a result")
    return None
