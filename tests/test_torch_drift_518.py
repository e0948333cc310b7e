"""vitl at the serving shape, the port against the JAX package on shared
weights, on the CPU (marked ``slow``: tier-1 leaves it out).

    python -m pytest -m slow tests/test_torch_drift_518.py -s

Both packages load ``models/video_depth.py::numpy_state_dict(vitl, 0)``:
the port with ``load_state_dict(strict=True)``, JAX through its own
``utils/torch_convert.py::convert_torch_state_dict``. The weights' SHA-256
is pinned, so a card reading of ``tools/bench_drift_518.py
--numpy_weights 0`` can be shown to use these weights. One video,
``synthetic_video(32, (644, 644), 3)`` (two windows) at input size 518,
runs through the JAX pipeline (``use_pallas=False``) in fp32 and in int8
(fp32 activations, calibrated on the first window, its side file written),
and through the port's CPU pipeline in fp32 and in int8 on JAX's side file
(identical scales), once more with every absmax scaled by 1 + 1e-6 (the
flip floor, as tests/test_torch_quant.py holds the vits pipeline). Held:
port fp32 within 1e-3 of the depth range of JAX fp32, port int8 within
twice the flip floor of JAX int8 (``utils/precision.py::flip_floor_report``).
At this width the floor is as large as int8's whole effect: the 1e-6
nudge alone moves the port's int8 depths by 8.5 % of the range at the
worst pixel (mean 0.15 %), past the int8 budget's 8 % by itself, so the
floor is not capped at the budget (``cap=False``, as chip_smoke.py holds
vitg's 4-block cut). It prints one JSON line: both packages' int8 drift
from their own fp32 (``precision_drift_report``), the comparisons, and
each run's seconds. About 11 vitl window forwards in fp32: 30 min and
22.4 GiB of host memory at the peak on an 8-core CPU; run it alone.
"""
import json
import time

import jax
import numpy as np
import pytest
import torch

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
from video_depth_anything_tpu.utils.precision import precision_drift_report
from video_depth_anything_tpu.utils.torch_convert import convert_torch_state_dict
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.models import (build_model, load_numpy_state_dict,
                                               numpy_state_dict, state_dict_sha256)
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.pipeline.infer import scale_side_file
from video_depth_anything_torch.utils.precision import flip_floor_report, synthetic_video

pytestmark = pytest.mark.slow

# state_dict_sha256(numpy_state_dict(get_model_config("vitl"), 0)).
WEIGHTS_SHA256 = "2897b7e0cd8e4a13d10e86506b39ef0c9e7dd3fd661ed1f9c3a66086f1610e8c"
FRAMES, SRC_HW, VIDEO_SEED, INPUT_SIZE = 32, (644, 644), 3, 518
FP32_TOL = 1e-3          # of the depth range: the same function, other sums


def _drift(rep):
    return {k: rep[k] for k in ("max_err_frac", "mean_err_frac")}


def test_vitl_518_port_matches_jax_on_shared_weights(tmp_path):
    cfg, jcfg = t_config("vitl"), j_config("vitl")
    sd = numpy_state_dict(cfg, 0)
    assert state_dict_sha256(sd) == WEIGHTS_SHA256
    frames = synthetic_video(FRAMES, SRC_HW, VIDEO_SEED)
    kw = dict(input_size=INPUT_SIZE, fp32=True)
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = np.asarray(fn()[0])
        secs[name] = round(time.perf_counter() - t0, 1)
        assert out.shape == (FRAMES, *SRC_HW) and np.isfinite(out).all(), name
        return out

    model = load_numpy_state_dict(build_model(cfg), sd)
    t32 = timed("port_fp32", lambda: VideoDepthPipeline(cfg, model, device="cpu")
                .infer_video_depth(frames, **kw))
    params = convert_torch_state_dict(sd, jcfg)
    del sd
    j32 = timed("jax_fp32", lambda: JaxPipeline(jcfg, params, use_pallas=False)
                .infer_video_depth(frames, **kw))
    side = str(tmp_path / "jax.int8calib.npz")
    j8 = timed("jax_int8", lambda: JaxPipeline(jcfg, params, use_pallas=False, quant="int8",
                                               calib_path=side).infer_video_depth(frames, **kw))
    del params
    jax.clear_caches()
    t8 = timed("port_int8", lambda: VideoDepthPipeline(
        cfg, model, device="cpu", quant="int8", calib_path=side).infer_video_depth(frames, **kw))
    nudged = str(tmp_path / "nudged.int8calib.npz")
    scale_side_file(side, nudged, 1 + 1e-6)
    floor = timed("port_int8_nudged", lambda: VideoDepthPipeline(
        cfg, model, device="cpu", quant="int8", calib_path=nudged).infer_video_depth(frames,
                                                                                    **kw))
    fp32_err = float(np.abs(t32 - j32).max() / np.ptp(j32))
    flips = flip_floor_report(j8, t8, floor, cap=False)
    print(json.dumps({
        "weights_sha256": WEIGHTS_SHA256, "frames": FRAMES, "src_hw": list(SRC_HW),
        "input_size": INPUT_SIZE,
        "jax_int8_vs_fp32": _drift(precision_drift_report(j8, j32)),
        "port_int8_vs_fp32": _drift(precision_drift_report(t8, t32)),
        "port_fp32_vs_jax_fp32": fp32_err, "int8_flip_floor": flips,
        "seconds": secs, "torch_threads": torch.get_num_threads()}), flush=True)
    assert fp32_err < FP32_TOL, fp32_err
    assert flips["ok"], flips
