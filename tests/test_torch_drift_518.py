"""vitl at the serving shape, the port against the JAX package on shared
weights, on the CPU (marked ``slow``: tier-1 leaves it out).

    python -m pytest -m slow tests/test_torch_drift_518.py -s
    XLA_FLAGS=--xla_allow_excess_precision=false \\
        python -m pytest -m slow tests/test_torch_drift_518.py -s -k bf16

Both packages load ``models/video_depth.py::numpy_state_dict(vitl, S)``:
the port with ``load_state_dict(strict=True)``, JAX through its own
``utils/torch_convert.py::convert_torch_state_dict``. The weights' SHA-256
is pinned for each seed, so a card reading of ``tools/bench_drift_518.py
--numpy_weights S`` can be shown to use these weights. One video,
``synthetic_video(32, (644, 644), 3)`` (two windows) at input size 518,
runs through both packages' fp32 pipelines once per seed (a module-scoped
fixture; JAX with ``use_pallas=False``). Held: port fp32 within 1e-3 of
the depth range of JAX fp32.

The int8 test (seed 0) runs JAX int8 (fp32 activations, calibrated on the
first window, its side file written) and the port's CPU int8 on JAX's side
file (identical scales), once more with every absmax scaled by 1 + 1e-6
(the flip floor, as tests/test_torch_quant.py holds the vits pipeline).
Held: port int8 within twice the flip floor of JAX int8
(``utils/precision.py::flip_floor_report``). At this width the floor is as
large as int8's whole effect: the 1e-6 nudge alone moves the port's int8
depths by 8.5 % of the range at the worst pixel (mean 0.15 %), past the
int8 budget's 8 % by itself, so the floor is not capped at the budget
(``cap=False``, as chip_smoke.py holds vitg's 4-block cut).

The bf16 test (seeds 0 and 2) runs both packages' bf16 pipelines, the
serving default. Held: the port's bf16 drift from its own fp32 is at most
1.25 times JAX's bf16 drift from JAX's fp32, in the max and the mean of
``precision_drift_report`` (tests/test_torch_vitg.py's rule). Reported
beside it: the port's bf16 three more times with the JAX package's
rounding at the two points where the port rounds otherwise on purpose,
patched in for the run only: (a) the softmax denominator summing the
probabilities after their rounding to bf16 (``spatial_attention`` with
``mxu_denom=True``), (b) the output head's 3x3 conv to 32 accumulated in
fp32 with its bias added before the one rounding to bf16
(``Scratch.head_conv2a``), (c) both. XLA on the CPU keeps fp32 inside a
fusion unless ``--xla_allow_excess_precision=false``; the JSON line names
the ``XLA_FLAGS`` it ran under. The test holds under the default flags.

Each test prints one JSON line: the drifts, the comparisons and each run's
seconds. Each vitl run over the two windows takes 5-7 min and the whole
file about 22 GiB of host memory at the peak on an 8-core CPU; run it
alone (PERF.md gives each run's seconds).
"""
import functools
import json
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from video_depth_anything_tpu.config import get_model_config as j_config
from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
from video_depth_anything_tpu.utils.precision import precision_drift_report
from video_depth_anything_tpu.utils.torch_convert import convert_torch_state_dict
from video_depth_anything_torch.config import get_model_config as t_config
from video_depth_anything_torch.kernels.spatial_attention import spatial_attention
from video_depth_anything_torch.models import (build_model, dinov2, load_numpy_state_dict,
                                               numpy_state_dict, state_dict_sha256)
from video_depth_anything_torch.models.dpt import Scratch
from video_depth_anything_torch.ops import nn as vnn
from video_depth_anything_torch.pipeline import VideoDepthPipeline
from video_depth_anything_torch.pipeline.infer import scale_side_file
from video_depth_anything_torch.utils.precision import flip_floor_report, synthetic_video

pytestmark = pytest.mark.slow

# state_dict_sha256(numpy_state_dict(get_model_config("vitl"), 0)).
WEIGHTS_SHA256 = "2897b7e0cd8e4a13d10e86506b39ef0c9e7dd3fd661ed1f9c3a66086f1610e8c"
# The same for each seed the tests run: 0, which chip_smoke.py holds, and 2,
# the card's largest bf16 mean drift of seeds 0-3.
SEED_SHA256 = {0: WEIGHTS_SHA256,
               2: "43ffd9b0cd56bfdb5a30f2002d8eb2f12ef56829aa787170f59c57cd571a5f40"}
FRAMES, SRC_HW, VIDEO_SEED, INPUT_SIZE = 32, (644, 644), 3, 518
FP32_TOL = 1e-3          # of the depth range: the same function, other sums
BF16_RATIO = 1.25        # the port's bf16 drift over JAX's, max and mean


def _drift(rep):
    return {k: rep[k] for k in ("max_err_frac", "mean_err_frac")}


def _timed(secs, name, fn):
    t0 = time.perf_counter()
    out = np.asarray(fn()[0])
    secs[name] = round(time.perf_counter() - t0, 1)
    assert out.shape == (FRAMES, *SRC_HW) and np.isfinite(out).all(), name
    return out


@pytest.fixture(scope="module", params=sorted(SEED_SHA256))
def shared(request):
    """One seed's weights in both packages, the video, and both fp32 runs."""
    seed = request.param
    cfg, jcfg = t_config("vitl"), j_config("vitl")
    sd = numpy_state_dict(cfg, seed)
    assert state_dict_sha256(sd) == SEED_SHA256[seed]
    frames = synthetic_video(FRAMES, SRC_HW, VIDEO_SEED)
    kw = dict(input_size=INPUT_SIZE, fp32=True)
    secs = {}
    model = load_numpy_state_dict(build_model(cfg), sd)
    t32 = _timed(secs, "port_fp32", lambda: VideoDepthPipeline(cfg, model, device="cpu")
                 .infer_video_depth(frames, **kw))
    params = convert_torch_state_dict(sd, jcfg)
    del sd
    j32 = _timed(secs, "jax_fp32", lambda: JaxPipeline(jcfg, params, use_pallas=False)
                 .infer_video_depth(frames, **kw))
    jax.clear_caches()
    yield SimpleNamespace(seed=seed, cfg=cfg, jcfg=jcfg, model=model, params=params,
                          frames=frames, t32=t32, j32=j32, secs=secs)
    jax.clear_caches()


@pytest.mark.parametrize("shared", [0], indirect=True)
def test_vitl_518_port_matches_jax_on_shared_weights(shared, tmp_path):
    cfg, jcfg, model, params = shared.cfg, shared.jcfg, shared.model, shared.params
    frames, t32, j32 = shared.frames, shared.t32, shared.j32
    kw = dict(input_size=INPUT_SIZE, fp32=True)
    secs = dict(shared.secs)
    side = str(tmp_path / "jax.int8calib.npz")
    j8 = _timed(secs, "jax_int8", lambda: JaxPipeline(
        jcfg, params, use_pallas=False, quant="int8", calib_path=side).infer_video_depth(frames,
                                                                                        **kw))
    jax.clear_caches()
    t8 = _timed(secs, "port_int8", lambda: VideoDepthPipeline(
        cfg, model, device="cpu", quant="int8", calib_path=side).infer_video_depth(frames, **kw))
    nudged = str(tmp_path / "nudged.int8calib.npz")
    scale_side_file(side, nudged, 1 + 1e-6)
    floor = _timed(secs, "port_int8_nudged", lambda: VideoDepthPipeline(
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


_PORT_HEAD_CONV2A = Scratch.head_conv2a


def _jax_island(self, x, island):
    """``Scratch.head_conv2a`` in the JAX package's mixed island
    (models/dpt.py): the bf16 map and weight multiplied and summed in fp32
    (exact products), the fp32 bias and the ReLU, then one rounding."""
    if island:
        return _PORT_HEAD_CONV2A(self, x, island)
    c2a = self.output_conv2[0]
    out = vnn.conv2d(x.float(), c2a.weight.float(), None, padding=1)
    return torch.relu(out + c2a.bias.float()).to(torch.bfloat16)


# The port's bf16 with the JAX package's rounding at one point, or both.
VARIANTS = {
    "jax_denominator": [(dinov2, "spatial_attention",
                         functools.partial(spatial_attention, mxu_denom=True))],
    "jax_island": [(Scratch, "head_conv2a", _jax_island)],
}
VARIANTS["both"] = VARIANTS["jax_denominator"] + VARIANTS["jax_island"]


def test_vitl_518_bf16_drift_within_jax_on_shared_weights(shared, monkeypatch):
    cfg, frames, t32, j32 = shared.cfg, shared.frames, shared.t32, shared.j32
    kw = dict(input_size=INPUT_SIZE, fp32=False)
    secs = dict(shared.secs)
    j16 = _timed(secs, "jax_bf16", lambda: JaxPipeline(
        shared.jcfg, shared.params, use_pallas=False).infer_video_depth(frames, **kw))
    jax.clear_caches()
    pipe = VideoDepthPipeline(cfg, shared.model, device="cpu")
    t16 = _timed(secs, "port_bf16", lambda: pipe.infer_video_depth(frames, **kw))
    variants = {}
    for name, patches in VARIANTS.items():
        with monkeypatch.context() as mp:
            for owner, attr, fn in patches:
                mp.setattr(owner, attr, fn)
            out = _timed(secs, f"port_bf16_{name}", lambda: pipe.infer_video_depth(frames, **kw))
        variants[name] = _drift(precision_drift_report(out, t32))
    jrep = _drift(precision_drift_report(j16, j32))
    trep = _drift(precision_drift_report(t16, t32))
    fp32_err = float(np.abs(t32 - j32).max() / np.ptp(j32))
    print(json.dumps({
        "seed": shared.seed, "weights_sha256": SEED_SHA256[shared.seed],
        "xla_flags": os.environ.get("XLA_FLAGS", ""), "frames": FRAMES,
        "src_hw": list(SRC_HW), "input_size": INPUT_SIZE,
        "jax_bf16_vs_fp32": jrep, "port_bf16_vs_fp32": trep,
        "ratio": {k: trep[k] / jrep[k] for k in trep},
        "port_bf16_vs_jax_bf16": _drift(precision_drift_report(t16, j16)),
        "port_bf16_variants_vs_fp32": variants, "port_fp32_vs_jax_fp32": fp32_err,
        "seconds": secs, "torch_threads": torch.get_num_threads()}), flush=True)
    assert fp32_err < FP32_TOL, fp32_err
    for k in trep:
        assert trep[k] <= BF16_RATIO * jrep[k], (k, trep, jrep)
