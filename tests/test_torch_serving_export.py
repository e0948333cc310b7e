"""The port's serving artifact (``utils/serving_export.py``) on the CPU.

A toy model (ViTConfig(64, depth 2, 2 heads), features 32, taps 0, 0, 1,
1: the JAX package's tests/test_serving_export.py config) with
``perturbed_params`` weights exports its window program at 42x56 frames,
input 28, through ``torch.export`` on the CPU. Its head dim is 32, so the
spatial attention op routes to K4's plain version.

Held: the fp32 artifact against the JAX package's ``build_window_fn`` on
the same weights (crossed through ``convert.state_dict_from_params``) at
rtol = atol = 1e-4; the artifact against the port's live program
(``PlainWindows``) bit for bit after a save / load round trip, and again
after a second export in the same process (a trace may not leave a fake
tensor in the resize or normalisation caches: the regression test of that
fault); the int8 artifact against the pipeline's int8 program bit for bit,
and ``quantize_for_serving`` against ``VideoDepthPipeline.quantized_model``;
bf16 at C = 2 against live; the graph's ``vda::`` nodes against the blocks
and motion modules run; the metadata; a model split over a model axis
refused; ``torch.library.opcheck`` on each served op's CPU implementation;
the export tool's ``--verify`` on the CPU and its exit without a card.
"""
import copy
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_tpu.config import ModelConfig as JModelConfig
from video_depth_anything_tpu.config import ViTConfig as JViTConfig
from video_depth_anything_tpu.utils import serving_export as jse
from video_depth_anything_torch import kernels
from video_depth_anything_torch.config import ModelConfig, ViTConfig
from video_depth_anything_torch.convert import model_from_params, state_dict_from_params
from video_depth_anything_torch.ops import resize
from video_depth_anything_torch.pipeline import VideoDepthPipeline, preprocess
from video_depth_anything_torch.pipeline.infer import PlainWindows
from video_depth_anything_torch.utils import serving_export as se

from test_torch_model import perturbed_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
INPUT = 28
SRC = (42, 56)
J_CFG = JModelConfig(encoder="_tinytorchexport",
                     vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2),
                     features=32, out_channels=(32, 32, 32, 32), num_frames=32,
                     taps=(0, 0, 1, 1))
T_CFG = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=64, depth=2, num_heads=2),
                    features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
NET = se.geometry(SRC, INPUT)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads beside the JAX CPU client (test_torch_streaming.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    return perturbed_params(J_CFG)


@pytest.fixture(scope="module")
def model(params):
    return model_from_params(params, T_CFG)


def _window(c=1, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(c, 32, *SRC, 3), dtype=np.uint8)


def _live(model, win, dtype):
    """The pipeline's plain mode on one chunk: the live window program."""
    frames = torch.from_numpy(win)
    return PlainWindows(model, NET, SRC, dtype)(frames.reshape(-1, *frames.shape[2:]), None,
                                                win.shape[0])


@pytest.fixture(scope="module")
def fp32_artifact(tmp_path_factory):
    ep = se.export_window_program(T_CFG, SRC, input_size=INPUT, fp32=True, device="cpu")
    path = str(tmp_path_factory.mktemp("artifact") / "window.pt2")
    se.save_exported(ep, path, {"encoder": "toy"})
    return ep, path


def test_fp32_artifact_matches_jax_window_fn(params, fp32_artifact):
    win = _window()
    fn = jax.jit(jse.build_window_fn(J_CFG, NET, SRC, jnp.float32, 1))
    want = np.asarray(fn(jax.tree.map(jnp.asarray, params), win))
    state = se.cast_params(state_dict_from_params(params, J_CFG.vit.depth), fp32=True)
    got = se.artifact_module(se.load_exported(fp32_artifact[1]))(state, torch.from_numpy(win))
    assert got.shape == (1, 32, *SRC) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_artifact_equals_live_program_after_a_round_trip(model, fp32_artifact):
    win = _window(seed=2)
    state = se.cast_params(model.state_dict(), fp32=True)
    run = se.artifact_module(se.load_exported(fp32_artifact[1], device="cpu"))
    got = run(state, torch.from_numpy(win))
    assert torch.equal(got, _live(model, win, torch.float32))


def test_an_export_leaves_the_live_program_untouched(model):
    """Regression: a trace through the per-device caches of the resize
    matrices and the ImageNet constants once cached its fake tensors, and
    the next live call returned a FakeTensor."""
    resize._cached_matrix.cache_clear()
    preprocess._cached_imagenet.cache_clear()
    win = _window(seed=3)
    ep = se.export_window_program(T_CFG, SRC, input_size=INPUT, fp32=True, device="cpu")
    live = _live(model, win, torch.float32)
    assert type(live) is torch.Tensor
    assert all(type(t) is torch.Tensor for t in preprocess._imagenet(torch.device("cpu")))
    state = se.cast_params(model.state_dict(), fp32=True)
    got = se.artifact_module(ep)(state, torch.from_numpy(win))
    assert torch.equal(got, live)


def test_graph_reaches_the_kernels_through_their_custom_ops(fp32_artifact):
    """One vda::spatial_attention per encoder block run (up to the last
    tap), one vda::temporal_attention per attention block of the four
    motion modules; no attention in plain aten."""
    ep = fp32_artifact[0]
    blocks = max(T_CFG.intermediate_layer_idx) + 1
    temporal = 4 * T_CFG.num_transformer_block * T_CFG.num_attention_blocks
    assert se.vda_op_counts(ep) == {"spatial_attention": blocks, "temporal_attention": temporal}
    ops = se.op_counts(ep)
    assert ops["vda.spatial_attention.default"] == blocks
    assert sum(ops.values()) == sum(n.op == "call_function" for n in ep.graph.nodes)
    assert not any("softmax" in t or "scaled_dot_product" in t for t in ops), ops


def test_metadata_and_no_weights_in_the_file(model, fp32_artifact):
    ep, path = fp32_artifact
    meta = json.load(open(path + ".json"))
    assert meta["format"] == se.FORMAT == "vda-torch-window-program-v1"
    assert meta["device"] == "cpu" and meta["encoder"] == "toy"
    assert meta["bytes"] == os.path.getsize(path)
    assert meta["vda_ops"] == se.vda_op_counts(ep)
    assert "win_u8 [C, 32, H, W, 3] uint8" in meta["input"]
    assert meta["output"] == "depth [C, 32, H, W] float32"
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    assert os.path.getsize(path) < weights
    assert ep.example_inputs is None
    # Only the constants: the window's buffers and the lifted resize matrices.
    held = {**ep.state_dict, **ep.constants}
    assert not set(held) & set(model.state_dict())
    assert sum(t.numel() for t in held.values()) < 0.05 * sum(
        t.numel() for t in model.state_dict().values())


def test_int8_state_dict_equals_the_pipelines(model):
    win = _window(seed=4)
    for fp32 in (True, False):
        dtype = se.serving_dtype(fp32)
        pipe = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8")
        want = pipe.quantized_model(win[0], NET, dtype).state_dict()
        got = se.quantize_for_serving(model, win, T_CFG, NET, fp32=fp32)
        assert list(got) == list(want)
        assert any(t.dtype == torch.int8 for t in got.values())
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_int8_artifact_equals_the_pipelines_int8_program(model, tmp_path):
    win = _window(seed=5)
    ep = se.export_window_program(T_CFG, SRC, input_size=INPUT, device="cpu", quant="int8")
    assert se.vda_op_counts(ep) == {"spatial_attention_qk8": 2, "temporal_attention": 8}
    path = se.save_exported(ep, str(tmp_path / "int8.pt2"))
    state = se.quantize_for_serving(model, win, T_CFG, NET)
    got = se.artifact_module(se.load_exported(path))(state, torch.from_numpy(win))
    pipe = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8")
    live = _live(pipe.quantized_model(win[0], NET, torch.bfloat16), win, torch.bfloat16)
    assert torch.equal(got, live)


def test_bf16_two_windows_per_call(model):
    win = _window(c=2, seed=6)
    ep = se.export_window_program(T_CFG, SRC, input_size=INPUT, windows_per_batch=2,
                                  device="cpu")
    got = se.artifact_module(ep)(se.cast_params(model.state_dict()), torch.from_numpy(win))
    assert got.shape == (2, 32, *SRC) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    live = _live(copy.deepcopy(model).to(torch.bfloat16), win, torch.bfloat16)
    assert torch.equal(got, live)


def test_a_model_split_over_a_model_axis_is_refused(model):
    from video_depth_anything_torch.parallel.mesh import split_params
    from video_depth_anything_torch.parallel.tensor import ModelAxis

    split = split_params(copy.deepcopy(model), ModelAxis(None, 2, 0))
    with pytest.raises(ValueError, match="model axis"):
        se.export_window_program(T_CFG, SRC, input_size=INPUT, device="cpu", model=split)


def _opcheck_cases():
    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    qkv = randn(2, 10, 3 * 128)
    q, k, v = qkv.split(128, dim=-1)                     # column views, row stride 3C
    q8 = torch.randint(-127, 128, (2, 10, 128), generator=g, dtype=torch.int8)
    heads = [t.unflatten(-1, (4, 32)).transpose(1, 2) for t in (q, k, v)]
    w = randn(3, 3, 128, 128) * 0.05
    return {
        "spatial_attention": (kernels.spatial_attention.spatial_attention_op,
                              (q, k, v, 2, 0.125, False, False)),
        "spatial_attention dh 32 (K4 route)": (kernels.spatial_attention.spatial_attention_op,
                                               (q, k, v, 4, 32 ** -0.5, False, False)),
        "spatial_attention_qk8": (kernels.spatial_attention_qk8.spatial_attention_qk8_op,
                                  (q8, q8.flip(1), v, torch.tensor([0.002, 0.01]), 2)),
        "temporal_attention": (kernels.temporal_attention.temporal_attention_op,
                               (randn(6, 4, 64), randn(6, 4, 64), randn(6, 4, 64), 2, 0.18)),
        "spatial_attention_qkv_fused": (
            kernels.spatial_attention_qkv.spatial_attention_qkv_fused_op, (qkv, 2, False)),
        "attention_head_major": (kernels.attention_head_major.attention_head_major_op,
                                 (*heads, 32 ** -0.5, False)),
        "fused_rcu": (kernels.fused_rcu.fused_rcu_op,
                      (randn(1, 3, 8, 128), w, randn(128), w.flip(0), randn(128))),
    }


@pytest.mark.parametrize("case", list(_opcheck_cases()))
def test_opcheck_on_the_cpu_implementation(case):
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


def test_load_imports_no_model_code(fp32_artifact):
    code = (f"import sys\nfrom video_depth_anything_torch.utils import serving_export as se\n"
            f"se.load_exported({fp32_artifact[1]!r})\n"
            f"bad = [m for m in sys.modules if m.startswith(('video_depth_anything_torch.models',"
            f" 'video_depth_anything_torch.pipeline', 'jax', 'video_depth_anything_tpu'))]\n"
            f"assert not bad, bad\nprint('OK')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=ENV, timeout=300)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr


def test_export_tool_verifies_on_the_cpu(tmp_path):
    out = tmp_path / "vits.pt2"
    cmd = [sys.executable, "-m", "video_depth_anything_torch.tools.export_serving",
           "--encoder", "vits", "--src_hw", "30", "40", "--input_size", "28", "--int8",
           "--device", "cpu", "--output", str(out), "--verify"]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "verify: artifact output == live program (bit-exact)" in res.stdout
    meta = json.load(open(str(out) + ".json"))
    assert meta["quant"] == "int8" and meta["device"] == "cpu" and meta["src_hw"] == [30, 40]
    assert meta["vda_ops"] == {"spatial_attention_qk8": 12, "temporal_attention": 8}


def test_export_tool_without_a_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, "-m", "video_depth_anything_torch.tools.export_serving",
           "--encoder", "vits", "--src_hw", "30", "40", "--output", str(tmp_path / "x.pt2")]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env={**ENV, "VDA_DEVICE_TIMEOUT": "0"}, timeout=300)
    assert res.returncode != 0 and "--device cpu" in res.stderr
    assert not (tmp_path / "x.pt2").exists()


def test_bench_tool_exits_without_a_card():
    from video_depth_anything_torch.tools import bench_serving_artifact

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_serving_artifact.main(["--encoder", "vits", "--iters", "1"]) == 2


def test_bench_tool_takes_the_input_size(monkeypatch, capsys):
    """``--input_size`` (the JAX tool's, default 518) reaches ``measure``,
    which exports and times at the pipeline's network size for it."""
    from video_depth_anything_torch.kernels import build
    from video_depth_anything_torch.tools import bench_serving_artifact as tool

    assert tool.parse_args([]).input_size == 518
    seen = {}

    def measure(*args, **kw):
        seen.update(args=args, kw=kw)
        return {"metric": f"{args[0]}_serving_artifact_{kw['input_size']}"}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "build_all", lambda: None)
    monkeypatch.setattr(tool, "measure", measure)
    assert tool.main(["--encoder", "vits", "--src_hw", "480", "640", "--input_size", "280"]) == 0
    assert seen["args"][:2] == ("vits", [480, 640]) and seen["kw"]["input_size"] == 280
    assert json.loads(capsys.readouterr().out)["metric"] == "vits_serving_artifact_280"
    assert se.geometry((480, 640), 280) == (280, 378)
