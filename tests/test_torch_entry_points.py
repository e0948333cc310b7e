"""The port's small entry points against their JAX counterparts, on the CPU:
the inverse converter (``convert.params_from_state_dict``), the three
checkpoint tools (``video_depth_anything_torch/tools/convert_checkpoint.py``,
``export_checkpoint.py``, ``validate_checkpoint.py``) beside the root
``tools/`` ones, and ``app.process_video`` beside the root ``app.py``.

The tools resolve the encoder name to a full-size config; both packages'
``get_model_config`` are patched to a toy of the same name
(ViTConfig(64, depth 2, 2 heads), features 32, taps 0, 0, 1, 1), so the
chain runs in seconds. Files are compared key for key and bit for bit;
trees leaf for leaf, bit for bit; the validators' reports check for check
(name and verdict); process_video's depths within 2e-4 (JAX's bound for
its pipeline against itself across devices, tests/test_distributed.py),
both pipelines patched to the same toy weights and to fp32 at input 28.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video_depth_anything_torch.config as tconfig
import video_depth_anything_tpu.config as jconfig
from video_depth_anything_tpu.models.video_depth import init_params
from video_depth_anything_tpu.utils import params_io as jparams_io
from video_depth_anything_tpu.utils import torch_convert
from video_depth_anything_torch import convert
from video_depth_anything_torch.models import build_model
from video_depth_anything_torch.utils import params_io
from video_depth_anything_torch.utils.tree import flatten_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT = 28
_KW = dict(features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
J_TOY = jconfig.ModelConfig(encoder="vits", vit_override=jconfig.ViTConfig(
    embed_dim=64, depth=2, num_heads=2), **_KW)
T_TOY = tconfig.ModelConfig(encoder="vits", vit_override=tconfig.ViTConfig(
    embed_dim=64, depth=2, num_heads=2), **_KW)
J_SWIGLU = jconfig.ModelConfig(encoder="vitg", vit_override=jconfig.ViTConfig(
    embed_dim=128, depth=2, num_heads=2, ffn_layer="swiglufused"), **_KW)
T_SWIGLU = tconfig.ModelConfig(encoder="vitg", vit_override=tconfig.ViTConfig(
    embed_dim=128, depth=2, num_heads=2, ffn_layer="swiglufused"), **_KW)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def toy_configs(monkeypatch):
    """Both packages' get_model_config give the toy for every known name
    (an unknown one still raises KeyError)."""
    def patched(module, toy):
        real = module.get_model_config

        def get(encoder, metric=False, **kw):
            real(encoder)
            return dataclasses.replace(toy, metric=metric, **kw)
        monkeypatch.setattr(module, "get_model_config", get)

    patched(jconfig, J_TOY)
    patched(tconfig, T_TOY)


def jax_tool(name):
    """The root tools/<name>.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_same_flat(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
        np.testing.assert_array_equal(v, b[k], err_msg=k)


def save_pth(path, jcfg, seed=0):
    torch_convert.save_torch_checkpoint(str(path), init_params(seed, jcfg), jcfg)
    return str(path)


# ------------------------------------------------------------------ the inverse converter


@pytest.mark.parametrize("which", ["vits", "swiglu_toy"])
def test_inverse_converter_equals_jax_and_round_trips(which):
    jcfg = jconfig.get_model_config("vits") if which == "vits" else J_SWIGLU
    tcfg = tconfig.get_model_config("vits") if which == "vits" else T_SWIGLU
    sd = torch_convert.export_torch_state_dict(init_params(0, jcfg), jcfg)
    ref = flatten_tree(np_tree(torch_convert.convert_torch_state_dict(sd, jcfg)))
    got = convert.params_from_state_dict(sd, jcfg.vit.depth)
    assert_same_flat(flatten_tree(got), ref)
    # The port's own state dict -> tree -> state dict is the identity.
    model_sd = build_model(tcfg, seed=1).state_dict()
    back = convert.state_dict_from_params(
        convert.params_from_state_dict(model_sd, tcfg.vit.depth), tcfg.vit.depth)
    assert sorted(back) == sorted(model_sd)
    for k, v in model_sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_params_io_round_trip_and_load_checkpoint(tmp_path):
    tree = np_tree(init_params(0, J_TOY))
    params_io.save_params(str(tmp_path / "p.npz"), tree)
    jparams_io.save_params(str(tmp_path / "j.npz"), tree)
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert_same_flat({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    pth = save_pth(tmp_path / "m.pth", J_TOY)
    assert_same_flat(flatten_tree(params_io.load_checkpoint(pth, T_TOY)),
                     flatten_tree(np_tree(jparams_io.load_checkpoint(pth, J_TOY))))


# ------------------------------------------------------------------ convert_checkpoint


def test_convert_checkpoint_tool_matches_jax_tool(tmp_path, toy_configs, monkeypatch, capsys):
    from video_depth_anything_torch.tools import convert_checkpoint

    pth = save_pth(tmp_path / "video_depth_anything_vits.pth", J_TOY)
    monkeypatch.setattr("sys.argv", ["convert_checkpoint.py", pth, "--out",
                                     str(tmp_path / "jax.npz")])
    jax_tool("convert_checkpoint").main()
    convert_checkpoint.main([pth])                    # the default output path
    out = str(tmp_path / "video_depth_anything_vits.npz")
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {out}"
    with np.load(out) as a, np.load(tmp_path / "jax.npz") as b:
        assert_same_flat({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    # The same refusals, in the same words.
    for args in (["/x/weights.pth"], ["/x/weights.pth", "--encoder", "vitx"]):
        monkeypatch.setattr("sys.argv", ["convert_checkpoint.py", *args])
        with pytest.raises(SystemExit) as je:
            jax_tool("convert_checkpoint").main()
        with pytest.raises(SystemExit) as te:
            convert_checkpoint.main(args)
        assert str(te.value) == str(je.value) and "pass --encoder" in str(te.value)


# ------------------------------------------------------------------ export_checkpoint


def test_export_checkpoint_reads_the_same_in_both_packages(tmp_path, toy_configs, capsys):
    from video_depth_anything_torch.tools import export_checkpoint
    from video_depth_anything_torch.training import checkpoint as ckpt
    from video_depth_anything_torch.training import train_state as ts

    cfg, jcfg = (dataclasses.replace(c, num_frames=4) for c in (T_TOY, J_TOY))
    model = convert.model_from_params(np_tree(init_params(0, jcfg)), cfg)
    state = ts.create_train_state(model, ts.TrainConfig(compute_dtype="float32"))
    rng = np.random.default_rng(0)
    batch = {"video": rng.standard_normal((1, 4, 28, 28, 3)).astype(np.float32),
             "gt": rng.random((1, 4, 28, 28)).astype(np.float32),
             "mask": np.ones((1, 4, 28, 28), np.float32)}
    state, _ = ts.train_step(state, batch, cfg, ts.TrainConfig(compute_dtype="float32"))
    ckpt.save_checkpoint(str(tmp_path), "best_checkpoint", state,
                         {"epoch": 3, "best_val_loss": 0.5, "trial": 0})
    out = str(tmp_path / "exported.npz")
    export_checkpoint.main([str(tmp_path), "--encoder", "vits", "--clip_len", "4",
                            "--out", out])
    assert capsys.readouterr().out.strip() == f"wrote {out} (epoch 3)"
    want = {k: v.detach() for k, v in state.model.state_dict().items()}
    # The port's loader ...
    loaded = convert.load_checkpoint(build_model(cfg), out).state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in want.items())
    # ... and the JAX package's, through its exporter to the same names.
    jsd = torch_convert.export_torch_state_dict(jparams_io.load_params(out), jcfg)
    assert sorted(jsd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(jsd[k]), v.numpy(), err_msg=k)
    with pytest.raises(SystemExit, match="no latest_checkpoint under"):
        export_checkpoint.main([str(tmp_path), "--name", "latest_checkpoint",
                                "--encoder", "vits", "--out", out])


# ------------------------------------------------------------------ validate_checkpoint


def _verdicts(report):
    return {k: v == "ok" for k, v in report["checks"].items()}


def test_validate_checkpoint_matches_jax_tool(tmp_path, toy_configs, capsys):
    from video_depth_anything_torch.tools import validate_checkpoint

    (tmp_path / "j").mkdir(), (tmp_path / "t").mkdir()
    jpth = save_pth(tmp_path / "j" / "video_depth_anything_vits.pth", J_TOY)
    tpth = save_pth(tmp_path / "t" / "video_depth_anything_vits.pth", J_TOY)
    jrep = jax_tool("validate_checkpoint").validate_one(jpth, input_size=INPUT)
    trep = validate_checkpoint.validate_one(tpth, input_size=INPUT, device="cpu")
    assert list(trep["checks"]) == list(jrep["checks"]) == [
        "load", "npz_roundtrip", "finite", "nonnegative", "bf16_budget"]
    assert _verdicts(trep) == _verdicts(jrep)
    assert set(trep) == set(jrep) and trep["ok"] == jrep["ok"]
    assert set(trep["bf16_drift"]) == set(jrep["bf16_drift"])
    with np.load(tmp_path / "t" / "video_depth_anything_vits.npz") as a, \
            np.load(tmp_path / "j" / "video_depth_anything_vits.npz") as b:
        assert_same_flat({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    # A checkpoint that does not load fails the same check in both.
    bad = tmp_path / "t" / "video_depth_anything_vitl.pth"
    torch.save({"pretrained.nothing": torch.zeros(1)}, bad)
    jbad = jax_tool("validate_checkpoint").validate_one(str(bad), input_size=INPUT)
    tbad = validate_checkpoint.validate_one(str(bad), input_size=INPUT, device="cpu")
    assert _verdicts(tbad) == _verdicts(jbad) == {"load": False} and not tbad["ok"]
    assert validate_checkpoint.validate_one("/x/model.pth")["error"] == (
        "cannot infer encoder from filename; pass --encoder")
    # main's exit code is 0 exactly when every check passed.
    with pytest.raises(SystemExit) as e:
        validate_checkpoint.main([tpth, "--input_size", str(INPUT), "--device", "cpu"])
    assert e.value.code == (0 if trep["ok"] else 1)
    assert '"checks"' in capsys.readouterr().out


# ------------------------------------------------------------------ app.process_video


def test_process_video_matches_jax_app(tmp_path, monkeypatch):
    from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline
    from video_depth_anything_tpu.utils import video_io as jvio
    from video_depth_anything_torch import app as tapp
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.utils import video_io as tvio
    from video_depth_anything_torch.utils.precision import synthetic_video

    spec = importlib.util.spec_from_file_location("jax_app", os.path.join(ROOT, "app.py"))
    japp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(japp)

    frames = synthetic_video(n=40, hw=(42, 56), seed=2)
    params = np_tree(init_params(0, J_TOY))
    saved = {}

    def read(path, max_len, target_fps, max_res):
        assert (max_len, target_fps, max_res) == (500, 15, 1280)
        return frames, 15.0

    def save(which):
        def write(arr, path, fps=10, is_depths=False, grayscale=False):
            saved[(which, os.path.basename(path))] = (np.array(arr), fps, is_depths)
        return write

    def fixed(pipe):
        infer = pipe.infer_video_depth
        pipe.infer_video_depth = lambda f, fps: infer(f, fps, input_size=INPUT, fp32=True)
        return pipe

    monkeypatch.setattr(jvio, "read_video_frames", read)
    monkeypatch.setattr(tvio, "read_video_frames", read)
    monkeypatch.setattr(jvio, "save_video", save("jax"))
    monkeypatch.setattr(tvio, "save_video", save("port"))
    monkeypatch.setattr(japp, "_get_pipeline", lambda: fixed(JaxPipeline(
        J_TOY, jax.tree.map(jnp.asarray, params), use_pallas=False)))
    monkeypatch.setattr(tapp, "_get_pipeline", lambda: fixed(VideoDepthPipeline(
        T_TOY, convert.model_from_params(params, T_TOY), device="cpu")))

    out = str(tmp_path / "out")
    got = tapp.process_video("/videos/clip.mp4", output_dir=out)
    ref = japp.process_video("/videos/clip.mp4", output_dir=out)
    assert got == ref == (os.path.join(out, "clip_src.mp4"), os.path.join(out, "clip_vis.mp4"))
    src_t, src_j = saved[("port", "clip_src.mp4")], saved[("jax", "clip_src.mp4")]
    np.testing.assert_array_equal(src_t[0], src_j[0])
    vis_t, vis_j = saved[("port", "clip_vis.mp4")], saved[("jax", "clip_vis.mp4")]
    assert vis_t[1:] == vis_j[1:] == (15.0, True) and vis_t[0].shape == frames.shape[:3]
    np.testing.assert_allclose(vis_t[0], vis_j[0], rtol=2e-4, atol=2e-4)


def test_app_pipeline_warns_on_random_weights_and_demo_needs_gradio(
        tmp_path, monkeypatch, capsys, toy_configs):
    import sys

    from video_depth_anything_torch import app as tapp
    from video_depth_anything_torch.pipeline import infer

    monkeypatch.chdir(tmp_path)                      # no ./checkpoints here
    monkeypatch.setattr(tapp, "_PIPELINE", {})
    monkeypatch.setattr(infer, "resolve_device", lambda device=None: torch.device("cpu"))
    pipe = tapp._get_pipeline()
    assert "WARNING: no checkpoint found — using random weights" in capsys.readouterr().out
    assert tapp._get_pipeline() is pipe and pipe.device == torch.device("cpu")
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit, match="gradio is not installed in this image"):
        tapp.main()
