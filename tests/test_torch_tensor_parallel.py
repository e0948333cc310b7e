"""The port's model axis (tensor parallelism: parallel/mesh.py's rules,
parallel/tensor.py's collectives, the split blocks, the pipeline's and the
trainer's model-axis paths) against the JAX package, on the CPU.

The ranks are processes of this file (``python
tests/test_torch_tensor_parallel.py <rank> <world> <dir>``) joined through
torchrun's environment variables on gloo: 2 ranks on a (1, 2) mesh and 4
on a (2, 2) mesh, each group spawned once per module; they run every
multi-rank case and save what they computed, and the tests read it. Rank
1 perturbs its weights before each mesh object is made, so equal ranks
also show that rank 0's weights were broadcast. The toy model is
tests/test_torch_parallel.py's: ViTConfig(64, depth 2, 2 heads; one head
per rank), features 32, as JAX's tests/test_mesh_inference.py.

Tolerances:
  - serving on a (1, 2) or (2, 2) mesh against the JAX single-device
    pipeline (use_pallas=False, fp32): rtol = atol = 2e-4, JAX's own bound
    for a sharded run against one device (tests/test_mesh_inference.py);
    the row-split products change only the order of sums;
  - the ranks against each other: bit for bit (one all_reduce gives every
    rank of a model group the same bytes);
  - int8 on the (1, 2) mesh against the port's int8 on one process, on the
    side file rank 0 wrote: twice the flip floor (utils/precision.py::
    flip_floor_report), and bit for bit (the row-split sites sum their
    int32 partials, exactly);
  - three train steps on the (1, 2) mesh against JAX's single-process
    oracle (tests/test_distributed.py::_oracle_loss): 5e-4 relative, the
    bound of tests/test_torch_parallel.py's two-rank training test;
  - ``gather_params(shard_params(m))`` and ``gather_model`` against ``m``:
    bit for bit;
  - a bf16 row-split site against the unsplit bf16 linear: under 0.1 % of
    the elements differ (the fp32 partials are summed in fp32 and rounded
    once, so only the sum order differs), by one bf16 step of the largest
    output at most;
  - a block left whole (a head count that does not divide the axis) with
    its MLP split, against the model on one process: 2e-4.
"""
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (ROOT, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_parallel import (HW, INPUT, RANK1_NOISE, SERVE_KW, T_CFG,  # noqa: E402
                                 TRAIN_CFG, VIT, _free_port, few_threads, load_model,
                                 serve_params, train_batch, train_config, video)

from video_depth_anything_torch.config import ModelConfig, ViTConfig  # noqa: E402

TRAIN_STEPS = 3
# (name, frames, windows_per_batch, keyframe cache) on the (1, 2) mesh: a
# mesh always runs the batched cache, so C = 1 stands for the sequential
# mode of the single-device pipeline.
CASES = [("n70_c1_cache", 70, 1, True), ("n112_c3_cache", 112, 3, True),
         ("n70_c2_plain", 70, 2, False)]
CASE4 = ("n112_c4_cache", 112, 4, True)        # the (2, 2) mesh's one case
# A head count that does not divide the axis: 3 heads on 2 ranks leave
# each block's attention whole, its MLP (hidden 384) split.
ODD_CFG = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=96, depth=2, num_heads=3),
                      **SERVE_KW)
# Every kind of fused column on one model: SwiGLU's w12, RoPE's table.
FUSED_CFG = ModelConfig(encoder="vits", vit_override=ViTConfig(
    embed_dim=64, depth=2, num_heads=2, ffn_layer="swiglufused"), pe="rope", **SERVE_KW)

assert few_threads and serve_params     # fixtures of test_torch_parallel.py, used here


def trainer_yaml2(path):
    """test_torch_parallel.py's trainer config over two epochs: the first
    without a mesh, the second resumed on the model axis."""
    with open(path, "w") as f:
        f.write("hyper_parameter:\n  learning_rate: 1.0e-3\n  epochs: 2\n  ratio_ssi: 1\n"
                "  ratio_tgm: 1\n  patient: 5\n  batch_size: 1\n  compute_dtype: float32\n")
    return path


# ------------------------------------------------------------------ the worker


def _identity_cases(mesh, rank) -> dict:
    """gather_params(shard_params(m)) against m's state dict, float and
    int8, on the real collectives; and rank's RoPE table rows."""
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.ops.quant import quantize_model
    from video_depth_anything_torch.parallel import gather_model, gather_params, shard_params

    out = {}
    model = build_model(FUSED_CFG, seed=0)
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 4, 28, 28, 3))
                         .astype(np.float32))
    stats = copy.deepcopy(model).calibrate_stats(x)
    q = quantize_model(model, stats)
    q_whole = {k: v.clone() for k, v in q.state_dict().items()}
    shard_params(model, mesh)
    shard_params(q, mesh)
    for name, m, ref in (("float", model, whole), ("int8", q, q_whole)):
        got = gather_params(m, mesh)
        out[name] = sorted(got) == sorted(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
        # gather_model: the same tensors in a whole module again.
        got = gather_model(m, mesh).state_dict()
        out[name + "_model"] = sorted(got) == sorted(ref) and all(
            torch.equal(got[k], ref[k]) for k in ref)
    attn = model.head.motion_modules[0].temporal_transformer.transformer_blocks[0]
    rope = attn.attention_blocks[0].rope
    out["rope_pairs"] = list(rope.pairs)
    out["rope_rows"] = rope.freqs.shape[1]
    back = gather_model(model, mesh)
    battn = back.head.motion_modules[0].temporal_transformer.transformer_blocks[0]
    out["whole_again"] = {
        "heads": [back.pretrained.blocks[0].attn.num_heads,
                  battn.attention_blocks[0].num_heads],
        "tp": [m.tp is not None for m in back.modules() if hasattr(m, "tp")],
        "rope_pairs": list(battn.attention_blocks[0].rope.pairs),
        "rope_rows": battn.attention_blocks[0].rope.freqs.shape[1]}
    with torch.no_grad():
        out["whole_again"]["forward_equal"] = bool(torch.equal(
            back(x), build_model(FUSED_CFG, seed=0)(x)))
    return out


def _bf16_row_split(mesh) -> dict:
    """A bf16 row-split site (``quant.linear_maybe_q(..., tp=)``) on the real
    collectives against the unsplit bf16 linear: the fraction of elements
    that differ, and whether each differs by at most one bf16 step."""
    from video_depth_anything_torch.ops import nn as vnn
    from video_depth_anything_torch.ops import quant
    from video_depth_anything_torch.parallel import model_axis

    axis = model_axis(mesh)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 256, 1024, generator=g).bfloat16()
    lin = torch.nn.Linear(1024, 384).bfloat16()
    with torch.no_grad():
        lin.weight.copy_(torch.randn(384, 1024, generator=g) * 0.05)
        lin.bias.copy_(torch.randn(384, generator=g) * 0.5)
    whole = vnn.linear(x, lin.weight, lin.bias)
    h = 1024 // axis.size
    cols = slice(axis.rank * h, (axis.rank + 1) * h)
    part = torch.nn.Linear(h, 384).bfloat16()
    with torch.no_grad():
        part.weight.copy_(lin.weight[:, cols])
        part.bias.copy_(lin.bias)
        y = quant.linear_maybe_q(part, x[..., cols], tp=axis)
    return {"dtype": str(y.dtype), "mismatch": float((y != whole).float().mean()),
            "max_diff_steps": float((y.float() - whole.float()).abs().max()
                                    / (whole.float().abs().max() * 2.0 ** -8))}


def worker(rank: int, world: int, out_dir: str) -> None:
    """One rank: joins through torchrun's environment, runs its group's
    cases and saves its results to ``out_dir/w<world>r<rank>.npz`` / ``.json``."""
    import dataclasses

    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.parallel import distributed as pdist
    from video_depth_anything_torch.parallel import gather_params, make_mesh, shard_batch
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline import infer
    from video_depth_anything_torch.training import train_state as ts
    from video_depth_anything_torch.training.train import train
    from video_depth_anything_torch.utils import params_io

    torch.set_num_threads(2)
    pdist.initialize(device="cpu")
    mesh = make_mesh(n_model=2)
    noise = RANK1_NOISE if rank % 2 else 0.0
    weights = os.path.join(out_dir, "serve.pt")
    arrays, info = {}, {"rank": rank, "world": world, "mesh": list(mesh.shape)}
    info["bounds_4"] = list(pdist.process_batch_bounds(4, mesh))
    info["device_type"] = [mesh.device_type, pdist.group_device_type()]

    pipe = VideoDepthPipeline(T_CFG, load_model(T_CFG, weights, noise), mesh=mesh)
    info["local_heads"] = pipe.model.pretrained.blocks[0].attn.num_heads
    params_io.save_model(os.path.join(out_dir, f"split_w{world}.npz"), pipe.model, mesh)
    for name, n, c, cache in (CASES if world == 2 else [CASE4]):
        arrays[name], _ = pipe.infer_video_depth(video(n), input_size=INPUT, fp32=True,
                                                 windows_per_batch=c,
                                                 cache_keyframe_features=cache)
    if world == 4:
        np.savez(os.path.join(out_dir, f"w{world}r{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"w{world}r{rank}.json"), "w") as f:
            json.dump(info, f)
        torch.distributed.destroy_process_group()
        return

    writes = []
    save = infer._save_calib
    infer._save_calib = lambda *a: (writes.append(a[0]), save(*a))
    calib = os.path.join(out_dir, "int8calib.npz")
    q = VideoDepthPipeline(T_CFG, load_model(T_CFG, weights, noise), mesh=mesh, quant="int8",
                           calib_path=calib)
    arrays["int8"], _ = q.infer_video_depth(video(70), input_size=INPUT, fp32=True,
                                            windows_per_batch=2)
    infer._save_calib = save
    info["calib_writes"] = len(writes)

    # Three train steps on the whole global batch (the data axis is 1 wide).
    state = ts.create_train_state(load_model(TRAIN_CFG, os.path.join(out_dir, "train.pt"),
                                             noise), train_config())
    ts.shard_train_state(state, mesh)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(train_batch(), mesh).items()}
    info["train_rows"] = int(batch["video"].shape[0])
    info["train_losses"] = []
    for _ in range(TRAIN_STEPS):
        state, metrics = ts.train_step(state, batch, TRAIN_CFG, train_config())
        info["train_losses"].append(float(metrics["loss"]))
    moments = [v for t in state.head.values() for k, v in state.opt.state[t].items()
               if k == "exp_avg"]
    info["moment_numel"] = sum(m.numel() for m in moments)
    sd = state.state_dict()
    info["head_numel"] = sum(t.numel() for k, t in sd["params"].items()
                             if k.startswith("head.") and t.is_floating_point())
    for k, t in sd["params"].items():
        if k.startswith("head."):
            arrays["train/" + k] = t.numpy()

    info["identity"] = _identity_cases(mesh, rank)
    info["bf16_row_split"] = _bf16_row_split(mesh)

    # The non-dividing head count: attention whole, MLP split.
    odd = build_model(ODD_CFG, seed=1)
    ref = copy.deepcopy(odd)
    from video_depth_anything_torch.parallel import shard_params
    shard_params(odd, mesh)
    blk = odd.pretrained.blocks[0]
    info["odd"] = {"attn_tp": blk.attn.tp is not None, "mlp_tp": blk.mlp.tp is not None,
                   "qkv_rows": blk.attn.qkv.weight.shape[0],
                   "fc1_rows": blk.mlp.fc1.weight.shape[0]}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 28, 28, 3))
                         .astype(np.float32))
    with torch.no_grad():
        arrays["odd"], arrays["odd_ref"] = odd(x).numpy(), ref(x).numpy()
    del odd, ref
    gathered = gather_params(build_model(ODD_CFG, seed=1), mesh)
    info["odd_gather_keys"] = len(gathered)

    # The trainer on the model axis: one step resumed from the checkpoint
    # that the test wrote without a mesh, then its own checkpoint (gathered).
    trainer = train(trainer_yaml2(os.path.join(out_dir, f"trainer{rank}.yaml")),
                    data_root=os.path.join(out_dir, "vkitti"),
                    out_dir=os.path.join(out_dir, "trainer_out"), max_steps=1, resume=True,
                    mesh=mesh, model_cfg=dataclasses.replace(TRAIN_CFG, num_frames=3),
                    resize_size=28, device="cpu")
    info["trainer_step"] = trainer.step
    info["trainer_split"] = trainer.model.head.motion_modules[0].temporal_transformer \
        .transformer_blocks[0].ff.tp is not None

    np.savez(os.path.join(out_dir, f"w{world}r{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"w{world}r{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ fixtures


def _spawn(out, world: int, timeout: float):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs, logs = [], [out / f"w{world}r{rank}.log" for rank in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for rank in range(world):
            renv = {**env, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(rank), str(world), str(out)],
                    stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=renv))
        # Until every rank ends, one fails (its peers would wait in a
        # collective) or the time is up; whatever still runs is then killed.
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{logs[rank].read_text()}"
    got = []
    for rank in range(world):
        with np.load(out / f"w{world}r{rank}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        with open(out / f"w{world}r{rank}.json") as f:
            got.append({"arrays": arrays, "info": json.load(f)})
    return got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, serve_params, few_threads):
    """Both groups' saved results: ({world: [{"arrays", "info"} per rank]},
    the directory). Before the ranks start, the trainer writes a
    checkpoint without a mesh for the model axis to resume."""
    import dataclasses

    from test_data import _make_vkitti
    from video_depth_anything_tpu.config import ModelConfig as JModelConfig
    from video_depth_anything_tpu.config import ViTConfig as JViTConfig
    from video_depth_anything_tpu.models.video_depth import init_params
    from video_depth_anything_torch.convert import state_dict_from_params
    from video_depth_anything_torch.training.train import train

    from test_torch_parallel import TRAIN_KW

    out = tmp_path_factory.mktemp("tp_ranks")
    _, params = serve_params
    torch.save(state_dict_from_params(params, VIT.depth), out / "serve.pt")
    jtrain = JModelConfig(vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2),
                          **TRAIN_KW)
    torch.save(state_dict_from_params(init_params(0, jtrain), VIT.depth), out / "train.pt")
    _make_vkitti(str(out / "vkitti"), scenes=("Scene01", "Scene20"), frames=4, hw=(40, 60))
    train(trainer_yaml2(str(out / "trainer.yaml")), data_root=str(out / "vkitti"),
          out_dir=str(out / "trainer_out"), max_steps=1,
          model_cfg=dataclasses.replace(TRAIN_CFG, num_frames=3), resize_size=28, device="cpu")
    return {2: _spawn(out, 2, 240), 4: _spawn(out, 4, 180)}, out


@pytest.fixture(scope="module")
def jax_refs(serve_params):
    """The JAX single-device pipeline (use_pallas=False, fp32) per video."""
    import jax
    import jax.numpy as jnp

    from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline

    jcfg, params = serve_params
    jpipe = JaxPipeline(jcfg, jax.tree.map(jnp.asarray, params), use_pallas=False)
    return {n: np.asarray(jpipe.infer_video_depth(video(n), input_size=INPUT, fp32=True)[0])
            for n in (70, 112)}


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("world,case", [(2, c) for c in CASES] + [(4, CASE4)],
                         ids=[f"mesh1x2-{c[0]}" for c in CASES] + [f"mesh2x2-{CASE4[0]}"])
def test_model_axis_serving_matches_jax_and_ranks_agree(ranks, jax_refs, world, case):
    got, _ = ranks
    name, n = case[0], case[1]
    a = got[world][0]["arrays"][name]
    assert a.shape == (n, *HW) and a.dtype == np.float32
    np.testing.assert_allclose(a, jax_refs[n], rtol=2e-4, atol=2e-4)
    for r in got[world][1:]:
        np.testing.assert_array_equal(r["arrays"][name], a)
    assert [r["info"]["local_heads"] for r in got[world]] == [1] * world


@pytest.mark.parametrize("world", [2, 4])
def test_saved_split_model_is_the_whole_model(ranks, world):
    """utils/params_io.py::save_model on a split model: gathered on every
    rank, written by rank 0 alone, the whole rank-0 weights bit for bit."""
    from video_depth_anything_torch.convert import state_dict_from_params
    from video_depth_anything_torch.utils.params_io import load_params

    _, out = ranks
    got = state_dict_from_params(load_params(str(out / f"split_w{world}.npz")), VIT.depth)
    want = torch.load(out / "serve.pt", weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(got[k]), v), k


def test_model_groups_take_their_data_index_rows(ranks):
    """On the (2, 2) mesh ranks 0, 1 are data index 0 and ranks 2, 3 data
    index 1: the rows follow the data axis, not the global rank (by global
    rank each rank would feed its model group other frames)."""
    got, _ = ranks
    assert [r["info"]["mesh"] for r in got[4]] == [[2, 2]] * 4
    assert [r["info"]["bounds_4"] for r in got[4]] == [[0, 2], [0, 2], [2, 4], [2, 4]]
    assert [r["info"]["bounds_4"] for r in got[2]] == [[0, 4], [0, 4]]


def test_int8_on_the_model_axis_within_flip_floor_and_one_side_file(ranks, serve_params):
    from video_depth_anything_torch.convert import model_from_params
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline.infer import scale_side_file
    from video_depth_anything_torch.utils.precision import flip_floor_report

    got, out = ranks
    ranks2 = got[2]
    assert [r["info"]["calib_writes"] for r in ranks2] == [1, 0]
    np.testing.assert_array_equal(ranks2[0]["arrays"]["int8"], ranks2[1]["arrays"]["int8"])
    _, params = serve_params
    model = model_from_params(params, T_CFG)

    def run(side):
        pipe = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8", calib_path=side)
        return pipe.infer_video_depth(video(70), input_size=INPUT, fp32=True,
                                      windows_per_batch=2)[0]

    nudged = str(out / "nudged.npz")
    scale_side_file(str(out / "int8calib.npz"), nudged, 1 + 1e-6)
    ref = run(str(out / "int8calib.npz"))
    rep = flip_floor_report(ranks2[0]["arrays"]["int8"], ref, run(nudged))
    assert rep["ok"], rep
    # Closer still: the row-split sites sum their int32 partials exactly, and
    # every other int8 or float op sees the same bits on each rank.
    np.testing.assert_array_equal(ranks2[0]["arrays"]["int8"], ref)


# ------------------------------------------------------------------ training


def test_model_axis_train_steps_match_jax_oracle(ranks):
    from test_distributed import _oracle_loss

    got, _ = ranks
    r0, r1 = (r["info"] for r in got[2])
    assert r0["train_losses"] == r1["train_losses"]
    assert r0["train_rows"] == r1["train_rows"] == 4
    oracle = _oracle_loss(TRAIN_STEPS)
    loss = r0["train_losses"][-1]
    assert abs(loss - oracle) < 5e-4 * max(abs(oracle), 1.0), (loss, oracle)
    # AdamW's moments are split with their tensors: fewer than the whole
    # head's elements on each rank (the split tensors' halves).
    assert 0 < r0["moment_numel"] < r0["head_numel"] and r0["moment_numel"] == r1["moment_numel"]
    heads = [{k: v for k, v in r["arrays"].items() if k.startswith("train/")} for r in got[2]]
    assert heads[0] and sorted(heads[0]) == sorted(heads[1])
    for k, v in heads[0].items():
        np.testing.assert_array_equal(v, heads[1][k], err_msg=k)


def test_model_axis_checkpoint_loads_whole_with_strict(ranks):
    """The trainer resumed, on the model axis, the checkpoint written
    without a mesh, and wrote its own from rank 0 (gathered): it loads into
    a model without a mesh with strict=True, and AdamW's moments are
    whole."""
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.training.checkpoint import load_checkpoint

    import dataclasses

    got, out = ranks
    assert [r["info"]["trainer_step"] for r in got[2]] == [2, 2]
    assert all(r["info"]["trainer_split"] for r in got[2])
    ck = load_checkpoint(str(out / "trainer_out"), "latest_checkpoint")
    assert ck["step"] == 2 and ck["extra"]["epoch"] == 1
    model = build_model(dataclasses.replace(TRAIN_CFG, num_frames=3))
    model.load_state_dict(ck["params"], strict=True)
    heads = [t for n, t in model.head.state_dict().items() if t.is_floating_point()]
    moments = ck["opt_state"]["state"]
    assert len(moments) == len(heads)
    for i, t in enumerate(heads):
        assert moments[i]["exp_avg"].shape == t.shape and moments[i]["exp_avg_sq"].shape == t.shape


# ------------------------------------------------------------------ the rules


def test_gather_of_shard_is_the_whole_model(ranks):
    got, _ = ranks
    for r, info in enumerate(x["info"] for x in got[2]):
        ident = info["identity"]
        assert ident["float"] and ident["int8"], ident
        # RoPE over C = 32 channels: 16 pairs, 8 per rank, rank r's in order.
        assert ident["rope_pairs"] == [8 * r, 8 * r + 8] and ident["rope_rows"] == 8


def test_gather_model_makes_the_split_model_whole_again(ranks):
    """parallel.gather_model (the pipeline's int8 path quantizes its
    output): the whole tensors, float and int8, bit for bit; every block
    whole again (global head counts, no model axis, the full RoPE table);
    the same forward as the model never split, bit for bit."""
    got, _ = ranks
    for info in (x["info"] for x in got[2]):
        ident = info["identity"]
        assert ident["float_model"] and ident["int8_model"], ident
        back = ident["whole_again"]
        assert back["heads"] == [2, 8] and back["tp"] and not any(back["tp"]), back
        assert back["rope_pairs"] == [0, 16] and back["rope_rows"] == 16, back
        assert back["forward_equal"], back


def test_bf16_row_split_rounds_once(ranks):
    """A bf16 row-split site sums the ranks' fp32 partials in fp32 and
    rounds once, after the bias, as the unsplit bf16 linear does: it
    differs from it in under 0.1 % of the elements (where the two fp32
    sum orders straddle a rounding), by at most one bf16 step of the
    largest output. (Rounding each partial, the sum and the bias add to
    bf16 gives a different value in ~44 % of them.)"""
    got, _ = ranks
    for info in (x["info"] for x in got[2]):
        rep = info["bf16_row_split"]
        assert rep["dtype"] == "torch.bfloat16", rep
        assert rep["mismatch"] < 1e-3 and rep["max_diff_steps"] <= 1.0, rep


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_takes_the_device_that_initialize_chose(ranks, world):
    """make_mesh has no device argument: it reads what
    distributed.initialize recorded (gloo on the CPU here)."""
    got, _ = ranks
    assert [r["info"]["device_type"] for r in got[world]] == [["cpu", "cpu"]] * world


@pytest.mark.parametrize("key,groups", [("pretrained.blocks.0.attn.qkv.weight", 3),
                                        ("pretrained.blocks.1.mlp.w12.bias", 2),
                                        ("head.motion_modules.2.temporal_transformer."
                                         "transformer_blocks.0.ff.net.0.proj.weight", 2)])
def test_fused_columns_regrouped_per_rank(key, groups):
    """Rank r's shard of a fused projection is its part of each fused group
    (q, k, v; x1, x2; val, gate), not a contiguous cut, and merging the
    ranks' shards gives the tensor back bit for bit."""
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.parallel import ModelAxis, split_params, split_specs
    from video_depth_anything_torch.parallel.mesh import merge_shards

    model = build_model(FUSED_CFG, seed=0)
    whole = model.state_dict()[key]
    parts = [split_params(copy.deepcopy(model), ModelAxis(None, 2, r)).state_dict()[key]
             for r in range(2)]
    size = whole.shape[0] // groups
    for r, part in enumerate(parts):
        want = torch.cat([whole[g * size + r * size // 2:g * size + (r + 1) * size // 2]
                          for g in range(groups)])
        assert torch.equal(part, want)
    spec = split_specs(split_params(copy.deepcopy(model), ModelAxis(None, 2, 0)))[key]
    assert spec == (0, groups)
    assert torch.equal(merge_shards(parts, *spec), whole)


def test_non_dividing_head_count_leaves_the_attention_whole(ranks):
    """The counterpart of JAX's test_non_dividing_dim_falls_back_to_replication:
    3 heads on a 2-wide axis (and vits' 6 on a 4-wide one) keep each block's
    attention whole, while the MLP is split; the model computes the same
    function."""
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.parallel import ModelAxis, split_params

    got, _ = ranks
    for r in got[2]:
        odd = r["info"]["odd"]
        assert odd == {"attn_tp": False, "mlp_tp": True, "qkv_rows": 288, "fc1_rows": 192}
        assert r["info"]["odd_gather_keys"] > 0
        np.testing.assert_allclose(r["arrays"]["odd"], r["arrays"]["odd_ref"], rtol=2e-4,
                                   atol=2e-4)
    vits6 = ModelConfig(encoder="vits", vit_override=ViTConfig(embed_dim=96, depth=1,
                                                               num_heads=6), **SERVE_KW)
    blk = split_params(build_model(vits6), ModelAxis(None, 4, 1)).pretrained.blocks[0]
    assert blk.attn.tp is None and blk.attn.num_heads == 6 and blk.attn.qkv.weight.shape[0] == 288
    assert blk.mlp.tp is not None and blk.mlp.fc1.weight.shape[0] == 96


def test_split_twice_refused():
    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.parallel import ModelAxis, split_params

    model = split_params(build_model(T_CFG), ModelAxis(None, 2, 0))
    with pytest.raises(ValueError, match="already split"):
        split_params(model, ModelAxis(None, 2, 0))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
