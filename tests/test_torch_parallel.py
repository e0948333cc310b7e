"""The port's data-parallel serving and training (parallel/, the pipeline's
and the trainer's mesh paths) against the JAX package, on the CPU.

Two ranks are two processes of this file (``python
tests/test_torch_parallel.py <rank> <dir>``) joined through torchrun's
environment variables on gloo; they run every multi-rank case once and
save what they computed, and the tests read it. Rank 1 perturbs its weights before each
mesh object is made, so every equality across ranks also shows rank 0's
weights were broadcast. World-1 cases run in the test process on a gloo
group of one rank.

Toy model: ViTConfig(64, depth 2, 2 heads), features 32, taps 0, 0, 1, 1
(tests/dist_infer_worker.py), weights init_params(0) perturbed as in
test_torch_model.py and carried across with convert.state_dict_from_params.

Tolerances:
  - serving on 2 ranks against the JAX single-device pipeline
    (use_pallas=False, fp32): rtol = atol = 2e-4, JAX's own bound for its
    2-process pipeline (tests/test_distributed.py);
  - the ranks against each other: bit for bit; against the port on one
    process at the same C: 1e-5 of the depth range (JAX's bound between its
    cache modes, tests/test_pipeline_parity.py: the ranks encode other
    batches, so the sums run in another order);
  - int8 on 2 ranks against the port's int8 on one process, on the side
    file rank 0 wrote: twice the flip floor (utils/precision.py::
    flip_floor_report, as tests/test_torch_quant.py holds int8 runs on
    identical scales);
  - training on 2 ranks against JAX's single-process oracle
    (tests/test_distributed.py::_oracle_loss, the same config and global
    batch): 5e-4 relative, the bound JAX's own 2-process test holds;
  - a mesh of one rank against no mesh: bit for bit (a one-rank
    all_gather and a mean over one rank are exact).
"""
import json
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from video_depth_anything_torch.config import ModelConfig, ViTConfig  # noqa: E402

INPUT = 28
HW = (42, 56)
VIT = ViTConfig(embed_dim=64, depth=2, num_heads=2)
SERVE_KW = dict(features=32, out_channels=(32, 32, 32, 32), taps=(0, 0, 1, 1))
TRAIN_KW = dict(encoder="_tinydist", features=32, out_channels=(32, 32, 32, 32), num_frames=4,
                taps=(0, 0, 1, 1))
T_CFG = ModelConfig(encoder="vits", vit_override=VIT, **SERVE_KW)
TRAIN_CFG = ModelConfig(vit_override=VIT, **TRAIN_KW)
TRAIN_STEPS = 2
# (name, frames, windows_per_batch, keyframe cache): 70 frames are 3
# windows, 112 frames 5; C = 3 rounds up to 4 on 2 ranks.
CASES = [("n70_c4", 70, 4, True), ("n112_c3_cache", 112, 3, True),
         ("n112_c3_plain", 112, 3, False)]
RANK1_NOISE = 0.05


def video(n):
    from video_depth_anything_torch.utils.precision import synthetic_video
    return synthetic_video(n=n, hw=HW, seed=6)


def train_batch():
    """tests/test_distributed.py::_oracle_loss's global batch."""
    rng = np.random.default_rng(0)
    return {"video": rng.standard_normal((4, 4, 28, 28, 3)).astype(np.float32),
            "gt": rng.random((4, 4, 28, 28)).astype(np.float32),
            "mask": np.ones((4, 4, 28, 28), np.float32)}


def train_config():
    from video_depth_anything_torch.training import train_state as ts
    return ts.TrainConfig(learning_rate=3e-3, epochs=1, steps_per_epoch=10,
                          compute_dtype="float32", ratio_tgm=1.0)


def load_model(cfg, path, noise=0.0):
    from video_depth_anything_torch.models import build_model

    model = build_model(cfg)
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)
    if noise:
        with torch.no_grad():
            for t in model.state_dict().values():
                if t.is_floating_point():
                    t.add_(noise)
    return model


def trainer_yaml(path):
    with open(path, "w") as f:
        f.write("hyper_parameter:\n  learning_rate: 1.0e-3\n  epochs: 1\n  ratio_ssi: 1\n"
                "  ratio_tgm: 1\n  patient: 5\n  batch_size: 1\n  compute_dtype: float32\n")
    return path


# ------------------------------------------------------------------ the worker


def worker(rank: int, out_dir: str) -> None:
    """One rank: joins through torchrun's environment, runs every case and
    saves its results to ``out_dir/rank<r>.npz`` and ``.json``."""
    import dataclasses

    from video_depth_anything_torch.parallel import distributed as pdist
    from video_depth_anything_torch.parallel import make_mesh, shard_batch
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline import infer
    from video_depth_anything_torch.training import train_state as ts
    from video_depth_anything_torch.training.train import train

    torch.set_num_threads(2)
    pdist.initialize(device="cpu")
    mesh = make_mesh()
    noise = RANK1_NOISE if rank else 0.0
    weights = os.path.join(out_dir, "serve.pt")
    arrays, info = {}, {"rank": rank, "world": torch.distributed.get_world_size()}

    pipe = VideoDepthPipeline(T_CFG, load_model(T_CFG, weights, noise), mesh=mesh)
    info["device"] = str(pipe.device)
    for name, n, c, cache in CASES:
        arrays[name], _ = pipe.infer_video_depth(video(n), input_size=INPUT, fp32=True,
                                                 windows_per_batch=c,
                                                 cache_keyframe_features=cache)

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

    try:
        list(pipe.infer_video_depth_streaming(iter(video(40)), input_size=INPUT))
        info["stream"] = "ran"
    except NotImplementedError as e:
        info["stream"] = str(e)
    try:
        pdist.process_batch_bounds(3)
        info["bounds_3"] = "ran"
    except ValueError as e:
        info["bounds_3"] = str(e)
    info["bounds_4"] = pdist.process_batch_bounds(4)

    try:
        shard_batch({k: v[:3] for k, v in train_batch().items()}, mesh)
        info["untiled_batch"] = "ran"
    except ValueError as e:
        info["untiled_batch"] = str(e)

    # Two train steps on this rank's rows of the global batch.
    state = ts.create_train_state(load_model(TRAIN_CFG, os.path.join(out_dir, "train.pt"),
                                             noise), train_config())
    ts.shard_train_state(state, mesh)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(train_batch(), mesh).items()}
    info["train_rows"] = int(batch["video"].shape[0])
    for _ in range(TRAIN_STEPS):
        state, metrics = ts.train_step(state, batch, TRAIN_CFG, train_config())
    info["train_loss"] = float(metrics["loss"])
    info["train_step"] = state.step
    for k, t in state.head.items():
        arrays["head/" + k] = t.detach().numpy()

    # The trainer's --distributed mode on a VKITTI tree (one step).
    trainer = train(trainer_yaml(os.path.join(out_dir, f"trainer{rank}.yaml")),
                data_root=os.path.join(out_dir, "vkitti"),
                out_dir=os.path.join(out_dir, "trainer_out"), max_steps=1,
                model_cfg=dataclasses.replace(TRAIN_CFG, num_frames=3), resize_size=28,
                distributed=True, device="cpu")
    info["trainer_step"] = trainer.step
    for k, t in trainer.head.items():
        arrays["trainer/" + k] = t.detach().numpy()

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ fixtures


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def serve_params():
    from test_torch_model import perturbed_params
    from video_depth_anything_tpu.config import ModelConfig as JModelConfig
    from video_depth_anything_tpu.config import ViTConfig as JViTConfig

    jcfg = JModelConfig(encoder="_tinytorchmesh",
                        vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2), **SERVE_KW)
    return jcfg, perturbed_params(jcfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, serve_params, few_threads):
    """Both ranks' saved results: ({"arrays", "info"} per rank, the directory)."""
    from test_data import _make_vkitti
    from video_depth_anything_tpu.config import ModelConfig as JModelConfig
    from video_depth_anything_tpu.config import ViTConfig as JViTConfig
    from video_depth_anything_tpu.models.video_depth import init_params
    from video_depth_anything_torch.convert import state_dict_from_params

    out = tmp_path_factory.mktemp("ranks")
    jcfg, params = serve_params
    torch.save(state_dict_from_params(params, VIT.depth), out / "serve.pt")
    jtrain = JModelConfig(vit_override=JViTConfig(embed_dim=64, depth=2, num_heads=2),
                          **TRAIN_KW)
    tree = init_params(0, jtrain)
    torch.save(state_dict_from_params(tree, VIT.depth), out / "train.pt")
    # Two training scenes: one clip for each rank's shard.
    _make_vkitti(str(out / "vkitti"), scenes=("Scene01", "Scene02", "Scene20"), frames=4,
                 hw=(40, 60))

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs, logs = [], [out / f"rank{rank}.log" for rank in range(2)]
    deadline = time.monotonic() + 240
    try:
        for rank in range(2):
            renv = {**env, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen([sys.executable, __file__, str(rank), str(out)],
                                              stdout=log, stderr=subprocess.STDOUT,
                                              cwd=ROOT, env=renv))
        # Until both ranks end, one fails (its peer would wait in a
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
    for rank in range(2):
        with np.load(out / f"rank{rank}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        with open(out / f"rank{rank}.json") as f:
            got.append({"arrays": arrays, "info": json.load(f)})
    return got, out


@pytest.fixture(scope="module")
def single(serve_params, few_threads):
    """The port on one process, no mesh, at each case's rounded C."""
    from video_depth_anything_torch.convert import model_from_params
    from video_depth_anything_torch.pipeline import VideoDepthPipeline

    _, params = serve_params
    pipe = VideoDepthPipeline(T_CFG, model_from_params(params, T_CFG), device="cpu")
    return {name: pipe.infer_video_depth(video(n), input_size=INPUT, fp32=True,
                                         windows_per_batch=-(-c // 2) * 2,
                                         cache_keyframe_features=cache)[0]
            for name, n, c, cache in CASES}


@pytest.fixture(scope="module")
def jax_refs(serve_params):
    """The JAX single-device pipeline (use_pallas=False, fp32) per video."""
    import jax
    import jax.numpy as jnp

    from video_depth_anything_tpu.pipeline import VideoDepthPipeline as JaxPipeline

    jcfg, params = serve_params
    jpipe = JaxPipeline(jcfg, jax.tree.map(jnp.asarray, params), use_pallas=False)
    return {n: np.asarray(jpipe.infer_video_depth(video(n), input_size=INPUT, fp32=True)[0])
            for n in sorted({n for _, n, _, _ in CASES})}


@pytest.fixture(scope="module")
def world1(few_threads):
    """A gloo group of one rank in this process, and its mesh."""
    import torch.distributed as dist

    from video_depth_anything_torch.parallel import distributed as pdist
    from video_depth_anything_torch.parallel import make_mesh

    assert not dist.is_initialized()
    pdist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    pdist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")   # idempotent
    yield make_mesh()
    dist.destroy_process_group()


def test_initialize_without_a_cluster_is_a_noop(monkeypatch):
    """Runs before the first world-1 test makes this process's group."""
    import torch.distributed as dist

    from video_depth_anything_torch.parallel import distributed as pdist

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    pdist.initialize(device="cpu")
    assert not dist.is_initialized() and pdist.process_batch_bounds(3) == (0, 3)
    with pytest.raises(ValueError, match="together"):
        pdist.initialize("127.0.0.1:1", 2)


@pytest.mark.parametrize("local_rank,cards,card", [(None, 2, 1), (None, 1, 0), ("0", 2, 0)])
def test_initialize_and_mesh_device_pick_one_card(monkeypatch, local_rank, cards, card):
    """Rank 1 joining through env:// under NCCL (the group and the card
    stubbed): initialize makes LOCAL_RANK current, else the rank modulo
    the node's cards (a launcher that sets no LOCAL_RANK; a second node
    of one card), and mesh_device gives that same card."""
    import torch.distributed as dist

    from video_depth_anything_torch.parallel import distributed as pdist
    from video_depth_anything_torch.parallel import mesh_device

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    joined, current = [], []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: joined.append((a, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])
    pdist.initialize()
    assert joined == [(("nccl",), {"init_method": "env://", "world_size": -1, "rank": -1})]
    assert current == [card]
    assert mesh_device(types.SimpleNamespace(device_type="cuda")) == torch.device("cuda", card)


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_two_ranks_match_jax_single_device(ranks, jax_refs, case):
    got, _ = ranks
    n = next(n for name, n, _, _ in CASES if name == case)
    a = got[0]["arrays"][case]
    assert a.shape == (n, *HW) and a.dtype == np.float32
    np.testing.assert_allclose(a, jax_refs[n], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_ranks_agree_and_match_one_process(ranks, single, case):
    got, _ = ranks
    a, b = got[0]["arrays"][case], got[1]["arrays"][case]
    np.testing.assert_array_equal(a, b)
    ref = single[case]
    np.testing.assert_allclose(a, ref, rtol=0, atol=1e-5 * float(ref.max() - ref.min()))
    assert [r["info"]["device"] for r in got] == ["cpu", "cpu"]


def test_int8_two_ranks_within_flip_floor_and_one_side_file(ranks, serve_params):
    from video_depth_anything_torch.convert import model_from_params
    from video_depth_anything_torch.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.pipeline.infer import scale_side_file
    from video_depth_anything_torch.utils.precision import flip_floor_report

    got, out = ranks
    assert [r["info"]["calib_writes"] for r in got] == [1, 0]
    assert sorted(p for p in os.listdir(out) if "int8calib" in p) == ["int8calib.npz"]
    np.testing.assert_array_equal(got[0]["arrays"]["int8"], got[1]["arrays"]["int8"])
    _, params = serve_params
    model = model_from_params(params, T_CFG)

    def run(side):
        pipe = VideoDepthPipeline(T_CFG, model, device="cpu", quant="int8", calib_path=side)
        return pipe.infer_video_depth(video(70), input_size=INPUT, fp32=True,
                                      windows_per_batch=2)[0]

    nudged = str(out / "nudged.npz")
    scale_side_file(str(out / "int8calib.npz"), nudged, 1 + 1e-6)
    rep = flip_floor_report(got[0]["arrays"]["int8"], run(str(out / "int8calib.npz")),
                            run(nudged))
    assert rep["ok"], rep


def test_streaming_refused_on_two_ranks_and_batch_bounds(ranks):
    got, _ = ranks
    for r in got:
        info = r["info"]
        assert info["world"] == 2
        assert info["stream"].startswith("multi-host streaming would require feeding every "
                                         "process an identical frame stream")
        assert info["bounds_3"] == (
            "multi-host feeding needs the global batch (= mesh data-axis chunk, 3) to be a "
            "multiple of the process count (2); use a mesh with data >= 2 processes x its "
            "per-chip batch, or run single-host")
        assert info["bounds_4"] == [2 * info["rank"], 2 * info["rank"] + 2]


def test_world1_mesh_equals_no_mesh_and_streams_bit_for_bit(world1, serve_params):
    """C = 2: the mesh of one rank and no mesh run the batched cache on the
    same batches; at C = 1 the mesh still takes the batched cache (never the
    sequential one), which the stream equals."""
    from video_depth_anything_torch.convert import model_from_params
    from video_depth_anything_torch.pipeline import VideoDepthPipeline, infer

    _, params = serve_params
    frames = video(70)
    mesh_pipe = VideoDepthPipeline(T_CFG, model_from_params(params, T_CFG), mesh=world1)
    plain = VideoDepthPipeline(T_CFG, model_from_params(params, T_CFG), device="cpu")
    assert mesh_pipe.device == torch.device("cpu")
    for cache in (True, False):
        a, _ = mesh_pipe.infer_video_depth(frames, input_size=INPUT, fp32=True,
                                           windows_per_batch=2, cache_keyframe_features=cache,
                                           collect_timings=True)
        b, _ = plain.infer_video_depth(frames, input_size=INPUT, fp32=True,
                                       windows_per_batch=2, cache_keyframe_features=cache)
        np.testing.assert_array_equal(a, b)
        # one gather per chunk of depths, and per tap (patch and cls) per encode
        n_gathers = 2 * (1 + 8) if cache else 2
        assert mesh_pipe.timer.summary()["all_gather"]["count"] == n_gathers
    used = []
    real = infer.SequentialKeyframeCache.__init__
    infer.SequentialKeyframeCache.__init__ = lambda self, *a: (used.append(1), real(self, *a))
    try:
        for c in (1, 2):
            batch, _ = mesh_pipe.infer_video_depth(frames, input_size=INPUT, fp32=True,
                                                   windows_per_batch=c)
            stream = np.concatenate(list(mesh_pipe.infer_video_depth_streaming(
                iter(frames), input_size=INPUT, fp32=True, windows_per_batch=c)))
            np.testing.assert_array_equal(stream, batch)
    finally:
        infer.SequentialKeyframeCache.__init__ = real
    assert not used


# ------------------------------------------------------------------ training


def test_two_rank_training_matches_jax_oracle(ranks):
    from test_distributed import _oracle_loss

    got, _ = ranks
    losses = [r["info"]["train_loss"] for r in got]
    assert losses[0] == losses[1]
    assert [r["info"]["train_step"] for r in got] == [TRAIN_STEPS] * 2
    assert [r["info"]["train_rows"] for r in got] == [2, 2]
    oracle = _oracle_loss(TRAIN_STEPS)
    assert abs(losses[0] - oracle) < 5e-4 * max(abs(oracle), 1.0), (losses[0], oracle)
    heads = [{k: v for k, v in r["arrays"].items() if k.startswith("head/")} for r in got]
    assert heads[0] and sorted(heads[0]) == sorted(heads[1])
    for k, v in heads[0].items():
        np.testing.assert_array_equal(v, heads[1][k], err_msg=k)


def test_two_rank_trainer_writes_from_rank0_only(ranks):
    got, out = ranks
    assert [r["info"]["trainer_step"] for r in got] == [1, 1]
    for k, v in got[0]["arrays"].items():
        if k.startswith("trainer/"):
            np.testing.assert_array_equal(v, got[1]["arrays"][k], err_msg=k)
    out_dir = out / "trainer_out"
    recs = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    assert len(recs) == 2 and "train_loss" in recs[0] and "val_loss" in recs[1]
    assert (out_dir / "latest_checkpoint").exists() and (out_dir / "best_checkpoint").exists()


def test_world1_step_equals_no_mesh_step(world1):
    """A distributed step on one rank is the non-distributed step bit for
    bit (loss and every head tensor), from the same state and batch."""
    import copy

    from video_depth_anything_torch.models import build_model
    from video_depth_anything_torch.training import train_state as ts

    model = build_model(TRAIN_CFG, seed=0)
    a = ts.create_train_state(copy.deepcopy(model), train_config())
    b = ts.shard_train_state(ts.create_train_state(model, train_config()), world1)
    batch = {k: torch.from_numpy(v[:2]) for k, v in train_batch().items()}
    for _ in range(2):
        a, ma = ts.train_step(a, batch, TRAIN_CFG, train_config())
        b, mb = ts.train_step(b, batch, TRAIN_CFG, train_config())
        assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for k in a.head:
        assert torch.equal(a.head[k], b.head[k]), k
    # A resumed state's moments and step are broadcast too.
    c = ts.shard_train_state(b, world1)
    assert c.step == 2 and c.opt.state


def test_untiled_train_batch_refused_before_any_step(ranks):
    """A global batch of 3 rows on 2 ranks: shard_batch, which the ranks
    call before their first step, raises JAX's ValueError on each."""
    got, _ = ranks
    for r in got:
        assert r["info"]["untiled_batch"] == (
            "multi-host feeding needs the global batch (= mesh data-axis chunk, 3) to be a "
            "multiple of the process count (2); use a mesh with data >= 2 processes x its "
            "per-chip batch, or run single-host")


# ------------------------------------------------------------------ the mesh itself


def test_model_axis_refused_with_the_roadmap_item(world1):
    """The model axis is ported (tests/test_torch_tensor_parallel.py): on
    one rank a model axis of 2 is refused for want of ranks, as any mesh
    larger than the group is."""
    from video_depth_anything_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="a mesh of 1 x 2 needs 2 ranks"):
        make_mesh(n_model=2)
    assert world1.mesh_dim_names == ("data", "model") and tuple(world1.shape) == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_data=2)


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2])
