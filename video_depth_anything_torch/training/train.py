"""Training driver (the port of the JAX package's ``training/train.py``).

yaml config -> VKITTI (+ optional Google Landmarks) loaders -> frozen
encoder, AdamW + cosine LR over the head -> train steps at the compute
dtype with fp32 masters -> per-epoch validation (clip lstsq AbsRel /
delta1 / TAE) -> best / latest checkpoints with early-stop patience.

    python -m video_depth_anything_torch.training.train --data_root VKITTI \\
        [--config configs/config.yaml] [--out_dir ./train_out] [--resume]

Runs on ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
path); ``--compile_cache [DIR]`` (or ``VDA_COMPILE_CACHE``) keeps the
nvcc-built kernel libraries in a shared directory
(``utils/compile_cache.py``). The datasets read PIL images and the config is yaml, so the
machine needs PIL and PyYAML; validation pictures need cv2. The model
starts from ``init_random``'s seeded weights (seed 0), as the JAX driver
starts from ``init_params(0, cfg)``.

``--distributed`` is data parallelism over torch.distributed, one device
per rank, launched by torchrun:

    torchrun --nproc_per_node N -m video_depth_anything_torch.training.train \
        --distributed --data_root VKITTI [--device cpu]

Each rank loads its shard of the training set (``batch_size`` rows a step;
the global batch is N x that), the state is rank 0's
(``train_state.shard_train_state``) and the head's gradients are averaged
over the ranks; rank 0 alone writes checkpoints, pictures and logs. NCCL
on ``cuda``, gloo on ``cpu``.

``train(mesh=make_mesh(n_data, n_model))`` adds the model axis: the
state is split over "model" (tensor parallelism), the shards of the
training set follow the data axis (the ranks of a model group load the
same rows), and a checkpoint holds the gathered whole tensors (every rank
gathers, rank 0 writes), so it loads into a model without a mesh, and a
checkpoint written without one resumes onto the axis. Validation runs on
every rank over the same clips, on the split model.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

_BATCH_KEYS = ("video", "gt", "mask", "image_video", "image_gt", "image_mask")


class MetricsLogger:
    """stdout + a JSONL file (one record per log call)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")

    def log(self, metrics: dict, step: int):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(" ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in rec.items()))


def train(config_path: str = "configs/config.yaml", data_root: str = None,
          google_image_root: str = None, google_depth_root: str = None,
          out_dir: str = "./train_out", max_steps: int = -1,
          resume: bool = False, mesh=None, model_cfg=None,
          resize_size: int = 518, distributed: bool = False, device=None):
    """The JAX driver's loop; ``device`` as the pipeline resolves it
    (``cuda`` unless the caller asks for the CPU; on a mesh, this rank's).
    ``distributed`` joins the process group (``parallel.distributed.
    initialize``: torchrun's environment, else one process) and trains on
    its global mesh; ``mesh`` is a mesh already made (data and model
    axes). Returns the TrainState."""
    import yaml

    import torch
    import torch.distributed as dist

    from ..config import get_model_config
    from ..data import CombinedDataset, DataLoader, VKITTIVideoDataset
    from ..models import build_model
    from ..parallel import data_rank, data_size, mesh_device
    from ..parallel import distributed as pdist
    from ..pipeline.infer import resolve_device
    from . import checkpoint as ckpt
    from . import train_state as ts
    from .validate import metric_val

    if distributed:
        pdist.initialize(device=device)
        if mesh is None and dist.is_initialized():
            mesh = pdist.global_mesh()
    # The training set is cut over the data axis: the ranks of one model
    # group load the same rows.
    nproc = data_size(mesh) if mesh is not None else 1
    rank = data_rank(mesh) if mesh is not None else 0
    proc0 = mesh is None or dist.get_rank() == 0
    device = resolve_device(device if device is not None or mesh is None else mesh_device(mesh))
    with open(config_path) as f:
        hp = yaml.safe_load(f)["hyper_parameter"]

    clip_len = int(hp.get("clip_len", 20))
    cfg = model_cfg or get_model_config(hp.get("encoder", "vits"), num_frames=clip_len)
    clip_len = cfg.num_frames
    batch_size = int(hp.get("batch_size", 1))
    # JAX checks here that the global batch divides over the data axis
    # (its train.py:63-80). With one device per rank the data axis is
    # nproc wide, so nproc x batch_size always divides; nothing to check.
    patience = int(hp.get("patient", 5))

    train_ds = VKITTIVideoDataset(data_root, clip_len=clip_len, split="train",
                                  resize_size=resize_size)
    val_ds = VKITTIVideoDataset(data_root, clip_len=clip_len, split="val",
                                resize_size=resize_size)
    if google_image_root:
        train_ds = CombinedDataset(train_ds, google_image_root, google_depth_root)
    # Each rank loads batch_size rows of its shard; the global batch is
    # nproc x that. Validation is not sharded: every rank walks the same
    # clips, so the ranks stay in step.
    train_loader = DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                              num_shards=nproc, shard_id=rank)
    val_loader = DataLoader(val_ds, batch_size=1, shuffle=False)

    # Cosine horizon = epochs * the loader's real steps per epoch.
    tc = ts.TrainConfig(
        learning_rate=float(hp.get("learning_rate", 1e-4)),
        epochs=int(hp.get("epochs", 500)),
        steps_per_epoch=max(len(train_loader), 1),
        ratio_ssi=float(hp.get("ratio_ssi", 1.0)),
        ratio_tgm=float(hp.get("ratio_tgm", 10.0)),
        ratio_ssi_image=float(hp.get("ratio_ssi_image", 0.5)),
        ssi_variant=hp.get("ssi_variant", "lstsq"),
        compute_dtype=hp.get("compute_dtype", "bfloat16"),
    )

    state = ts.create_train_state(build_model(cfg, seed=0, device=device), tc)
    logger = MetricsLogger(out_dir) if proc0 else None

    start_epoch, best_val, trial = 0, float("inf"), 0
    if resume:
        restored = ckpt.load_checkpoint(out_dir, "latest_checkpoint", template=state)
        if restored is not None:
            extra = restored["extra"]
            start_epoch = int(extra["epoch"]) + 1
            best_val = float(extra["best_val_loss"])
            trial = int(extra["trial"])
            print(f"resumed from epoch {start_epoch}")
    if mesh is not None:    # the fresh or resumed state, rank 0's on every rank
        ts.shard_train_state(state, mesh)

    step_count = 0
    for epoch in range(start_epoch, tc.epochs):
        step_losses = []   # 0-d device tensors, read once per epoch
        nb = 0
        for batch in train_loader:
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
                     if k in _BATCH_KEYS}
            state, metrics = ts.train_step(state, batch, cfg, tc)
            step_losses.append(metrics["loss"])
            nb += 1
            step_count += 1
            if max_steps > 0 and step_count >= max_steps:
                break
        epoch_loss = float(torch.stack(step_losses).sum()) if step_losses else 0.0
        if proc0:
            logger.log({"train_loss": epoch_loss / max(nb, 1), "epoch": epoch}, step_count)

        # -- validation --
        val_losses, absrels, delta1s, taes = [], [], [], []
        first_val = True
        for batch in val_loader:
            jb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
                  if k in ("video", "gt", "mask")}
            val_losses.append(float(ts.eval_step(state, jb, cfg, tc)["loss"]))
            with torch.no_grad():
                pred = ts.forward(state, jb["video"], cfg).cpu().numpy()
            a, d1, t = metric_val(pred[0], batch["depth"][0],
                                  batch["extrinsics"][0], batch["intrinsics"][0])
            absrels.append(a), delta1s.append(d1), taes.append(t)
            if first_val and proc0:
                from .visualize import dump_val_frames
                dump_val_frames(os.path.join(out_dir, "val_vis"), epoch,
                                batch["video"][0], batch["gt"][0],
                                batch["mask"][0], pred[0])
            first_val = False
        val_loss = float(np.mean(val_losses)) if val_losses else float("inf")
        if proc0:
            logger.log({"val_loss": val_loss, "absrel": np.mean(absrels),
                        "delta1": np.mean(delta1s), "tae": np.mean(taes),
                        "epoch": epoch}, step_count)

        # best / trial before latest_checkpoint, so a resume restores this
        # epoch's post-validation counters.
        improved = val_loss < best_val
        if improved:
            best_val, trial = val_loss, 0
        else:
            trial += 1
        extra = {"epoch": epoch, "best_val_loss": best_val, "trial": trial}
        # Every rank gathers the state (a collective under a model axis);
        # rank 0 writes it.
        ckpt.save_checkpoint(out_dir, "latest_checkpoint", state, extra, write=proc0)
        if improved:
            ckpt.save_checkpoint(out_dir, "best_checkpoint", state, extra, write=proc0)
        if not improved and trial >= patience:
            print(f"early stop at epoch {epoch} (patience {patience})")
            break
        if max_steps > 0 and step_count >= max_steps:
            break
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--google_image_root", default=None)
    parser.add_argument("--google_depth_root", default=None)
    parser.add_argument("--out_dir", default="./train_out")
    parser.add_argument("--max_steps", type=int, default=-1)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; under --distributed this rank's card, NCCL) "
                             "or cpu (the plain PyTorch path; gloo)")
    parser.add_argument("--distributed", action="store_true",
                        help="data parallelism over the ranks torchrun starts: "
                             "torch.distributed, a global mesh, per-rank data shards")
    parser.add_argument("--compile_cache", type=str, nargs="?", const="", default=None,
                        metavar="DIR",
                        help="keep the nvcc-built kernel libraries in DIR (default "
                             "~/.cache/video_depth_anything_torch/kernels when given "
                             "without DIR), shared across processes and checkouts; "
                             "without the flag VDA_COMPILE_CACHE is honoured")
    args = parser.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache, maybe_enable_from_env

    if args.compile_cache is not None:   # before the first kernel call builds
        print(f"kernel build cache: {enable_compile_cache(args.compile_cache)}")
    elif (cache := maybe_enable_from_env()) is not None:
        print(f"kernel build cache (VDA_COMPILE_CACHE): {cache}")
    train(args.config, args.data_root, args.google_image_root,
          args.google_depth_root, args.out_dir, args.max_steps, args.resume,
          distributed=args.distributed, device=args.device)


if __name__ == "__main__":
    main()
