"""A throwaway copy of the benchmark's files with a tiny cell, for the
CPU tests: the harness runs it on the program's plain path."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

CONFIG = {"source": "a tiny test configuration", "encoder": "tiny", "embed_dim": 64, "depth": 4,
          "num_heads": 1, "mlp_ratio": 4, "patch_size": 14, "img_size": 518,
          "taps": [0, 1, 2, 3], "features": 32, "out_channels": [32, 32, 64, 64],
          "motion_heads": 8, "num_frames": 32, "dtype": "bfloat16", "reduced": [],
          "assumed": {}}
TRAFFIC = {"mode": "infer", "source_hw": [56, 98], "pool_frames": 64,
           "scene": {"grid": [3, 4], "drift": 0.08, "noise": 6.0}, "clip_frames": [24, 50],
           "lengths": 3, "warmup_lengths": [24], "input_size": 28, "windows_per_batch": 1,
           "clients": 1, "profile_s": 0.5}
TRAIN_TRAFFIC = {"mode": "train", "batch": 1, "clip_len": 6, "size": 42, "pool_batches": 4,
                 "scene": {"grid": 6, "drift": 0.5}, "first_steps": 3, "profile_s": 0.5,
                 "train": {"learning_rate": 1e-4, "weight_decay": 1e-4, "epochs": 500,
                           "steps_per_epoch": 100, "ratio_tgm": 10.0, "ssi_variant": "lstsq",
                           "eta_min": 1e-6}}
WORKLOAD = {"config": "tiny", "traffic": "tiny-clips", "chips": 1, "why": "a test",
            "check": {"clips": 2, "from_first": 2}, "limits": {"mean_err_pct": 2.0}}


def make(tmp, name: str = "tiny-cell", config=None, traffic=None, workload=None):
    """A copy of vdabench's data files and BENCHMARK.json under ``tmp``
    with one more cell ``name``, reporting the metrics of the cells of its
    traffic's mode -> (root, benchmark path)."""
    root = os.path.join(tmp, "vdabench")
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = dict(WORKLOAD, **(workload or {}))
    tr = dict(TRAFFIC, **(traffic or {}))
    if (traffic or {}).get("mode") == "train":   # a train cell takes none of the clips' keys
        tr = dict(traffic)
        wl.pop("check")
    files = {("configs", wl["config"]): dict(CONFIG, **(config or {})),
             ("traffic", wl["traffic"]): tr, ("workloads", name): wl}
    for (kind, n), d in files.items():
        with open(os.path.join(root, kind, n + ".json"), "w") as f:
            json.dump(d, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": name, "config": wl["config"], "traffic": wl["traffic"],
                               "chips": 1, "why": "a test"})
    like = "vits-train-518" if files[("traffic", wl["traffic"])]["mode"] == "train" \
        else "vits-720p-shortclips-c4"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root, path
