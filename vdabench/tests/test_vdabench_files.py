"""Every file of the benchmark resolves by name, and BENCHMARK.json keeps
to the contract's shape."""
from __future__ import annotations

import json
import os
import re

import pytest

from vdabench import spec
from vdabench.tests import tiny

with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vdabench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert os.path.getsize(os.path.join(tiny.ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"vdabench/configs/{config}.json"
    with open(os.path.join(tiny.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["embed_dim"] % cfg["num_heads"] == 0 and len(cfg["out_channels"]) == 4


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_resolve(cell):
    c = spec.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (c.workload["config"], c.workload["traffic"]) == (entry["config"], entry["traffic"])
    assert c.workload["chips"] == entry["chips"] == 1 and c.workload["why"] == entry["why"]
    assert len(entry["why"]) <= 200
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    moved = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in moved for m in c.per_layer)
    assert c.per_layer and c.workload["limits"]
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_every_metric_file_is_named_in_the_benchmark():
    """Each per-layer metric has a reader, and each reader file reads some
    metric (a quantity split by the metric it moves shares one file)."""
    files = {f for f in os.listdir(os.path.join(spec.HERE, "metrics")) if f.endswith(".py")}
    used = {os.path.basename(spec.metric_file(m["name"])) for m in BENCH["per_layer"]}
    assert used == files


def test_a_split_metric_reads_its_quantitys_file(tmp_path):
    assert spec.metric_file("kernel.k1_roofline.short").endswith("/kernel.k1_roofline.py")
    assert spec.metric_file("mfu.train").endswith("/mfu.train.py")
    assert spec.metric_file("mfu.short").endswith("/mfu.py")
    with pytest.raises(FileNotFoundError):
        spec.metric_file("no.such_metric")


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_mode_is_the_module_of_its_name():
    from vdabench import infer, train

    assert spec.mode_module(spec.load_cell("vitl-720p-clips")) is infer
    assert spec.mode_module(spec.load_cell("vits-train-518")) is train


@pytest.mark.parametrize("kind,key", [("traffic", "speed"), ("config", "quantized"),
                                      ("pipeline", "metric"), ("workload", "clients")])
def test_a_key_the_harness_does_not_take_is_refused(tmp_path, kind, key):
    over = {"traffic": {}, "config": {}, "workload": {}}
    if kind == "pipeline":
        over["traffic"] = {"pipeline": {key: True}}
    else:
        over[kind] = {key: 1}
    root, bench = tiny.make(str(tmp_path), **over)
    cell = spec.load_cell("tiny-cell", root, bench) if kind != "workload" else None
    with pytest.raises(ValueError):
        if cell is None:
            spec.load_cell("tiny-cell", root, bench)
        else:
            spec.mode_module(cell).validate(cell)
