"""The benchmark's files, found by name.

- ``configs/<config>.json``: a model configuration (widths, depth, taps,
  served dtype, the published source, ``reduced`` and ``assumed``);
- ``traffic/<traffic>.json``: a traffic mix; its ``mode`` names the module
  of this package that runs it (``infer.py``, ``train.py``), whose
  ``validate`` refuses any key it does not take;
- ``workloads/<cell>.json``: a cell: its config, its traffic, its chips,
  its ``why`` and the limits of the numbers its correctness check compares;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``. A
  quantity that is split by the end-to-end metric it moves
  (``mfu.train``, ``kernel.k1_roofline.short``) is read by the file of
  its name, or, where there is none, of its name without the last
  dotted part (``mfu.py``, ``kernel.k1_roofline.py``);
- ``BENCHMARK.json`` at the root of the checkout: which end-to-end and
  per-layer metrics each cell reports.

A new configuration, traffic mix, cell or per-layer metric is a new file
here and an entry in ``BENCHMARK.json``; no code changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load(kind: str, name: str, root: str = HERE) -> dict:
    path = os.path.join(root, kind, name + ".json")
    with open(path) as f:
        d = json.load(f)
    d["name"] = name
    return d


def reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why", "check", "limits"}


def load_cell(name: str, root: str = HERE, benchmark: str | None = None) -> Cell:
    """The cell ``name`` with its config, traffic and metrics. ``root`` is
    the benchmark's folder, ``benchmark`` the BENCHMARK.json to read
    (default: the one beside ``root``)."""
    workload = _load("workloads", name, root)
    if set(workload) - WORKLOAD_KEYS:
        raise ValueError(f"{name}: keys a cell does not take: "
                         f"{sorted(set(workload) - WORKLOAD_KEYS)}")
    bench_path = benchmark or os.path.join(os.path.dirname(root), "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    return Cell(name=name, config=_load("configs", workload["config"], root),
                traffic=_load("traffic", workload["traffic"], root), workload=workload,
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def mode_module(cell: Cell):
    """The module of this package named by the traffic's ``mode``."""
    mode = cell.traffic["mode"]
    if not mode.isidentifier() or mode.startswith("_"):
        raise ValueError(f"{cell.name}: mode {mode!r} names no module")
    return importlib.import_module(f"{__package__}.{mode}")


def metric_file(name: str, root: str = HERE) -> str:
    """``metrics/<name>.py``, or that of the name without its last dotted
    part; FileNotFoundError where neither exists."""
    for stem in (name, name.rpartition(".")[0]):
        path = os.path.join(root, "metrics", stem + ".py")
        if stem and os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r} in {root}/metrics")


def metric_reader(name: str, root: str = HERE):
    """The ``read(ctx)`` function of the metric's file (``metric_file``; a
    file name may hold dots, so it is loaded by path)."""
    path = metric_file(name, root)
    spec = importlib.util.spec_from_file_location(f"vdabench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
