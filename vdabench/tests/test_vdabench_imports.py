"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: each checked by the whole
top-level name of every module in ``sys.modules`` of a fresh process."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from vdabench import run
from vdabench.tests import tiny

PROGRAM = "video_depth_anything_torch"


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    root, bench = tiny.make(str(tmp_path))
    tops = _loaded(
        "import glob, os, torch\n"
        "torch.set_num_threads(2)\n"
        "import vdabench.run, vdabench.infer, vdabench.readings, vdabench.counts\n"
        "from vdabench import spec\n"
        f"line = vdabench.run.run_cell('tiny-cell', 5, 0.5, True, device='cpu', root={root!r},"
        f" benchmark={bench!r}, setup_clock=lambda: 0.0)\n"
        "for f in glob.glob(os.path.join(spec.HERE, 'metrics', '*.py')):\n"
        "    spec.metric_reader(os.path.basename(f)[:-3])\n"
        "assert line['attempted'] > 0\n")
    assert PROGRAM in tops
    assert not tops & set(run.FORBIDDEN)


def test_the_reference_loads_neither_the_program_nor_jax():
    tops = _loaded("import vdabench.reference.model, vdabench.reference.pipeline")
    assert not tops & {PROGRAM, *run.FORBIDDEN}


def test_the_reference_imports_nothing_of_the_program_by_name():
    ref_dir = os.path.join(tiny.HERE, "reference")
    for fname in os.listdir(ref_dir):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                if isinstance(node, ast.ImportFrom) and node.level:
                    continue    # relative: inside the reference
                assert n.split(".")[0] not in {PROGRAM, "vdabench", *run.FORBIDDEN}, (fname, n)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "video_depth_anything_tpu_x.y", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]
