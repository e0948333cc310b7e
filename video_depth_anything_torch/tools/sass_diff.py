"""Compare the SASS of each kernel library between two checkouts of the
package: whether a change to shared sources (a header several kernels
include) left a library's compiled instructions as they were.

    python -m video_depth_anything_torch.tools.sass_diff OLD_ROOT NEW_ROOT [LIB ...]

Each root is a checkout's top directory; its own ``kernels/build.py``
builds its libraries (nvcc, into its ``_build/``) and ``cuobjdump -sass``
lists them. Per library it prints the kernels on each side and how many
of each side's instruction sequences (addresses dropped, names ignored: a
template argument added with its default renames a kernel) occur
unchanged on the other side: "old kept" counts the old kernels whose
exact instructions the new library still holds, "new seen" the new
kernels that the old library already held. A library missing on one side
counts as empty. Needs nvcc and cuobjdump, not a card.
"""
from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys

LIBS = ("spatial_attention", "attention_head_major", "fused_rcu", "qk_probes",
        "attention_variants", "spatial_attention_qk8", "temporal_attention", "phase_probes",
        "attention_switches", "temporal_attention_backward")


def kernels_sass(root: str, name: str) -> list[tuple[str, list[str]]]:
    """(mangled name, instruction sequence) of each kernel of library
    ``name`` built from ``root``."""
    for mod in [m for m in sys.modules if m.startswith("video_depth_anything_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, root)
    try:
        from video_depth_anything_torch.kernels import build
        if name not in build.SOURCES:
            return []
        build.build_all()
        tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
        out = subprocess.run([tool, "-sass", build._target(name)], capture_output=True,
                             text=True, check=True).stdout
    finally:
        sys.path.remove(root)
    funcs: list[tuple[str, list[str]]] = []
    for line in out.splitlines():
        if "Function : " in line:
            funcs.append((line.split("Function : ")[1].strip(), []))
        elif funcs and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            funcs[-1][1].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip())
    return funcs


def report_changed(old, new) -> None:
    """Each old kernel whose instructions the new library no longer holds,
    beside the new kernel of the same template whose length is nearest
    (a template argument added with its default extends the mangled name):
    the count of differing lines and the first of them."""
    kept = [f for _, f in new]
    for name, instrs in old:
        if instrs in kept:
            continue
        stem = name.split("EEv")[0]
        cands = [(n, f) for n, f in new if n.startswith(stem)] or new
        if not cands:
            print(f"  changed: {name}: no counterpart", flush=True)
            continue
        n, f = min(cands, key=lambda c: abs(len(c[1]) - len(instrs)))
        diff = [ln for ln in difflib.unified_diff(instrs, f, lineterm="", n=0)
                if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        print(f"  changed: {name} ({len(instrs)}) -> {n} ({len(f)}): {len(diff)} lines differ; "
              f"first: " + " | ".join(diff[:24]), flush=True)


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old_root, new_root = (os.path.abspath(r) for r in sys.argv[1:3])
    for name in sys.argv[3:] or LIBS:
        old, new = kernels_sass(old_root, name), kernels_sass(new_root, name)
        kept = sum(f in [g for _, g in new] for _, f in old)
        seen = sum(f in [g for _, g in old] for _, f in new)
        print(f"{name}: {len(old)} kernels old, {len(new)} new; old kept {kept} of {len(old)}, "
              f"new seen {seen} of {len(new)}; instructions {sum(len(f) for _, f in old)} old, "
              f"{sum(len(f) for _, f in new)} new", flush=True)
        report_changed(old, new)
    return 0


if __name__ == "__main__":
    sys.exit(main())
