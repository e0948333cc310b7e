"""Compare the SASS of each kernel library between two checkouts of the
package: whether a change to shared sources (a header several kernels
include) left a library's compiled instructions as they were.

    python -m video_depth_anything_torch.tools.sass_diff OLD_ROOT NEW_ROOT [LIB ...]

Each root is a checkout's top directory; its own ``kernels/build.py``
builds its libraries (nvcc, into its ``_build/``) and ``cuobjdump -sass``
lists them. Per library it prints the kernels on each side and how many
of their instruction sequences (addresses dropped, kernels paired by
length, names ignored: a template argument added with its default renames
a kernel) are identical. Needs nvcc and cuobjdump, not a card.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

LIBS = ("spatial_attention", "attention_head_major", "fused_rcu", "qk_probes",
        "attention_variants")


def kernels_sass(root: str, name: str) -> list[list[str]]:
    """The instruction sequences of library ``name`` built from ``root``."""
    for mod in [m for m in sys.modules if m.startswith("video_depth_anything_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, root)
    try:
        from video_depth_anything_torch.kernels import build
        build.build_all()
        tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
        out = subprocess.run([tool, "-sass", build._target(name)], capture_output=True,
                             text=True, check=True).stdout
    finally:
        sys.path.remove(root)
    funcs: list[list[str]] = []
    for line in out.splitlines():
        if "Function : " in line:
            funcs.append([])
        elif funcs and re.search(r"/\*[0-9a-f]{4}\*/", line):
            funcs[-1].append(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0].strip())
    return sorted(funcs, key=len)


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old_root, new_root = (os.path.abspath(r) for r in sys.argv[1:3])
    for name in sys.argv[3:] or LIBS:
        old, new = kernels_sass(old_root, name), kernels_sass(new_root, name)
        same = sum(a == b for a, b in zip(old, new))
        print(f"{name}: {len(old)} kernels old, {len(new)} new; instruction sequences "
              f"identical: {same} of {max(len(old), len(new))}; instructions "
              f"{sum(map(len, old))} old, {sum(map(len, new))} new", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
