"""Metric Video Depth Anything: ``run.py`` with ``--metric``.

    python -m video_depth_anything_torch.metric_run --input_video clip.mp4 \\
        --encoder vitl --save_npz --save_exr

The metric model pins the window stitch's scale and shift to 1 and 0
(clamp and cross-fade only); the checkpoint lookup takes the
``metric_video_depth_anything_<encoder>`` files. Every flag of ``run.py``
applies, ``--save_exr`` included.
"""
from __future__ import annotations

import sys

from . import run


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return run.main(["--metric", *argv])


if __name__ == "__main__":
    main()
