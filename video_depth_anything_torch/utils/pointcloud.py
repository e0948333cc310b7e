"""Metric depth -> point clouds, written as binary PLY.

The port's own copy of the JAX package's ``utils/pointcloud.py``: pinhole
unprojection with the principal point at the image centre, and a binary
little-endian PLY of float xyz (and uchar rgb), the point cloud the
reference's open3d writer produces.
"""
from __future__ import annotations

import numpy as np


def unproject_depth(depth: np.ndarray, focal_x: float, focal_y: float,
                    color: np.ndarray | None = None):
    """depth [H, W] -> (points [H*W, 3], colors [H*W, 3] in 0..1 or None)."""
    h, w = depth.shape
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    x = (x - w / 2) / focal_x
    y = (y - h / 2) / focal_y
    points = np.stack((x * depth, y * depth, depth), axis=-1).reshape(-1, 3)
    colors = None
    if color is not None:
        colors = color.reshape(-1, 3).astype(np.float64) / 255.0
    return points, colors


_VERTEX = [("xyz", "<f4", 3), ("rgb", "u1", 3)]


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY with float xyz (and uchar rgb from colors in 0..1)."""
    n = points.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    pts = points.astype("<f4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(pts.tobytes())
        else:
            rec = np.zeros(n, dtype=_VERTEX)
            rec["xyz"] = pts
            rec["rgb"] = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
            f.write(rec.tobytes())


def read_ply(path: str):
    """A PLY written by ``write_ply`` -> (points [N, 3] float32, colors
    [N, 3] in 0..1 or None)."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    n = int(next(ln for ln in header if ln.startswith("element vertex")).split()[-1])
    if any("red" in ln for ln in header):
        rec = np.frombuffer(raw, dtype=_VERTEX, count=n, offset=end)
        return rec["xyz"].copy(), rec["rgb"].astype(np.float64) / 255.0
    return np.frombuffer(raw, "<f4", count=3 * n, offset=end).reshape(n, 3).copy(), None
