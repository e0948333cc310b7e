"""The benchmark of ``video_depth_anything_torch`` (see README.md)."""
