from .video_depth import VideoDepthAnything, build_model, init_random

__all__ = ["VideoDepthAnything", "build_model", "init_random"]
