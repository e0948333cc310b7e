from .video_depth import (VideoDepthAnything, build_model, init_random, load_numpy_state_dict,
                          numpy_state_dict, state_dict_sha256)

__all__ = ["VideoDepthAnything", "build_model", "init_random", "load_numpy_state_dict",
           "numpy_state_dict", "state_dict_sha256"]
