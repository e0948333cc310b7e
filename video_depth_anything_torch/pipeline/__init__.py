from .infer import VideoDepthPipeline

__all__ = ["VideoDepthPipeline"]
