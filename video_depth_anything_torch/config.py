"""Model and inference configuration tables.

The port's own copy of the JAX package's tables (model configs of the
reference run.py, encoder defaults of the DINOv2 factory, and the
sliding-window constants the reference marks "do not change").
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# Sliding-window inference constants.
INFER_LEN = 32          # frames per window
OVERLAP = 10            # re-injected keyframe inputs per window
KEYFRAMES = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)
INTERP_LEN = 8          # cross-faded overlap frames
FRAME_STEP = INFER_LEN - OVERLAP   # 22 new frames per window
ALIGN_LEN = OVERLAP - INTERP_LEN   # 2 frames used for affine alignment

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """DINOv2 encoder configuration."""
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    patch_size: int = 14
    img_size: int = 518
    init_values: float = 1.0          # LayerScale init
    interpolate_offset: float = 0.1   # pos-embed interpolation quirk
    ffn_layer: str = "mlp"            # "mlp" | "swiglufused"
    num_register_tokens: int = 0

    @property
    def num_patches(self) -> int:
        g = self.img_size // self.patch_size
        return g * g

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


VIT_CONFIGS = {
    "vits": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vitb": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vitl": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "vitg": ViTConfig(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full VideoDepthAnything configuration."""
    encoder: str = "vitl"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    use_bn: bool = False
    use_clstoken: bool = False
    num_frames: int = INFER_LEN
    pe: str = "ape"                      # temporal positional embedding
    num_attention_heads: int = 8
    num_transformer_block: int = 1
    num_attention_blocks: int = 2
    metric: bool = False                 # metric model: identity stitching
    taps: Tuple[int, ...] = ()           # override feature-tap layer indices
    vit_override: Optional[ViTConfig] = None   # tiny test encoders

    @property
    def vit(self) -> ViTConfig:
        if self.vit_override is not None:
            return self.vit_override
        return VIT_CONFIGS[self.encoder]

    @property
    def intermediate_layer_idx(self) -> List[int]:
        if self.taps:
            return list(self.taps)
        return {
            "vits": [2, 5, 8, 11],
            "vitb": [2, 5, 8, 11],
            "vitl": [4, 11, 17, 23],
            "vitg": [9, 19, 29, 39],
        }[self.encoder]


MODEL_CONFIGS = {
    "vits": ModelConfig(encoder="vits", features=64, out_channels=(48, 96, 192, 384)),
    "vitb": ModelConfig(encoder="vitb", features=128, out_channels=(96, 192, 384, 768)),
    "vitl": ModelConfig(encoder="vitl", features=256, out_channels=(256, 512, 1024, 1024)),
    "vitg": ModelConfig(encoder="vitg", features=384, out_channels=(1536, 1536, 1536, 1536)),
}


def get_model_config(encoder: str, metric: bool = False, **overrides) -> ModelConfig:
    base = MODEL_CONFIGS[encoder]
    return dataclasses.replace(base, metric=metric, **overrides)
