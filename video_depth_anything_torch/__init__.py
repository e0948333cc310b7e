"""Video Depth Anything on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package beside it: same models, same
sliding-window pipeline, same public layouts (NHWC maps, ``[B, S, C]``
tokens, ``[P, T, C]`` temporal tokens). Spatial attention (head-major
attention for head dims other than 64), its int8-QK form (``--int8``),
temporal attention, fused-qkv attention and the opt-in fused residual conv
unit run hand-written CUDA kernels (``kernels/``, sources in ``csrc/``) on
the card; the int8 products are ``torch._int_mm``; every other op is plain
PyTorch. Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
