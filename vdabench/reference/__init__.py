"""The benchmark's plain PyTorch reference of Video Depth Anything.

It imports nothing of the program under test, nor JAX: ``model.py`` is the
published forward with the original checkpoint's module names,
``pipeline.py`` the published sliding-window inference and stitching.
"""
