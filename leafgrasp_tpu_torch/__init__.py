"""leafgrasp_tpu_torch: the PyTorch/CUDA port of leafgrasp_tpu.

Mirrors the JAX package's layout (config, ops, geometry, models,
pipeline) and adds ``kernels/``: the hand-written CUDA kernels for
Hopper that replace the JAX package's Pallas kernels, each beside its
plain PyTorch version. Imports torch, numpy and the standard library
only. The entry point is ``pipeline.frame.make_frame_fn``.
"""
