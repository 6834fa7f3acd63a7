"""utils of the PyTorch/CUDA port (counterpart of leafgrasp_tpu/utils)."""
