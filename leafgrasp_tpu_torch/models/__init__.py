"""models of the PyTorch/CUDA port (counterpart of leafgrasp_tpu/models)."""
