"""Part of the PyTorch / CUDA port (see ``msmd_tpu_torch``)."""
