"""Benchmark of the PyTorch and CUDA port (`atmvfi_tpu_torch`); see README.md."""
