"""Command-line entry points of the port (`python -m atmvfi_tpu_torch.cli.<name>`)."""
