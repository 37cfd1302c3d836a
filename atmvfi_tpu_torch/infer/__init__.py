"""Inference entry points of the port."""
from atmvfi_tpu_torch.infer.padder import InputPadder
from atmvfi_tpu_torch.infer.pipeline import InterpolationPipeline, load_pipeline

__all__ = ["InputPadder", "InterpolationPipeline", "load_pipeline"]
