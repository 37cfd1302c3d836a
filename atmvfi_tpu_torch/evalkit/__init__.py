"""Evaluation: metrics and the benchmark protocol runners."""

from atmvfi_tpu_torch.evalkit.metrics import ie, msssim, psnr, ssim, ssim_matlab

__all__ = ["ie", "msssim", "psnr", "ssim", "ssim_matlab"]
