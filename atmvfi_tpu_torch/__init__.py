"""PyTorch/CUDA port of atmvfi_tpu (ATM-VFI frame interpolation).

Mirrors the JAX package's module layout (`ops/`, `models/`, `infer/`,
`evalkit/`, `losses/`, `train/`, `data/`, `convert`) and keeps its
public NHWC layouts. The two TPU kernels of the two-frame serving path
are hand-written CUDA C++ for sm_90a (`csrc/`): the fused ATM
transformer block (`ops.attention_cuda`) and the bilinear backward warp
(`ops.warp_cuda`). Each has a plain PyTorch version beside it, which
runs for tensors on the CPU.

Imports torch and numpy only; nothing of JAX or of `atmvfi_tpu`.
"""
