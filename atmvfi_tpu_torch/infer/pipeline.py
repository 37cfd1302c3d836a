"""Inference pipeline: padded two-frame interpolation and streaming.

Counterpart of `atmvfi_tpu/infer/pipeline.py::InterpolationPipeline`,
with the multiscale global-motion ensemble and multi-device serving over
a device grid (`parallel.make_mesh`): the row-sharded schedule
(`parallel.make_spatial_forward`) for a grid with more than one
'spatial' shard, the batch split (`parallel.make_dp_forward`) for one
with only 'data' shards. Frames go to the device once and stay there
between the steps of a stream and of the 4x / 8x recursion; only uint8
frames cross to the host. A stream may pack several consecutive pairs
into one forward (`interpolate_stream_batched`), and the attention
window sizes may change at run time (`set_window_sizes`). The default working type is bf16, as in the
JAX pipeline; `dtype=torch.float32` is the parity mode.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Union

import numpy as np
import torch

from atmvfi_tpu_torch.infer.padder import InputPadder
from atmvfi_tpu_torch.models import ATMVFIConfig, Network, get_config
from atmvfi_tpu_torch.parallel import (
    DATA_AXIS,
    SPATIAL_AXIS,
    make_dp_forward,
    make_spatial_forward,
)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; raises for CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU)")
    return dev


class InterpolationPipeline:
    """Model variant + weights -> frame interpolator.

    state_dict: the port's weights (`convert.load_checkpoint`,
    `convert.params_from_jax`); None keeps the seeded random weights of
    `torch.Generator().manual_seed(0)`. `variant` is "base", "lite" or
    an `ATMVFIConfig` (which carries the route fields). `fast=True`
    applies the serving profile `ATMVFIConfig.fast()`: composed
    full-resolution warps, a small documented deviation from the
    default forward.

    `mesh` (`parallel.make_mesh`; a device may repeat, so n shards can
    share one card) replaces `device`: frames live on its first device.
    With more than one 'spatial' shard (`spmd="spatial"`) each pair is
    split into row slabs (B == 1; `pad_divisor` must be a multiple of 8
    x the shard count); with 'data' shards only, the batch is split.
    `spmd="gspmd"` (JAX's automatic partitioner) has no counterpart.
    """

    def __init__(self, state_dict: Optional[dict] = None,
                 variant: Union[str, ATMVFIConfig] = "base",
                 dtype: torch.dtype = torch.bfloat16,
                 global_motion: bool = True,
                 ensemble_global_motion: bool = False,
                 pad_divisor: int = 64, device="cuda", fast: bool = False,
                 mesh=None, spmd: str = "spatial"):
        if ensemble_global_motion and not global_motion:
            raise ValueError("the ensemble estimates global motion: it "
                             "needs global_motion=True")
        self._forward = None
        n_sp = n_dp = 1
        if mesh is not None:
            n_sp, n_dp = mesh.shape[SPATIAL_AXIS], mesh.shape[DATA_AXIS]
            if spmd == "gspmd":
                raise NotImplementedError(
                    "spmd='gspmd' (an automatically partitioned forward) "
                    "is not ported; use spmd='spatial'")
            if spmd != "spatial":
                raise ValueError(f"unknown spmd mode {spmd!r}")
            if n_sp > 1 and n_dp > 1:
                raise ValueError(f"mesh {mesh.shape}: split either the rows "
                                 "('spatial') or the batch ('data')")
            if pad_divisor % (8 * n_sp):
                raise ValueError(
                    f"pad_divisor {pad_divisor} must be a multiple of 8 x "
                    f"the {n_sp} spatial shards, so padded heights split "
                    "into 8-row units")
            device = mesh.devices[0][0]
        self.device = resolve_device(device)
        cfg = (get_config(variant) if isinstance(variant, str) else variant)
        self.cfg = cfg.with_dtype(dtype)
        if fast:
            self.cfg = self.cfg.fast()
        net = Network(self.cfg, torch.Generator().manual_seed(0))
        if state_dict is not None:
            net.load_state_dict(state_dict, strict=True)
        self.net = net.to(self.device).eval()
        self.global_motion = global_motion
        self.ensemble = ensemble_global_motion
        self.pad_divisor = pad_divisor
        self.mesh = mesh
        self._n_sp, self._n_dp = n_sp, n_dp
        if n_dp > 1 and ensemble_global_motion:
            raise NotImplementedError("the batch split runs without the "
                                      "ensemble")
        self._forward = self._mesh_forward()

    def _mesh_forward(self):
        """The mesh's serving schedule around `self.net` (None without
        one): row-sharded over 'spatial' shards, else the batch split."""
        if self._n_sp > 1:
            return make_spatial_forward(
                self.net, self.mesh, global_motion=self.global_motion,
                ensemble_global_motion=self.ensemble)
        if self._n_dp > 1:
            return make_dp_forward(self.net, self.mesh, self.global_motion)
        return None

    def set_window_sizes(self, local: Optional[int] = None,
                         global_: Optional[int] = None,
                         enhance: Optional[int] = None) -> None:
        """Other attention window sizes, the weights kept: a new
        `Network` from `cfg.with_windows(...)` on the same device takes
        the current weights (strict), and the mesh schedule is rebuilt
        around it. The kernels' weight packs are cached per weight
        tensor, so the new network's are made anew."""
        self.cfg = self.cfg.with_windows(local, global_, enhance)
        net = Network(self.cfg).to(self.device).eval()
        net.load_state_dict(self.net.state_dict(), strict=True)
        self.net = net
        self._forward = self._mesh_forward()

    @property
    def shard_devices(self) -> List[torch.device]:
        """The device of each shard (one entry without a mesh)."""
        if self.mesh is None:
            return [self.device]
        axis = SPATIAL_AXIS if self.mesh.shape[SPATIAL_AXIS] > 1 else DATA_AXIS
        return self.mesh.axis_devices(axis)

    @torch.inference_mode()
    def interpolate_device(self, im0: torch.Tensor,
                           im1: torch.Tensor) -> torch.Tensor:
        """Padded NHWC float frames on the device -> middle frame (f32)."""
        if self._forward is not None:
            return self._forward(im0, im1)
        out = self.net(im0, im1, global_motion=self.global_motion,
                       ensemble_global_motion=self.ensemble)
        return torch.clamp(out["I_t"], 0.0, 1.0).float()

    def _upload(self, frame: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.require(frame, requirements=["C", "W"]))
        x = x.to(self.device)
        return x.float()[None] / 255.0

    @staticmethod
    def _to_uint8(x: torch.Tensor) -> np.ndarray:
        return (torch.round(torch.clamp(x[0], 0, 1) * 255.0)
                .to(torch.uint8).cpu().numpy())

    def interpolate(self, img0: np.ndarray, img1: np.ndarray) -> np.ndarray:
        """uint8 RGB [H, W, 3] x2 -> uint8 middle frame: /255, replicate
        pad to `pad_divisor`, forward, unpad, round."""
        x0, x1 = self._upload(img0), self._upload(img1)
        padder = InputPadder(x0.shape, divisor=self.pad_divisor)
        x0, x1 = padder.pad(x0, x1)
        return self._to_uint8(padder.unpad(self.interpolate_device(x0, x1)))

    def interpolate_stream(self, frames: Iterable[np.ndarray],
                           factor: int = 2) -> Iterator[np.ndarray]:
        """Nx interpolation over uint8 frames: yields `factor` frames per
        input step, then the last source frame; one pair a forward."""
        return self.interpolate_stream_batched(frames, factor, batch=1)

    def interpolate_stream_batched(self, frames: Iterable[np.ndarray],
                                   factor: int = 2,
                                   batch: int = 4) -> Iterator[np.ndarray]:
        """`interpolate_stream` with `batch` consecutive pairs in one
        forward: the same frames in the same order, within the float
        noise of another batch size (sums in another order)."""
        return (self._to_uint8(x) for x in
                self.interpolate_stream_device(frames, factor, batch))

    def interpolate_stream_device(self, frames: Iterable[np.ndarray],
                                  factor: int = 2,
                                  batch: int = 1) -> Iterator[torch.Tensor]:
        """The frames of `interpolate_stream_batched` as f32 [1, H, W, 3]
        tensors in [0, 1] on the device, before the rounding to uint8.

        Each frame is uploaded once. `batch` pairs go to one forward as
        [batch, H, W, 3] frames. Once a full batch has run, a short tail
        is padded to `batch` pairs by repeating the last one and the
        extra outputs are dropped; a stream shorter than one batch runs
        at its own size. Raises ValueError at the call for a factor
        other than 2, 4, 8, for batch < 1, for batch > 1 on a
        row-sharded mesh (one pair a forward) and for a batch that does
        not divide over a mesh's 'data' shards."""
        if factor not in (2, 4, 8):
            raise ValueError("factor must be 2, 4 or 8")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if batch > 1 and self._n_sp > 1:
            raise ValueError("row-sharded serving takes one pair a forward: "
                             f"batch must be 1, got {batch}")
        if batch % self._n_dp:
            raise ValueError(f"batch {batch} must divide over the "
                             f"{self._n_dp} 'data' shards")
        return self._stream(frames, factor, batch)

    def _stream(self, frames, factor: int, batch: int):
        padder = None
        pend: List[torch.Tensor] = []  # padded device frames, oldest first
        full = False  # whether a full batch has run
        for frame in frames:
            x = self._upload(frame)
            if padder is None:
                padder = InputPadder(x.shape, divisor=self.pad_divisor)
            pend.append(padder.pad(x))
            if len(pend) == batch + 1:
                yield from self._batch_out(pend[:-1], pend[1:], batch,
                                           factor, padder)
                full = True
                pend = pend[-1:]
        if len(pend) >= 2:
            k = len(pend) - 1
            a, b = pend[:-1], pend[1:]
            if full:
                a += [pend[-2]] * (batch - k)
                b += [pend[-1]] * (batch - k)
            yield from self._batch_out(a, b, k, factor, padder)
        if pend:
            yield padder.unpad(pend[-1])

    def _batch_out(self, a: List[torch.Tensor], b: List[torch.Tensor],
                   k: int, factor: int, padder: InputPadder):
        """One forward of the pairs (a[i], b[i]); the frames of the first
        k pairs, pair by pair."""
        seq = self._recursive_midpoints(torch.cat(a), torch.cat(b), factor)
        for i in range(k):
            for f in seq:
                yield padder.unpad(f[i:i + 1])

    def _recursive_midpoints(self, a, b, factor: int) -> List[torch.Tensor]:
        """`a`, then the frames strictly between a and b, in order."""
        mid = self.interpolate_device(a, b)
        if factor == 2:
            return [a, mid]
        return (self._recursive_midpoints(a, mid, factor // 2)
                + self._recursive_midpoints(mid, b, factor // 2))


def load_pipeline(checkpoint_path: str, variant="base",
                  dtype: torch.dtype = torch.bfloat16,
                  **kw) -> InterpolationPipeline:
    """Pipeline from a reference .pt/.pth or a JAX-package .npz."""
    from atmvfi_tpu_torch import convert

    if checkpoint_path.endswith((".pt", ".pth")):
        sd, meta = convert.load_checkpoint(checkpoint_path)
    else:
        sd, meta = convert.load_npz(checkpoint_path)
    if meta:
        print(f"checkpoint meta: {sorted(meta)}")
    return InterpolationPipeline(sd, variant=variant, dtype=dtype, **kw)
