"""The comparison that decides `correct`.

Each sampled frame that the timed window delivered (uint8 [H, W, 3]) is
held against the reference's uint8 frame of the same pair, computed by
`reference.network.interpolate_uint8` from the same pool frames and the
same state dict, in f32 with TF32 off. Two numbers, in levels of 255:

* `frame_mean_abs`: the largest, over the sampled frames, of the mean
  |program - reference| over the frame;
* `tile_mean_abs`: the largest, over the sampled frames and their
  128 x 128 tiles (the last row and column of tiles cut by the frame's
  edge), of the mean |program - reference| over a tile: a fault that
  alters part of a frame shows here where the frame's mean dilutes it.

The cell's workload file gives each number's limit; a run is correct
when every number is at or below its limit and no call failed.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from portbench.reference import network as R

TILE = 128
NUMBERS = ("frame_mean_abs", "tile_mean_abs")


def numbers(pairs: Iterable[Tuple[np.ndarray, np.ndarray]]) -> Dict[str, float]:
    """The two numbers over (program frame, reference frame) pairs."""
    frame = tile = 0.0
    for got, ref in pairs:
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16)).astype(
            np.float64).mean(-1)
        frame = max(frame, float(d.mean()))
        H, W = d.shape
        th, tw = math.ceil(H / TILE), math.ceil(W / TILE)
        pad = np.full((th * TILE, tw * TILE), np.nan)
        pad[:H, :W] = d
        tiles = np.nanmean(pad.reshape(th, TILE, tw, TILE), axis=(1, 3))
        tile = max(tile, float(tiles.max()))
    return {"frame_mean_abs": frame, "tile_mean_abs": tile}


def reference_frames(state_dict, sizes: R.Sizes, pool: np.ndarray,
                     pairs: Iterable[int], divisor: int, device,
                     prec: R.Precision = R.Precision()) -> Dict[int, np.ndarray]:
    """The reference's uint8 middle frame of each pool pair (q, q + 1),
    wrapping at the pool's end; f32 with TF32 off unless `prec` says
    otherwise. One pair at a time, under no_grad."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {k: v.to(device) for k, v in state_dict.items()}
    P = pool.shape[0]
    out = {}
    with torch.no_grad():
        for q in pairs:
            f0 = torch.from_numpy(pool[q % P]).to(device)
            f1 = torch.from_numpy(pool[(q + 1) % P]).to(device)
            out[q] = R.interpolate_uint8(w, sizes, f0, f1, divisor,
                                         prec).cpu().numpy()
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in limits and nums[k] <= limits[k] for k in nums)
