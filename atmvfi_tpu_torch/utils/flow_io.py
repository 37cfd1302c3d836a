"""Optical-flow / depth file IO: Middlebury .flo, PFM, .float3.

The port's own copy of `atmvfi_tpu/utils/flow_io.py` (numpy only): the
same magic numbers, header layouts and byte orders, so a file written
by either package is byte-equal and reads back in both.
"""
from __future__ import annotations

import os
import re

import numpy as np

FLO_MAGIC = 202021.25  # Middlebury sanity-check magic


def read_flow(path: str) -> np.ndarray:
    """Read a Middlebury .flo file -> float32 [H, W, 2]."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != FLO_MAGIC:
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(path: str, flow: np.ndarray) -> None:
    """Write float32 [H, W, 2] as Middlebury .flo."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path: str):
    """Read a PFM file -> (float32 array, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image)
    if image.dtype.name != "float32":
        raise ValueError("PFM requires float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("PFM expects HxWx3 or HxW")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def read_float3(path: str) -> np.ndarray:
    """Read a .float3 blob (dim-count header, int dims, f32 payload)."""
    with open(path, "rb") as f:
        if f.readline().decode("utf-8", "ignore").rstrip() != "float":
            raise ValueError(f"{path}: not a float3 file")
        dim = int(f.readline())
        dims = [int(f.readline()) for _ in range(dim)]
        count = int(np.prod(dims))
        data = np.fromfile(f, np.float32, count)
    dims = list(reversed(dims))
    data = data.reshape(dims)
    if dim > 2:
        data = np.transpose(data, (2, 1, 0))
        data = np.transpose(data, (1, 0, 2))
    return data


def write_float3(path: str, data: np.ndarray) -> None:
    data = np.asarray(data, np.float32)
    with open(path, "wb") as f:
        f.write(b"float\n")
        f.write(f"{data.ndim}\n".encode())
        if data.ndim == 1:
            f.write(f"{data.shape[0]}\n".encode())
        else:
            f.write(f"{data.shape[1]}\n".encode())
            f.write(f"{data.shape[0]}\n".encode())
            for d in range(2, data.ndim):
                f.write(f"{data.shape[d]}\n".encode())
            data = np.transpose(data, (2, 0, 1)) if data.ndim > 2 else data
        data.tofile(f)


def read(path: str):
    """Read a flow, PFM, .float3 or image file by its extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flow(path)
    if ext == ".pfm":
        return read_pfm(path)[0]
    if ext == ".float3":
        return read_float3(path)
    if ext in (".png", ".jpg", ".jpeg", ".ppm", ".pgm"):
        from atmvfi_tpu_torch.utils.images import read_image

        return read_image(path)
    raise ValueError(f"don't know how to read {path}")
