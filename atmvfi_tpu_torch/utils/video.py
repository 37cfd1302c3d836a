"""Y4M (YUV4MPEG2) video reading and writing in numpy, for the CLI's
`--video` mode.

The port's own copy of `atmvfi_tpu/utils/video.py` (`rgb_to_ycbcr`,
`ycbcr_to_rgb`, `Y4MReader`, `Y4MWriter`, and the Xiph staging
`extract_y4m_frames`, `prepare_xiph`, which write PNG with the port's
own writer): uncompressed YUV4MPEG2 is
the one container that needs no codec. Colorspaces: C444 (full chroma)
and the C420 family (C420, C420jpeg, C420mpeg2, C420paldv; chroma
siting is ignored: 2x2 box down, nearest up). Colour conversion is
BT.601 limited range, as ffmpeg does for such clips by default.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

# BT.601 limited-range RGB(0..1) -> YCbCr(0..255) matrix + offsets
_FWD = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    np.float32,
)
_OFF = np.array([16.0, 128.0, 128.0], np.float32)
_INV = np.linalg.inv(_FWD).astype(np.float32)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> float32 YCbCr [H, W, 3] (BT.601 limited)."""
    x = rgb.astype(np.float32) / 255.0
    return x @ _FWD.T + _OFF


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """float32 YCbCr [H, W, 3] -> uint8 RGB [H, W, 3]."""
    x = (ycc.astype(np.float32) - _OFF) @ _INV.T
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def _parse_ratio(tok: str, default=(30, 1)) -> Tuple[int, int]:
    try:
        n, d = tok.split(":")
        return int(n), max(int(d), 1)
    except ValueError:
        return default


class Y4MReader:
    """Iterates RGB uint8 frames from a .y4m file."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        header = self._f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            self._f.close()
            raise ValueError(f"not a YUV4MPEG2 stream: {path}")
        self.width = self.height = 0
        self.fps = (30, 1)
        self.colorspace = "C420"
        self.interlacing = "Ip"
        for tok in header.split()[1:]:
            if tok.startswith("W"):
                self.width = int(tok[1:])
            elif tok.startswith("H"):
                self.height = int(tok[1:])
            elif tok.startswith("F"):
                self.fps = _parse_ratio(tok[1:])
            elif tok.startswith("C"):
                self.colorspace = tok
            elif tok.startswith("I"):
                self.interlacing = tok
        if not self.width or not self.height:
            self._f.close()
            raise ValueError(f"y4m header missing W/H: {header}")
        if self.colorspace.startswith("C444"):
            self._chroma = (1, 1)
        elif self.colorspace.startswith("C420"):
            self._chroma = (2, 2)
        else:
            self._f.close()
            raise ValueError(f"unsupported y4m colorspace {self.colorspace}")

    @property
    def fps_float(self) -> float:
        return self.fps[0] / self.fps[1]

    def _read_plane(self, h: int, w: int) -> Optional[np.ndarray]:
        data = self._f.read(h * w)
        if len(data) < h * w:
            return None
        return np.frombuffer(data, np.uint8).reshape(h, w)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        line = self._f.readline()
        if not line:
            self._f.close()
            raise StopIteration
        if not line.startswith(b"FRAME"):
            self._f.close()
            raise ValueError(f"bad y4m frame marker: {line[:20]!r}")
        H, W = self.height, self.width
        sy, sx = self._chroma
        y = self._read_plane(H, W)
        cb = self._read_plane(H // sy, W // sx)
        cr = self._read_plane(H // sy, W // sx)
        if y is None or cb is None or cr is None:
            self._f.close()
            raise StopIteration
        if (sy, sx) != (1, 1):  # nearest chroma upsample
            cb = np.repeat(np.repeat(cb, sy, 0), sx, 1)[:H, :W]
            cr = np.repeat(np.repeat(cr, sy, 0), sx, 1)[:H, :W]
        ycc = np.stack([y, cb, cr], axis=-1).astype(np.float32)
        return ycbcr_to_rgb(ycc)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4MWriter:
    """Writes RGB uint8 frames to a .y4m file."""

    def __init__(self, path: str, width: int, height: int,
                 fps: Tuple[int, int] = (30, 1), colorspace: str = "C444"):
        if colorspace.startswith("C444"):
            self._chroma = (1, 1)
        elif colorspace.startswith("C420"):
            self._chroma = (2, 2)
            if height % 2 or width % 2:
                raise ValueError("C420 needs even dimensions")
        else:
            raise ValueError(f"unsupported y4m colorspace {colorspace}")
        self._f = open(path, "wb")
        self.width, self.height = width, height
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} F{fps[0]}:{fps[1]} "
            f"Ip A1:1 {colorspace}\n".encode("ascii")
        )

    def write(self, rgb: np.ndarray) -> None:
        if rgb.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"frame {rgb.shape[:2]} != header "
                f"{(self.height, self.width)}"
            )
        ycc = rgb_to_ycbcr(rgb)
        ycc8 = np.clip(np.round(ycc), 0, 255).astype(np.uint8)
        y, cb, cr = ycc8[..., 0], ycc8[..., 1], ycc8[..., 2]
        sy, sx = self._chroma
        if (sy, sx) != (1, 1):  # 2x2 box chroma downsample (on float)
            def down(p):
                H, W = p.shape
                q = p.reshape(H // sy, sy, W // sx, sx).mean(axis=(1, 3))
                return np.clip(np.round(q), 0, 255).astype(np.uint8)

            cb = down(ycc[..., 1])
            cr = down(ycc[..., 2])
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(y).tobytes())
        self._f.write(np.ascontiguousarray(cb).tobytes())
        self._f.write(np.ascontiguousarray(cr).tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def extract_y4m_frames(y4m_path: str, out_dir: str,
                       max_frames: int = 100) -> int:
    """Dump the first `max_frames` frames as 001.png, 002.png, ... as the
    Xiph harness's ffmpeg extraction does (`-vframes 100 %03d.png`,
    1-indexed). Returns the number written."""
    from atmvfi_tpu_torch.utils.images import write_image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with Y4MReader(y4m_path) as reader:
        for i, frame in enumerate(reader, start=1):
            if i > max_frames:
                break
            write_image(os.path.join(out_dir, f"{i:03d}.png"), frame)
            n += 1
    return n


def prepare_xiph(y4m_dir: str, out_root: str, clips: Iterable[str],
                 max_frames: int = 100) -> dict:
    """Stage `out_root/<clip>/NNN.png` from `<y4m_dir>/<clip>.y4m` files
    (the offline half of the reference's Xiph setup: the Netflix clips
    themselves are downloaded elsewhere). Returns {clip: frames}."""
    counts = {}
    for clip in clips:
        src = os.path.join(y4m_dir, f"{clip}.y4m")
        if not os.path.exists(src):
            continue
        counts[clip] = extract_y4m_frames(
            src, os.path.join(out_root, clip), max_frames)
    return counts
