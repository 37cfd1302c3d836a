"""Image IO and tensor conversion without Pillow.

The port's copy of `atmvfi_tpu/utils/images.py` (`read_image`,
`write_image`, `img2tensor`, `tensor2img`, `round_to_uint8`,
`check_dim_and_resize`). The evaluation path reads and writes PNG with
its own codec on `zlib` and numpy, so it runs where Pillow is not
installed:

* reading: 8-bit greyscale, grey + alpha, RGB, RGBA and palette,
  non-interlaced, every row filter (None, Sub, Up, Average, Paeth).
  Images come back as RGB, as Pillow's `convert("RGB")` gives them: grey
  repeated over the three channels, palette indices looked up in PLTE,
  alpha dropped. Any other PNG (16-bit, 1/2/4-bit, interlaced) raises
  `UnsupportedPNG` in the codec; `read_image` then reads it with Pillow
  where Pillow is installed, and raises without it.
* writing: 8-bit RGB with filter 0 on every row.

Other formats (.jpg, ...) go through Pillow where it is installed.
NHWC layout, float32 in [0, 1].
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


class UnsupportedPNG(ValueError):
    """A well-formed PNG of a kind the codec does not decode."""


def _chunks(data: bytes, path: str):
    if data[:8] != _PNG_SIG:
        raise ValueError(f"not a PNG file: {path}")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"truncated PNG file: {path}")


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw [h, 1 + w * bpp] -> [h, w, bpp].

    Rows of None / Sub / Up are undone row by row (Sub as a running sum
    mod 256). With any Average or Paeth row, pixels are decoded along
    anti-diagonals, each of which depends only on the one before (left,
    up, up-left), every row by its own filter: h + w - 1 steps over an
    image stored skewed (S[d + 1, r + 1] is pixel (r, d - r)), so that
    the three neighbours of a diagonal are slices of the two before."""
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"bad PNG row filter {int(types.max())}")
    if not types.any():  # filter 0 on every row, as `write_png` writes
        return np.ascontiguousarray(raw[:, 1:].reshape(h, w, bpp))
    if not np.isin(types, (3, 4)).any():
        f = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.int32)
        for r in range(h):
            row = f[r]
            if types[r] == 1:
                row = np.cumsum(row, axis=0)
            elif types[r] == 2:
                row = row + prev
            prev = row & 255
            out[r] = prev
        return out
    r, i = np.arange(h)[:, None], np.arange(w)[None, :]
    f = np.zeros((h + w - 1, h + 1, bpp), np.int16)  # the filtered bytes
    f[r + i, r + 1] = raw[:, 1:].reshape(h, w, bpp)
    s = np.zeros((h + w, h + 1, bpp), np.int16)  # row 0 and column 0 zero

    def per_row(v):  # a row's value at each diagonal's row index + 1
        return np.concatenate([[0], v]).astype(np.int16)[:, None]

    paeth_only = bool((types == 4).all())
    is_paeth = per_row(types == 4).astype(bool)
    # Sub a, Up b, Average (a + b) >> 1, None 0
    ka = per_row((types == 1) | (types == 3))
    kb = per_row((types == 2) | (types == 3))
    shift = per_row(types == 3)
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1) + 1, min(h, d + 1) + 1
        a = s[d, r0:r1]  # left
        b = s[d, r0 - 1:r1 - 1]  # up
        c = s[d - 1, r0 - 1:r1 - 1]  # up-left (d = 0: s[-1], still zero)
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - c - c)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, b, c))
        if not paeth_only:
            pred = np.where(is_paeth[r0:r1], pred,
                            (ka[r0:r1] * a + kb[r0:r1] * b) >> shift[r0:r1])
        np.bitwise_and(f[d, r0:r1] + pred, 255, out=s[d + 1, r0:r1])
    return s[r + i + 1, r + 1].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG -> uint8 [H, W, samples] (1 grey, 2
    grey + alpha, 3 RGB or palette looked up, 4 RGBA)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat, plte = None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise UnsupportedPNG(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); this codec takes 8-bit "
            "non-interlaced grey, grey + alpha, RGB, RGBA and palette")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: image data of {raw.size} bytes for "
                         f"{w}x{h}x{bpp}")
    img = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        table = np.zeros((256, 3), np.uint8)  # Pillow: black past the end
        table[:len(plte)] = plte[:256]
        img = table[img[..., 0]]
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 RGB [H, W, 3] -> an 8-bit PNG, filter 0 on every row."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, -1)], axis=1)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIG)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             0)))
        fh.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))


def _is_png(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == _PNG_SIG


def read_image(path: str) -> np.ndarray:
    """Read an image file -> RGB uint8 [H, W, 3]. The PNGs the codec
    decodes need no Pillow; other PNGs and other formats need it."""
    if _is_png(path):
        try:
            img = read_png(path)
        except UnsupportedPNG as err:
            try:
                from PIL import Image
            except ImportError as no_pillow:
                raise UnsupportedPNG(f"{err}; such PNGs are read through "
                                     "Pillow, which does not import"
                                     ) from no_pillow
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"), dtype=np.uint8)
        if img.shape[2] <= 2:  # grey, grey + alpha
            return np.repeat(img[..., :1], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: only PNG is read without Pillow")
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def write_image(path: str, img: np.ndarray) -> None:
    """Write RGB uint8 [H, W, 3] (or float [0, 1], rounded); a .png path
    needs no Pillow."""
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        write_png(path, img)
        return
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: only PNG is written without Pillow")
    Image.fromarray(img).save(path)


def img2tensor(img: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, C>=3] -> float32 NHWC [1, H, W, 3] in [0, 1]."""
    if img.shape[-1] > 3:
        img = img[:, :, :3]
    return (img.astype(np.float32) / 255.0)[None]


def tensor2img(t) -> np.ndarray:
    """float NHWC [1, H, W, 3] in [0, 1] (numpy or a tensor on any
    device) -> uint8 RGB [H, W, 3], truncated as the reference does."""
    arr = _numpy(t)
    if arr.ndim == 4:
        arr = arr[0]
    return np.clip(arr * 255.0, 0, 255).astype(np.uint8)


def round_to_uint8(t) -> np.ndarray:
    """Rounding used by inference_2frame (demo_2x.py:80-81)."""
    arr = _numpy(t)
    if arr.ndim == 4:
        arr = arr[0]
    return np.round(np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def _numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):  # a torch tensor
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def check_dim_and_resize(images):
    """Resize a list of [H, W, C] images to a common size if they differ
    (reference benchmark/utils.py:284-300). Needs Pillow to resize."""
    shapes = {im.shape[:2] for im in images}
    if len(shapes) == 1:
        return list(images)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("check_dim_and_resize needs Pillow to resize "
                           f"images of sizes {sorted(shapes)}")
    h = min(s[0] for s in shapes)
    w = min(s[1] for s in shapes)
    out = []
    for im in images:
        if im.shape[:2] != (h, w):
            im = np.asarray(Image.fromarray(im).resize((w, h), Image.BILINEAR))
        out.append(im)
    return out
