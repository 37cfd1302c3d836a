"""Kernel K3-K5 and K12 wrappers: 3x3 conv + bias (+ PReLU)
(`csrc/conv3x3_wgmma.cu`, `csrc/conv3x3.cu`, `csrc/conv_pair.cu`).

* `conv3x3` (K3) replaces `atmvfi_tpu/ops/conv_pallas.py::conv3x3_hcw_op`:
  stride 1, 'same' zero padding. A bf16 map of at least 32 channels
  whose pixel stride is a multiple of 8 and whose pointer is 16-byte
  aligned (every such site of the main path) runs the wgmma + TMA
  kernel (`csrc/conv3x3_wgmma.cu`); f32 (the parity mode) and narrower
  maps (the encoder's 24 channels, where the kernel's 64-channel rows
  would be mostly zero fill) run the mma.sync implicit GEMM
  (`csrc/igemm.cuh`). `conv3x3.wgmma_launches` counts the former.
* `conv3x3_s2` (K4) replaces `conv3x3s2_hcw_op`: stride 2, pad 1, out
  ceil(H/2) x ceil(W/2), routed as K3 onto the same two kernels (the
  wgmma kernel takes the stride as a template parameter);
  `conv3x3_s2.wgmma_launches` counts its wgmma launches.
* `conv3x3_multi` (K5) replaces `conv3x3_hcw_planes_op` and
  `conv3x3_planes_only_op`: the conv over the channel concat of up to
  six sources, which is never built. In bf16, where every source can
  take a TMA tensor map (bf16 maps as K3's wgmma route takes them; f32
  3-channel images at pixel stride 3 whose rows of 3 W floats are
  16-byte multiples; at most five images), it runs K3's wgmma kernel
  with one map per source (`csrc/conv3x3_wgmma.cu`, MULTI), or its
  folded body for one image alone (the encoder's first conv);
  `conv3x3_multi.wgmma_launches` counts those. Otherwise it runs the
  implicit GEMM.
* `conv3x3_pair` (K12) replaces `conv3x3_pair_hcw_op`: two stride-1
  convs, conv_b(round(PReLU_a(conv_a(x) + bias_a))) + bias_b
  (+ PReLU_b), the intermediate kept on chip.

For CPU tensors each runs its plain version (`ops.conv`), its output
in the layout the kernel gives on the card (`card_layout`); for CUDA
tensors it launches the kernel or raises, differentiably through the
plain version's VJP when grad is on (`ops._autograd`). `<fn>.calls`
counts the calls on any device, `<fn>.launches` the kernel launches
(one per call on the card).

Activations are NHWC with contiguous channels; the pixel stride may be
larger than C, so a channel slice (`feat[..., :-5]`) is read in place.
Sources may be f32 or bf16: an f32 source in a bf16 conv is rounded as
it is loaded. An output whose channel count is not a multiple of 8
(389, 197, 101, 3) is a channel view of a map whose pixel stride is
rounded up to 8 (on the CPU too), so the next kernel reads it with
16-byte vectors (`vec_readable`) or through a TMA tensor map.

`weight` is the f32 OIHW parameter; the wrapper packs it into the
working type as [9, Cout, Kp] (Kp = channels rounded up to 8, zeros
beyond) and keeps the pack (and K3's weight tensor map) per weight
(`cached_pack`: keyed on the weight's identity, data_ptr, _version,
dtype and shape, so an in-place update repacks; a weight that requires
grad is packed anew at every call outside inference mode). Bias and
slope are read as f32.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Sequence

import torch

from atmvfi_tpu_torch.ops import _autograd, _build
from atmvfi_tpu_torch.ops.conv import conv3x3 as conv3x3_plain
from atmvfi_tpu_torch.ops.conv import conv3x3_pair as conv3x3_pair_plain

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_SOURCES = 6


def pixel_stride(t: torch.Tensor) -> int:
    """Pixel stride of an NHWC tensor whose pixels lie at one stride with
    contiguous channels (a channel slice of a dense map qualifies)."""
    if t.dim() != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(t.shape)}")
    B, H, W, C = t.shape
    # the stride of the innermost spatial dim that is larger than 1
    ps = next((t.stride(d) // n for d, n in ((2, 1), (1, W), (0, H * W))
               if t.shape[d] > 1), C)
    want = (H * W * ps, W * ps, ps, 1)
    for size, got, exp in zip(t.shape, t.stride(), want):
        if size > 1 and got != exp:
            raise ValueError("kernel needs NHWC pixels at one stride with "
                             f"contiguous channels, got {t.stride()} for "
                             f"{tuple(t.shape)}")
    if ps < C:
        raise ValueError(f"pixel stride {ps} < channels {C}")
    return ps


def vec_readable(t: torch.Tensor, ps: int) -> bool:
    """Whether the kernels may read a bf16 source as 16-byte vectors:
    pixel stride a multiple of 8, a 16-byte aligned pointer, and the
    storage holding channels up to C rounded up to 8 in every pixel (the
    lanes at or past C are zeroed in registers)."""
    if t.dtype != torch.bfloat16 or ps % 8 or t.data_ptr() % 16:
        return False
    last = t.storage_offset() + (t.numel() // t.shape[3] - 1) * ps
    return last + -(-t.shape[3] // 8) * 8 <= t.untyped_storage().nbytes() // 2


def empty_nhwc(B: int, H: int, W: int, C: int, dtype, device):
    """[B, H, W, C] output whose pixel stride is C rounded up to 8."""
    cp = -(-C // 8) * 8
    return torch.empty((B, H, W, cp), dtype=dtype, device=device)[..., :C]


def card_layout(y: torch.Tensor) -> torch.Tensor:
    """y in the layout a kernel writes it on the card: a channel view of
    `empty_nhwc` when C % 8 != 0 (one copy; y itself otherwise)."""
    B, H, W, C = y.shape
    if C % 8 == 0:
        return y
    return empty_nhwc(B, H, W, C, y.dtype, y.device).copy_(y)


def cat_nhwc(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """torch.cat(parts, -1) written into an `empty_nhwc` map (pixel
    stride a multiple of 8, so the next kernel can take it by TMA): the
    same bytes as the cat, one copy into each part's channel slice."""
    B, H, W, _ = parts[0].shape
    C = sum(p.shape[3] for p in parts)
    dtype = functools.reduce(torch.promote_types, (p.dtype for p in parts))
    out = empty_nhwc(B, H, W, C, dtype, parts[0].device)
    c = 0
    for p in parts:
        out[..., c:c + p.shape[3]].copy_(p)
        c += p.shape[3]
    return out


def padded_map(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The whole [B, H, W, ps] map whose first C channels x is, when x
    has a pixel stride ps > C that is a multiple of 8 (an `empty_nhwc`
    output or a row slice of one); None otherwise."""
    if x.dim() != 4:
        return None
    try:
        ps = pixel_stride(x)
    except ValueError:
        return None
    B, H, W, C = x.shape
    if ps == C or ps % 8 or x.storage_offset() % ps:
        return None
    if x.storage_offset() + B * H * W * ps > x.untyped_storage().nbytes() \
            // x.element_size():
        return None
    return x.as_strided((B, H, W, ps), (H * W * ps, W * ps, ps, 1))


def pack_weight(view_shape, src: torch.Tensor, kin: int, dtype):
    """[*view_shape[:-1], Kp] zero-padded pack of `src` (last dim kin,
    Kp = kin rounded up to 8), cast to `dtype` in one copy."""
    kp = (kin + 7) // 8 * 8
    shape = (*view_shape, kp)
    alloc = torch.zeros if kp != kin else torch.empty
    w = alloc(shape, dtype=dtype, device=src.device)
    w[..., :kin].copy_(src)
    return w, kp


def _vec(v: Optional[torch.Tensor], cout: int, what: str, device):
    """A per-channel vector (bias, slope) as contiguous f32 on `device`."""
    if v is None:
        return None
    if tuple(v.shape) != (cout,):
        raise ValueError(f"{what} must be [{cout}], got {tuple(v.shape)}")
    if v.device != device:
        raise ValueError(f"{what} on {v.device}, input on {device}")
    return v.float().contiguous()


def _describe(sources, dtype):
    """(source descriptors as ctypes int64 x 5 each, total channels)."""
    if dtype not in _DTYPES:
        raise TypeError(f"conv kernel works in f32/bf16, got {dtype}")
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f"1 to {MAX_SOURCES} sources, got {len(sources)}")
    dev = sources[0].device
    B, H, W, _ = sources[0].shape
    desc = (ctypes.c_int64 * (5 * len(sources)))()
    ctot = 0
    for i, s in enumerate(sources):
        if s.dtype not in _DTYPES:
            raise TypeError(f"conv source {i}: f32/bf16, got {s.dtype}")
        if s.device != dev or tuple(s.shape[:3]) != (B, H, W):
            raise ValueError(f"conv source {i} {tuple(s.shape)} on {s.device} "
                             f"does not match {(B, H, W)} on {dev}")
        ps = pixel_stride(s)
        desc[5 * i:5 * i + 5] = [s.data_ptr(), ps, s.shape[3],
                                 int(s.dtype == torch.float32),
                                 int(vec_readable(s, ps))]
        ctot += s.shape[3]
    return desc, ctot


_packs = {}  # (id(weight), kind, dtype) -> (weakref, fingerprint, value)


def cached_pack(weight: torch.Tensor, kind: str, dtype, make, deps=()):
    """make() once per (weight, kind, dtype); made anew when the weight
    changes (another data_ptr, an in-place update bumping `_version`,
    another shape or dtype) or one of the tensors `deps` the pack is
    also made from does (data_ptr, `_version`). An entry dies with its
    weight.

    A weight that requires grad may be written by an optimizer that
    bumps no version (torch's fused AdamW), so outside inference mode
    its pack is made anew at every call: a training forward (or an
    evaluation under no_grad between updates) never reads a stale pack.
    Frozen weights, and every weight under inference mode (serving),
    keep theirs."""
    if (not torch.is_inference_mode_enabled()
            and any(t.requires_grad for t in (weight, *deps))):
        return make()
    try:
        fp = tuple((t.data_ptr(), t._version, tuple(t.shape), t.dtype)
                   for t in (weight, *deps))
    except RuntimeError:  # an inference tensor keeps no version: no cache
        return make()
    key = (id(weight), kind, dtype)
    hit = _packs.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == fp:
        return hit[2]
    value = make()
    _packs[key] = (weakref.ref(weight, lambda _, k=key: _packs.pop(k, None)),
                   fp, value)
    return value


def _pack3x3(weight: torch.Tensor, cin: int, dtype, dev):
    """OIHW [Cout, cin, 3, 3] -> packed [9, Cout, Kp] in `dtype`, Kp."""
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight must be [Cout, {cin}, 3, 3], got "
                         f"{tuple(weight.shape)}")
    if weight.device != dev:
        raise ValueError("weight and input on different devices")
    return cached_pack(weight, "3x3", dtype, lambda: pack_weight(
        (3, 3, cout), weight.detach().permute(2, 3, 0, 1), cin, dtype))


def _wgmma_weight(weight: torch.Tensor, cin: int, dev, stride: int):
    """(packed bf16 weight, its 128-byte tensor map, column tile BN) for
    the wgmma kernel at `stride`, cached with the pack."""
    w, kp = _pack3x3(weight, cin, torch.bfloat16, dev)

    def make():
        tmap = ctypes.create_string_buffer(128)
        bn = ctypes.c_int(0)
        lib = _build.load_library()
        with torch.cuda.device(dev):
            rc = lib.conv3x3_wgmma_weight_map(w.data_ptr(), kp,
                                              weight.shape[0], stride, 9,
                                              tmap, ctypes.byref(bn))
        _build.check(rc, "conv3x3 wgmma weight map")
        return w, tmap, bn.value

    return cached_pack(weight, f"3x3 wgmma map s{stride}", torch.bfloat16,
                       make)


# Fewest input channels the wgmma kernel takes at either stride: below
# them its 64-channel halo rows are mostly zero fill, and the encoder's
# 24-channel convs ran faster on the implicit GEMM (PERF.md).
WGMMA_MIN_CHANNELS = 32


def _wgmma_eligible(x: torch.Tensor) -> bool:
    """Whether K3 or K4 takes x on the wgmma + TMA kernel: bf16, at least
    WGMMA_MIN_CHANNELS channels, pixel stride a multiple of 8, pointer
    16-byte aligned (a TMA tensor map needs 16-byte strides and base)."""
    return (x.dtype == torch.bfloat16 and x.shape[3] >= WGMMA_MIN_CHANNELS
            and pixel_stride(x) % 8 == 0 and x.data_ptr() % 16 == 0)


def _launch_wgmma(x, weight, bias, slope, stride: int = 1):
    dev = x.device
    B, H, W, cin = x.shape
    cout = weight.shape[0]
    w, tmap, bn = _wgmma_weight(weight, cin, dev, stride)
    b = _vec(bias, cout, "bias", dev)
    a = _vec(slope, cout, "slope", dev)
    out = empty_nhwc(B, (H - 1) // stride + 1, (W - 1) // stride + 1, cout,
                     torch.bfloat16, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3x3_wgmma_bf16(
            x.data_ptr(), pixel_stride(x), B, H, W, cin, stride, tmap, bn,
            b.data_ptr(), 0 if a is None else a.data_ptr(), out.data_ptr(),
            cout, out.stride(2), stream)
    _build.check(rc, "conv3x3 wgmma kernel launch")
    return out


def _launch(entry: str, sources, weight, bias, slope, stride: int, dtype):
    desc, ctot = _describe(sources, dtype)
    dev = sources[0].device
    B, H, W, _ = sources[0].shape
    cout = weight.shape[0]
    w, kp = _pack3x3(weight, ctot, dtype, dev)
    b = _vec(bias, cout, "bias", dev)
    a = _vec(slope, cout, "slope", dev)
    out = empty_nhwc(B, (H - 1) // stride + 1, (W - 1) // stride + 1, cout,
                     dtype, dev)
    fn = getattr(_build.load_library(), f"{entry}_{_DTYPES[dtype]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(desc, len(sources), B, H, W, stride, w.data_ptr(), kp,
                b.data_ptr(), 0 if a is None else a.data_ptr(),
                out.data_ptr(), cout, out.stride(2), stream)
    _build.check(rc, f"{entry} kernel launch")
    return out


def _run(fn, entry: str, sources, weight, bias, slope, stride, dtype):
    fn.calls += 1
    dev = sources[0].device
    if dev.type == "cpu":
        return card_layout(conv3x3_plain(sources, weight, bias, slope,
                                         stride, dtype))
    if dev.type != "cuda":
        raise ValueError(f"no conv kernel for device {dev}")
    out = _autograd.launch(
        lambda s, w, b, a, st, dt: _launch(entry, s, w, b, a, st, dt),
        conv3x3_plain, sources, weight, bias, slope, stride, dtype)
    fn.launches += 1
    return out


def _conv3x3_plain1(x, weight, bias, slope=None, stride=1):
    return conv3x3_plain([x], weight, bias, slope, stride, x.dtype)


def _run_single(fn, entry: str, x, weight, bias, slope, stride: int):
    """K3 / K4: the wgmma kernel where it takes x on the card, else the
    implicit GEMM (or the plain version on the CPU)."""
    if x.device.type != "cuda" or not _wgmma_eligible(x):
        return _run(fn, entry, [x], weight, bias, slope, stride, x.dtype)
    fn.calls += 1
    out = _autograd.launch(_launch_wgmma, _conv3x3_plain1, x, weight, bias,
                           slope, stride)
    fn.launches += 1
    fn.wgmma_launches += 1
    return out


@_autograd.kernel_wrapper(_conv3x3_plain1)
def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: stride-1 3x3 conv + bias (+ PReLU) in x's type."""
    return _run_single(conv3x3, "conv3x3", x, weight, bias, slope, 1)


@_autograd.kernel_wrapper(
    lambda x, w, b, s=None: _conv3x3_plain1(x, w, b, s, 2))
def conv3x3_s2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: stride-2 3x3 conv + bias (+ PReLU) in x's type."""
    return _run_single(conv3x3_s2, "conv3x3s2", x, weight, bias, slope, 2)


# K5 on the wgmma kernel (csrc/conv3x3_wgmma.cu): at most MULTI_MAX_IMAGES
# f32 images (15 channels and a zero fill one k16 slice) and
# MULTI_MAX_CHUNKS (source, 64-channel) chunks in all; the folded body
# takes one image alone up to FOLD_MAX_COUT output channels (one column
# tile).
MULTI_MAX_IMAGES, MULTI_MAX_CHUNKS, FOLD_MAX_COUT = 5, 32, 64


def _image_eligible(s: torch.Tensor) -> bool:
    """An f32 3-channel image K5's wgmma kernel reads by TMA: pixel
    stride 3, 16-byte aligned, rows of 3 W floats 16-byte multiples."""
    return (s.dtype == torch.float32 and s.shape[3] == 3
            and pixel_stride(s) == 3 and s.data_ptr() % 16 == 0
            and (12 * s.shape[2]) % 16 == 0)


def _multi_wgmma_eligible(sources: Sequence[torch.Tensor], dtype) -> bool:
    """Whether K5 takes `sources` on the wgmma kernel: a bf16 conv whose
    bf16 sources K3's wgmma route takes (`_wgmma_eligible`) and whose f32
    sources are TMA-legal images (`_image_eligible`)."""
    if dtype != torch.bfloat16 or len(sources) > MAX_SOURCES:
        return False
    images = chunks = 0
    for s in sources:
        if s.dtype == torch.bfloat16 and _wgmma_eligible(s):
            chunks += -(-s.shape[3] // 64)
        elif _image_eligible(s):
            images += 1
        else:
            return False
    return (images <= MULTI_MAX_IMAGES
            and chunks + (images > 0) <= MULTI_MAX_CHUNKS)


def _folds(sources, cout: int) -> bool:
    """K5 runs the folded body: one f32 image alone, one column tile."""
    return (len(sources) == 1 and sources[0].dtype == torch.float32
            and cout <= FOLD_MAX_COUT)


def multi_pack(weight: torch.Tensor, layout, fold: bool = False,
               dtype=torch.bfloat16):
    """(K5's wgmma weight, Kp) for sources of `layout` [(channels,
    is_f32)]: [9, Cout, Kp], input channels in the kernel's order (the
    bf16 sources in turn, each from a multiple of 8, then the f32 images'
    channels together), zeros between; with `fold` (one 3-channel image
    alone) [1, Cout, 64], column 3 (3 dy + dx) + c for tap (dy, dx) and
    channel c (27 columns, zeros after). weight: OIHW [Cout, sum C, 3,
    3]."""
    cout, cin = weight.shape[:2]
    if cin != sum(c for c, _ in layout):
        raise ValueError(f"weight has {cin} input channels, the sources "
                         f"{sum(c for c, _ in layout)}")
    w = weight.detach()
    if fold:
        if tuple(layout) != ((3, True),):
            raise ValueError(f"the fold takes one 3-channel image, got "
                             f"{layout}")
        pack = torch.zeros(1, cout, 64, dtype=dtype, device=w.device)
        pack[0, :, :27] = w.permute(0, 2, 3, 1).reshape(cout, 27)
        return pack, 64
    offs = [sum(c for c, _ in layout[:i]) for i in range(len(layout))]
    k, at = 0, {}
    for i, (c, f32) in enumerate(layout):  # bf16 sources
        if not f32:
            at[i], k = k, k + -(-c // 8) * 8
    for i, (c, f32) in enumerate(layout):  # then the images
        if f32:
            at[i], k = k, k + c
    kp = -(-k // 8) * 8
    pack = torch.zeros(9, cout, kp, dtype=dtype, device=w.device)
    taps = w.permute(2, 3, 0, 1).reshape(9, cout, cin)
    for i, (c, _) in enumerate(layout):
        pack[:, :, at[i]:at[i] + c] = taps[:, :, offs[i]:offs[i] + c]
    return pack, kp


def _launch_multi_wgmma(sources, weight, bias, slope, fold=None):
    """The wgmma kernel; `fold` True / False asks for the folded body or
    the halo kernel's image chunk in place of `_folds` (to time both)."""
    dev = sources[0].device
    B, H, W, _ = sources[0].shape
    cout = weight.shape[0]
    layout = tuple((s.shape[3], s.dtype == torch.float32) for s in sources)
    fold = _folds(sources, cout) if fold is None else fold
    desc, ctot = _describe(sources, torch.bfloat16)
    if tuple(weight.shape) != (cout, ctot, 3, 3) or weight.device != dev:
        raise ValueError(f"weight must be [Cout, {ctot}, 3, 3] on {dev}, got "
                         f"{tuple(weight.shape)} on {weight.device}")

    def make():
        w, kp = multi_pack(weight, layout, fold)
        tmap = ctypes.create_string_buffer(128)
        bn = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _build.load_library().conv3x3_wgmma_weight_map(
                w.data_ptr(), kp, cout, 1, 1 if fold else 9, tmap,
                ctypes.byref(bn))
        _build.check(rc, "conv3x3_multi wgmma weight map")
        return w, tmap, bn.value

    # the pack stays referenced until the launch: a weight that requires
    # grad gets a pack of its own per call, which no cache entry holds
    pack, tmap, bn = cached_pack(weight, f"3x3 multi wgmma {layout} {fold}",
                                 torch.bfloat16, make)
    b = _vec(bias, cout, "bias", dev)
    a = _vec(slope, cout, "slope", dev)
    out = empty_nhwc(B, H, W, cout, torch.bfloat16, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3x3_multi_wgmma_bf16(
            desc, len(sources), B, H, W, tmap, bn, int(fold), b.data_ptr(),
            0 if a is None else a.data_ptr(), out.data_ptr(), cout,
            out.stride(2), stream)
    _build.check(rc, "conv3x3_multi wgmma kernel launch")
    return out


def _multi_plain(sources, weight, bias, slope):
    return conv3x3_plain(sources, weight, bias, slope, 1, torch.bfloat16)


@_autograd.kernel_wrapper(
    lambda sources, w, b, s=None, dtype=None: conv3x3_plain(
        list(sources), w, b, s, 1, dtype))
def conv3x3_multi(sources: Sequence[torch.Tensor], weight: torch.Tensor,
                  bias: torch.Tensor, slope: Optional[torch.Tensor] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K5: stride-1 3x3 conv + bias (+ PReLU) over the channel concat of
    `sources`, in `dtype` (the first source's type when None): the wgmma
    kernel where it takes every source on the card, else the implicit
    GEMM (or the plain version on the CPU)."""
    sources = list(sources)
    dt = sources[0].dtype if dtype is None else dtype
    if sources[0].device.type != "cuda" or not _multi_wgmma_eligible(
            sources, dt):
        return _run(conv3x3_multi, "conv3x3_multi", sources, weight, bias,
                    slope, 1, dt)
    conv3x3_multi.calls += 1
    out = _autograd.launch(_launch_multi_wgmma, _multi_plain, sources,
                           weight, bias, slope)
    conv3x3_multi.launches += 1
    conv3x3_multi.wgmma_launches += 1
    return out


def _launch_pair(x, wa, ba, sa, wb, bb, sb):
    dev = x.device
    dt = x.dtype
    desc, cin = _describe([x], dt)
    B, H, W, _ = x.shape
    cmid, cout = wa.shape[0], wb.shape[0]
    pa, kpa = _pack3x3(wa, cin, dt, dev)
    pb, kpb = _pack3x3(wb, cmid, dt, dev)
    vecs = [_vec(v, n, what, dev) for v, n, what in
            ((ba, cmid, "bias a"), (sa, cmid, "slope a"),
             (bb, cout, "bias b"), (sb, cout, "slope b"))]
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    out = empty_nhwc(B, H, W, cout, dt, dev)
    fn = getattr(_build.load_library(), f"conv3x3_pair_{_DTYPES[dt]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(desc, B, H, W, pa.data_ptr(), kpa, ptr(vecs[0]),
                ptr(vecs[1]), cmid, pb.data_ptr(), kpb, ptr(vecs[2]),
                ptr(vecs[3]), out.data_ptr(), cout, out.stride(2), stream)
    _build.check(rc, "conv3x3_pair kernel launch")
    return out


@_autograd.kernel_wrapper(conv3x3_pair_plain)
def conv3x3_pair(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor,
                 sa: Optional[torch.Tensor], wb: torch.Tensor,
                 bb: torch.Tensor,
                 sb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12: conv_b(round(PReLU_a(conv_a(x) + ba))) + bb (+ PReLU_b), two
    stride-1 3x3 convs in x's type; `sa` None runs conv_a without PReLU."""
    conv3x3_pair.calls += 1
    dev = x.device
    if dev.type == "cpu":
        return card_layout(conv3x3_pair_plain(x, wa, ba, sa, wb, bb, sb))
    if dev.type != "cuda":
        raise ValueError(f"no conv kernel for device {dev}")
    out = _autograd.launch(_launch_pair, conv3x3_pair_plain, x, wa, ba, sa,
                           wb, bb, sb)
    conv3x3_pair.launches += 1
    return out


for _fn in (conv3x3, conv3x3_s2, conv3x3_multi, conv3x3_pair):
    _fn.calls = 0
    _fn.launches = 0
for _fn in (conv3x3, conv3x3_s2, conv3x3_multi):
    _fn.wgmma_launches = 0  # K3 / K4 / K5 launches on the wgmma kernel
