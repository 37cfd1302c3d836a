"""Plain PyTorch reference of the ATM-VFI two-frame forward.

A frozen, self-contained description of the network that the benchmark
holds the program against. It imports nothing of the program: it reads
the weights from a state dict under the model's published parameter
names (`spec` lists them), and computes every layer with plain torch
ops. The kernels' functions are written here in their plain forms:
window attention as matmul + softmax, the backward warp as
`F.grid_sample` (bilinear, align_corners, zeros), resizing as
`F.interpolate` (bilinear, align_corners).

Frames are NHWC [B, H, W, 3] f32 in [0, 1], H and W multiples of 16.
`Precision` says where the towers (convs, linears, attention products)
round their operands:

* `Precision()`: f32 throughout, the oracle (run with TF32 off);
* `Precision(tower=torch.bfloat16)`: the towers compute in bf16, as the
  program serves; used on fake tensors to count the work by dtype;
* `Precision(round_fn=fp8_round)`: operands rounded to fp8 (e4m3,
  per-tensor scale) and computed in f32: the lower-precision control.

Images, flows, occlusion, warps, blends and layer-norm statistics stay
f32 in every mode.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

MASK_NEG = -100.0
LN_EPS = 1e-5
MOTION_OUT = 5  # flow0 (2) + flow1 (2) + occlusion logit (1)


@dataclass(frozen=True)
class Sizes:
    """The widths of one configuration (a config file's `model` block)."""
    hidden_dims: Tuple[int, ...]
    num_heads: int
    mlp_ratio: float
    local_window: int
    global_window: int
    enhance_window: int
    local_mlp_hidden_ratio: float
    global_mlp_hidden: int
    last_feat_extra: int
    refine_hidden: int

    @classmethod
    def from_dict(cls, d: Dict) -> "Sizes":
        kw = {f: d[f] for f in cls.__dataclass_fields__}
        kw["hidden_dims"] = tuple(kw["hidden_dims"])
        return cls(**kw)

    @property
    def fused(self) -> int:
        d = self.hidden_dims
        return d[-1] + d[-2] + 2 * d[-3]

    @property
    def last_feat(self) -> int:
        return self.hidden_dims[-1] + self.last_feat_extra

    @property
    def global_dim(self) -> int:
        d = self.hidden_dims
        return self.last_feat + d[-1] + 2 * d[-2]

    @property
    def decoder(self) -> Tuple[int, int, int]:
        fd = 2 * self.fused
        return fd // 2, fd // 4, fd // 8


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to fp8 e4m3 with one per-tensor scale (amax -> 448), back
    in t's dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    s = amax / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


@dataclass(frozen=True)
class Precision:
    tower: torch.dtype = torch.float32
    round_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.tower)
        return t if self.round_fn is None else self.round_fn(t)


# ---- the parameter list ------------------------------------------------
def spec(s: Sizes) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter, in state-dict
    order. kind: conv_prelu, conv, deconv, linear, bias, prelu, ln_w,
    ln_b."""
    out = []

    def conv_prelu(p, cin, cout):
        out.extend([(f"{p}.0.weight", (cout, cin, 3, 3), "conv_prelu",
                     9 * cin), (f"{p}.0.bias", (cout,), "bias", 0),
                    (f"{p}.1.weight", (cout,), "prelu", 0)])

    def conv(p, cin, cout, k, groups=1):
        out.extend([(f"{p}.weight", (cout, cin // groups, k, k), "conv",
                     k * k * cin // groups), (f"{p}.bias", (cout,), "bias", 0)])

    def deconv(p, cin, cout):
        out.extend([(f"{p}.0.weight", (cin, cout, 2, 2), "deconv", cin),
                    (f"{p}.0.bias", (cout,), "bias", 0),
                    (f"{p}.1.weight", (cout,), "prelu", 0)])

    def linear(p, cin, cout, bias=True):
        out.append((f"{p}.weight", (cout, cin), "linear", cin))
        if bias:
            out.append((f"{p}.bias", (cout,), "bias", 0))

    def ln(p, dim):
        out.extend([(f"{p}.weight", (dim,), "ln_w", 0),
                    (f"{p}.bias", (dim,), "ln_b", 0)])

    def fusion(p, in_dims, fused):
        k = 0
        for i in range(len(in_dims) - 1):
            for _ in range(2 ** i):
                conv(f"{p}.layers.{k}", in_dims[-2 - i], in_dims[-2 - i], 3)
                k += 1
        cat = in_dims[-1] + sum(in_dims[-2 - i] * 2 ** i
                                for i in range(len(in_dims) - 1))
        conv(f"{p}.proj", cat, fused, 1)
        ln(f"{p}.norm", fused)

    def block(p, dim, motion):
        ln(f"{p}.norm1", dim)
        ln(f"{p}.norm2", dim)
        hid = int(dim * s.mlp_ratio)
        linear(f"{p}.mlp.fc1", dim, hid)
        conv(f"{p}.mlp.dwconv.dwconv", hid, hid, 3, groups=hid)
        linear(f"{p}.mlp.fc2", hid, dim)
        if motion:
            linear(f"{p}.attn.q", dim, dim, bias=False)
            linear(f"{p}.attn.kv", dim, 2 * dim, bias=False)
            linear(f"{p}.attn.proj", dim, dim)
            h = s.num_heads
            linear(f"{p}.attn.mlp.0", h, h // 2)
            linear(f"{p}.attn.mlp.2", h // 2, 1)
        else:
            linear(f"{p}.attn.qkv", dim, 3 * dim, bias=False)
            linear(f"{p}.attn.proj", dim, dim)

    d = s.hidden_dims
    cins = (3,) + tuple(d[:-1])
    for i in range(len(d)):
        conv_prelu(f"feat_extracts.{i}.0", cins[i], d[i])
        conv_prelu(f"feat_extracts.{i}.1", d[i], d[i])
    fused = s.fused
    fusion("cross_scale_feature_fusion", tuple(d[1:]), fused)
    for i in range(2):
        block(f"feat_enhance_transformer.{i}", fused, False)
    for i in range(2):
        block(f"local_motion_atmformer.{i}", fused, True)
    lm_hid = int(2 * fused * s.local_mlp_hidden_ratio)
    conv_prelu("local_motion_mlp.0", 2 * fused + 8, lm_hid)
    conv_prelu("local_motion_mlp.1", lm_hid, lm_hid)
    conv("local_motion_mlp.2", lm_hid, MOTION_OUT, 1)
    lfd = s.last_feat
    conv_prelu("last_feat_extract.0", d[-1], lfd)
    conv_prelu("last_feat_extract.1", lfd, lfd)
    gdim = s.global_dim
    fusion("global_feature_fusion", (d[-2], d[-1], lfd), gdim)
    for i in range(2):
        block(f"global_motion_atmformer.{i}", gdim, True)
    conv_prelu("global_motion_mlp.0", 2 * gdim + 8, s.global_mlp_hidden)
    conv_prelu("global_motion_mlp.1", s.global_mlp_hidden,
               s.global_mlp_hidden)
    conv("global_motion_mlp.2", s.global_mlp_hidden, MOTION_OUT, 1)
    fd1, fd2, fd3 = s.decoder
    mo = MOTION_OUT
    widths = [(2 * fd1 + mo, fd1 + mo), (fd1 + mo, fd2 + mo),
              (fd2 + mo, fd3 + mo)]
    for i, (cin, cout) in enumerate(widths):
        j = 0
        if i > 0:
            out.append((f"upsample_pyramid.{i}.0.weight", (cin,), "prelu", 0))
            j = 1
        deconv(f"upsample_pyramid.{i}.{j}", cin, cout)
        conv_prelu(f"upsample_pyramid.{i}.{j + 1}", cout, cout)
        conv(f"upsample_pyramid.{i}.{j + 2}", cout, cout, 3)
    hid = s.refine_hidden
    conv_prelu("proj", fd3 + mo + 15, hid)
    conv_prelu("down1.0", hid, hid)
    conv_prelu("down2.0", hid + fd2, 2 * hid)
    conv_prelu("down2.1", 2 * hid, 2 * hid)
    conv_prelu("down3.0", 2 * hid + fd1, 4 * hid)
    conv_prelu("down3.1", 4 * hid, 4 * hid)
    conv_prelu("down3.2", 4 * hid, 4 * hid)
    deconv("up1.0", 4 * hid, 2 * hid)
    conv_prelu("up1.1", 2 * hid, 2 * hid)
    deconv("up2.0", 4 * hid, 2 * hid)
    conv_prelu("up2.1", 2 * hid, hid)
    deconv("up3.0", 2 * hid, hid)
    conv_prelu("refine_head.0", 2 * hid, hid)
    conv_prelu("refine_head.1", hid, 3)
    return out


# ---- plain forms of the ops ----------------------------------------------
class Ops:
    """The tower ops under one `Precision`, over a state dict `w`."""

    def __init__(self, w: Dict[str, torch.Tensor], prec: Precision):
        self.w, self.p = w, prec

    def _prelu(self, y, name):
        a = self.w[name].float()
        return torch.where(y >= 0, y, a * y)

    def conv(self, x, name, stride=1, padding=None, dilation=1, groups=1,
             prelu: Optional[str] = None):
        """NHWC conv (+ bias, + PReLU) with nn.Conv2d's weight; f32 out."""
        w = self.w[name + ".weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        y = F.conv2d(self.p.cast(x).permute(0, 3, 1, 2), self.p.cast(w),
                     None, stride, pad, dilation, groups)
        y = y.permute(0, 2, 3, 1).float() + self.w[name + ".bias"].float()
        return y if prelu is None else self._prelu(y, prelu)

    def conv_prelu(self, x, p, stride=1):
        return self.conv(x, f"{p}.0", stride, prelu=f"{p}.1.weight")

    def deconv(self, x, p):
        """ConvTranspose k2 s2 + bias + PReLU."""
        y = F.conv_transpose2d(self.p.cast(x).permute(0, 3, 1, 2),
                               self.p.cast(self.w[f"{p}.0.weight"]),
                               None, stride=2)
        y = y.permute(0, 2, 3, 1).float() + self.w[f"{p}.0.bias"].float()
        return self._prelu(y, f"{p}.1.weight")

    def linear(self, x, name, bias=True):
        y = F.linear(self.p.cast(x), self.p.cast(self.w[name + ".weight"]))
        y = y.float()
        return y + self.w[name + ".bias"].float() if bias else y

    def ln(self, x, name):
        return F.layer_norm(x.float(), x.shape[-1:],
                            self.w[name + ".weight"].float(),
                            self.w[name + ".bias"].float(), LN_EPS)

    def matmul(self, a, b):
        return torch.matmul(self.p.cast(a), self.p.cast(b)).float()


def resize(x, h, w):
    """NHWC bilinear resize, align_corners=True."""
    if x.shape[1] == h and x.shape[2] == w:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def down2(x):
    return resize(x, x.shape[1] // 2, x.shape[2] // 2)


def up_flow(f, k=2):
    return resize(f, f.shape[1] * k, f.shape[2] * k) * k


def warp(x, flow):
    """Backward bilinear warp of NHWC x by flow (x, y), zeros outside."""
    B, H, W, _ = x.shape
    dev = x.device
    gx = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
    gy = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
    sx = (gx + flow[..., 0].float()) * (2.0 / max(W - 1, 1)) - 1.0
    sy = (gy + flow[..., 1].float()) * (2.0 / max(H - 1, 1)) - 1.0
    grid = torch.stack([sx, sy], -1)
    y = F.grid_sample(x.float().permute(0, 3, 1, 2), grid, mode="bilinear",
                      padding_mode="zeros", align_corners=True)
    return y.permute(0, 2, 3, 1)


# ---- windows ---------------------------------------------------------------
def _pads(h, w, ws):
    return math.ceil(h / ws) * ws - h, math.ceil(w / ws) * ws - w


def partition(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def unpartition(win, ws, H, W):
    C = win.shape[-1]
    B = win.shape[0] // ((H // ws) * (W // ws))
    x = win.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _label_mask(labels, ws):
    win = partition(labels[None, :, :, None], ws)[..., 0]  # [nW, N]
    return torch.where(win[:, None, :] != win[:, :, None], MASK_NEG, 0.0)


def window_mask(h, w, ws, shift, device) -> Optional[torch.Tensor]:
    """Additive [nW, N, N] mask: tokens of different centre-pad regions
    never attend to each other, nor, in a shifted block, tokens of
    different regions of the rolled canvas."""
    ph, pw = _pads(h, w, ws)
    hp, wp = h + ph, w + pw
    pad = None
    if ph or pw:
        lab = torch.zeros(hp, wp, device=device)
        hs = (slice(0, ph // 2), slice(ph // 2, h + ph // 2),
              slice(h + ph // 2, None))
        wsl = (slice(0, pw // 2), slice(pw // 2, w + pw // 2),
               slice(w + pw // 2, None))
        for i, a in enumerate(hs):
            for j, b in enumerate(wsl):
                lab[a, b] = 3 * i + j
        pad = _label_mask(lab, ws)
    if shift == 0:
        return pad
    lab = torch.zeros(hp, wp, device=device)
    sl = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for i, a in enumerate(sl):
        for j, b in enumerate(sl):
            lab[a, b] = 3 * i + j
    m = _label_mask(lab, ws)
    return m if pad is None else torch.where(pad != 0, MASK_NEG, m)


def rel_coords(ws, device):
    """[2, N, N]: rel[d, q, k] = coord_d(k) - coord_d(q); d = 0 is x."""
    t = torch.arange(ws * ws, device=device)
    c = torch.stack([t % ws, t // ws]).float()
    return c[:, None, :] - c[:, :, None]


def _attention(o: Ops, q, k, v, heads, mask, rel):
    """q, k, v [BW, N, C] -> (out [BW, N, C], motion [BW, N, 2h] or None)."""
    BW, N, C = q.shape
    d = C // heads

    def split(t):
        return t.reshape(BW, N, heads, d).transpose(1, 2)

    s = o.matmul(split(q), split(k).transpose(-1, -2)) * d ** -0.5
    if mask is not None:
        M = mask.shape[0]
        s = (s.reshape(BW // M, M, heads, N, N)
             + mask[None, :, None]).reshape(BW, heads, N, N)
    p = torch.softmax(s, -1)
    out = o.matmul(p, split(v)).transpose(1, 2).reshape(BW, N, C)
    motion = None
    if rel is not None:
        # the motion moment, from the f32 p: CUDA-core work, not a product
        motion = torch.stack([(p * rel[0]).sum(-1), (p * rel[1]).sum(-1)],
                             -1)
        motion = motion.transpose(1, 2).reshape(BW, N, 2 * heads)
    return out, motion


def swin_block(o: Ops, s: Sizes, x, p, ws, shift, motion: bool):
    """One ATMFormer (motion=True; frames stacked on the batch axis, each
    window attending to the same window of the other frame) or
    RefineBottleneck. The attention's residual lands on norm1(x)."""
    _, H, W, C = x.shape
    heads = s.num_heads
    mask = window_mask(H, W, ws, shift, x.device)
    ph, pw = _pads(H, W, ws)
    xp = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    if shift:
        xp = torch.roll(xp, (-shift, -shift), (1, 2))
    Hp, Wp = xp.shape[1:3]
    xw = partition(xp, ws)
    xn = o.ln(xw, f"{p}.norm1")
    if motion:
        BW = xn.shape[0]
        q = o.linear(xn, f"{p}.attn.q", bias=False)
        kv = o.linear(torch.roll(xn, -(BW // 2), 0), f"{p}.attn.kv",
                      bias=False)
        app, mot = _attention(o, q, kv[..., :C], kv[..., C:], heads, mask,
                              rel_coords(ws, x.device))
        m = mot.reshape(BW, -1, heads, 2).permute(0, 3, 1, 2)
        m = o.linear(F.gelu(o.linear(m, f"{p}.attn.mlp.0")),
                     f"{p}.attn.mlp.2")
        mot = m[..., 0].transpose(1, 2)  # [BW, N, 2]
    else:
        qkv = o.linear(xn, f"{p}.attn.qkv", bias=False)
        app, _ = _attention(o, qkv[..., :C], qkv[..., C:2 * C],
                            qkv[..., 2 * C:], heads, mask, None)
    y = xn + o.linear(app, f"{p}.attn.proj")

    def back(t):
        t = unpartition(t, ws, Hp, Wp)
        if shift:
            t = torch.roll(t, (shift, shift), (1, 2))
        return t[:, ph // 2:ph // 2 + H, pw // 2:pw // 2 + W]

    y = back(y)
    h = o.linear(o.ln(y, f"{p}.norm2"), f"{p}.mlp.fc1")
    h = o.conv(h, f"{p}.mlp.dwconv.dwconv", groups=h.shape[-1])
    y = y + o.linear(F.gelu(h), f"{p}.mlp.fc2")
    return (y, back(mot)) if motion else y


# ---- the network -----------------------------------------------------------
def _fusion(o: Ops, p, xs):
    ys, k = [], 0
    for i in range(len(xs) - 1):
        for j in range(2 ** i):
            ys.append(o.conv(xs[-2 - i], f"{p}.layers.{k}", stride=2 ** (i + 1),
                             padding=1 + j, dilation=1 + j))
            k += 1
    ys.append(xs[-1].float())
    return o.ln(o.conv(torch.cat(ys, -1), f"{p}.proj"), f"{p}.norm")


def _motion(o: Ops, s: Sizes, feat, blocks, head, ws):
    B = feat.shape[0] // 2
    chunks = []
    for i in range(2):
        feat, m = swin_block(o, s, feat, f"{blocks}.{i}", ws,
                             0 if i == 0 else ws // 2, True)
        chunks.append(torch.cat([m[:B], m[B:]], -1))
    x = torch.cat(chunks + [torch.cat([feat[:B], feat[B:]], -1)], -1)
    x = o.conv_prelu(o.conv_prelu(x, f"{head}.0"), f"{head}.1")
    return o.conv(x, f"{head}.2"), feat


def _split(out):
    out = out.float()
    return out[..., 0:2], out[..., 2:4], torch.sigmoid(out[..., 4:5])


def forward(w: Dict[str, torch.Tensor], s: Sizes, im0, im1,
            prec: Precision = Precision()):
    """The middle frame I_t [B, H, W, 3] (f32, clamped to [0, 1]) of frames
    im0, im1 [B, H, W, 3], with global motion on."""
    o = Ops(w, prec)
    im0, im1 = im0.float(), im1.float()
    B = im0.shape[0]
    levels = len(s.hidden_dims)
    pyr0, pyr1 = [im0], [im1]
    for _ in range(levels - 1):
        pyr0.append(down2(pyr0[-1]))
        pyr1.append(down2(pyr1[-1]))

    # encoder: four conv pairs, stride 2 from the second on
    x = torch.cat([im0, im1], 0)
    feats = []
    for i in range(levels):
        x = o.conv_prelu(x, f"feat_extracts.{i}.0", 1 if i == 0 else 2)
        x = o.conv_prelu(x, f"feat_extracts.{i}.1")
        if i > 0:
            feats.append(x)
    feat = _fusion(o, "cross_scale_feature_fusion", feats)

    # global motion on 1/16 tokens, then the pre-alignment
    g = o.conv_prelu(o.conv_prelu(x, "last_feat_extract.0", 2),
                     "last_feat_extract.1")
    gtok = _fusion(o, "global_feature_fusion", [feats[1], feats[2], g])
    gout, _ = _motion(o, s, gtok, "global_motion_atmformer",
                      "global_motion_mlp", s.global_window)
    gf0, gf1, _ = _split(gout)
    gf0, gf1 = up_flow(gf0), up_flow(gf1)
    feat = torch.cat([warp(feat[:B], gf0), warp(feat[B:], gf1)], 0)
    for i in reversed(range(levels)):
        pyr0[i], pyr1[i] = warp(pyr0[i], gf0), warp(pyr1[i], gf1)
        if i:
            gf0, gf1 = up_flow(gf0), up_flow(gf1)

    # local motion, enhancement
    out, feat = _motion(o, s, feat, "local_motion_atmformer",
                        "local_motion_mlp", s.local_window)
    flow0, flow1, _ = _split(out)
    for i in range(2):
        feat = swin_block(o, s, feat, f"feat_enhance_transformer.{i}",
                          s.enhance_window, 0 if i == 0 else
                          s.enhance_window // 2, False)
    feat = torch.cat([feat[:B], feat[B:]], -1)

    # decoder: warped features + head output, three x2 stages
    fd1 = s.decoder[0]
    feat = torch.cat([warp(feat[..., :fd1], flow0),
                      warp(feat[..., fd1:2 * fd1], flow1), out], -1)
    skips = []
    for i in range(3):
        p = f"upsample_pyramid.{i}"
        j = 0
        if i:
            feat = o._prelu(feat, f"{p}.0.weight")
            j = 1
        feat = o.deconv(feat, f"{p}.{j}")
        feat = o.conv_prelu(feat, f"{p}.{j + 1}")
        feat = o.conv(feat, f"{p}.{j + 2}")
        if i < 2:
            skips.append(feat[..., :-MOTION_OUT])
    flow0, flow1, occ = _split(feat[..., -MOTION_OUT:])
    w0, w1 = warp(pyr0[0], flow0), warp(pyr1[0], flow1)
    I_t = occ * w0 + (1 - occ) * w1

    # residual refinement U-Net
    f0 = o.conv_prelu(torch.cat([feat, im0, w0, im1, w1, I_t], -1), "proj")
    f1 = o.conv_prelu(f0, "down1.0", 2)
    f2 = o.conv_prelu(o.conv_prelu(torch.cat([f1, skips[1]], -1),
                                   "down2.0", 2), "down2.1")
    f3 = torch.cat([f2, skips[0]], -1)
    f3 = o.conv_prelu(f3, "down3.0", 2)
    f3 = o.conv_prelu(o.conv_prelu(f3, "down3.1"), "down3.2")
    c2 = torch.cat([o.conv_prelu(o.deconv(f3, "up1.0"), "up1.1"), f2], -1)
    c1 = torch.cat([o.conv_prelu(o.deconv(c2, "up2.0"), "up2.1"), f1], -1)
    ch = torch.cat([o.deconv(c1, "up3.0"), f0], -1)
    head = o.conv_prelu(o.conv_prelu(ch, "refine_head.0"), "refine_head.1")
    return torch.clamp(I_t + 2 * torch.sigmoid(head) - 1, 0.0, 1.0)


# ---- the pipeline around it --------------------------------------------------
def pad_amounts(h, w, divisor):
    """Replicate pad of (h, w) up to a multiple of `divisor`, floor first:
    (left, right, top, bottom)."""
    ph = -h % divisor
    pw = -w % divisor
    return pw // 2, pw - pw // 2, ph // 2, ph - ph // 2


def interpolate_uint8(w, s: Sizes, f0, f1, divisor: int,
                      prec: Precision = Precision()) -> torch.Tensor:
    """uint8 frames [H, W, 3] (torch, on the reference's device) -> the
    uint8 middle frame: /255, replicate pad, forward, unpad, round."""
    H, W, _ = f0.shape
    l, r, t, b = pad_amounts(H, W, divisor)

    def prep(f):
        x = f.float().permute(2, 0, 1)[None] / 255.0
        x = F.pad(x, (l, r, t, b), mode="replicate")
        return x.permute(0, 2, 3, 1)

    y = forward(w, s, prep(f0), prep(f1), prec)[0, t:t + H, l:l + W]
    return torch.round(y * 255.0).to(torch.uint8)
