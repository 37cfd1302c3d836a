#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`atmvfi_tpu_torch`) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --conv-sites   # the build and phase 3 alone
    python3 chip_smoke.py --route-kernels   # the build and phase 4 alone

Phases, one JSON object per line:
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions. TF32 is switched off for the f32 phases.
  2. build: the CUDA kernels of atmvfi_tpu_torch/csrc, built with nvcc
     for sm_90a into the git-ignored build directory.
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes of the main path (base model, 1080p input padded to
     1088x1920): max |d| (f32) and mean |d| (bf16), times with CUDA
     events, the bound from bytes and operations, and as a yardstick
     the library call that computes the same function (F.grid_sample
     for the warp; for the conv kernels K3-K6 the cuDNN conv + bias +
     F.prelu that they replace), at every distinct conv site.
  4. route kernels: K7 / K8 (window attention + motion, packed and
     head-major; the launch K1 runs too) at the three base window shapes
     and at the lite local and global ones (head dims 28 and 44), f32
     and bf16, K9 (fused warp + blend) at the five blend sites and K12
     (fused conv pair) at its four sites,
     against their plain versions, with CUDA-event times, bounds, the
     plain version's time and yardsticks (scaled_dot_product_attention,
     out only; grid_sample pair + blend and the K2 pair + blend; the two
     K3 launches and cuDNN conv + bias + F.prelu twice).
  5. main path: InterpolationPipeline.interpolate (base, bf16 towers,
     global motion on, seeded weights) on 1080x1920 frame pairs: the
     default routes (three frames), then the opt-in routes
     (attention_impl="pallas", warp_impl="tiled_blend",
     hcw_fuse_pairs=True) and the fast serving profile (two frames
     each); each run checks the output and the kernel launch counts of
     every wrapper (set to 0 just before it) and reports ms/frame.
  6. agreement: seeded f32 models on the card (kernels) against the
     port on the CPU (plain versions) at 256x448: base with global
     motion, lite with and without it, base on the opt-in routes and
     base under the fast profile.
  7. row-warp kernels: K10 (`warp_pair_srcfull`, the slab-row warp pair
     of the row-sharded schedule) against its plain version at the slab
     shapes of 2 and 4 shards at 1080p (full 1088x1920 f32 sources),
     and the single row warp (`flow_warp_rows`) at the 1/8 token shapes
     (bf16, [1, 136, 240, 384] sources): max |d|, CUDA-event times, the
     bound from the bytes the flows reach, the plain version's time and
     F.grid_sample on the full source as yardstick.
  8. spatial main path: InterpolationPipeline(mesh=make_mesh((1, n),
     ["cuda:0"] * n)) for n = 2 and 4 shards on the card (base, bf16,
     global motion on, 1080p, margin 96), two frames each after a
     warm-up: ms/frame, every wrapper's launches per frame against the
     schedule's (K10 2n, row warps 4n, ...), I_t against the monolithic
     forward on the card (mean |d| <= 1e-3).
  9. spatial agreement, f32 with TF32 off, base at 640x448, 2 shards
     (slabs [0, 512) and [128, 640)): spatial on the card against the
     monolithic forward on the card (max |d| <= 1e-4) and against
     spatial on the CPU (<= 1e-3); the ensemble forward on the card
     against the CPU (<= 1e-3).
Then the {"kernels": [...]} line, the card's name and power limit, and
the last line {"ok": true, "device": {...}}. With --conv-sites it runs
only the build and the K3-K6 sites and prints their times as one JSON
line (to compare two checkouts in one call); with --route-kernels only
the build and phase 4. Any failed phase raises and the script exits
non-zero; without a CUDA device, or without the repo beside it, it
exits non-zero before printing any result.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and the rate
# of each working type (bf16 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# launches per forward of the two-frame path (network.py): the pair
# warps are the 1/16 blend, 4 pyramid pre-aligns, the 1/8 blend and 3
# decoder blends; the single warps the 2 token pre-aligns and the 2
# decoder-input feature warps; K1 runs in 2 global, 2 local and 2
# enhancement blocks; the conv kernels as CONV_SITES counts them
PER_FORWARD = {"atm_block": 6, "flow_warp_pair": 9, "flow_warp": 4,
               "conv3x3": 22, "conv3x3_s2": 7, "conv3x3_multi": 2,
               "deconv2x": 6}
# the opt-in routes: K7 for K1, K9 at the 5 blend sites (beside their K2
# pair warps), K12 for the 3 decoder conv pairs and the refine head
ROUTES = dict(attention_impl="pallas", warp_impl="tiled_blend",
              hcw_fuse_pairs=True)
ROUTES_PER_FORWARD = {"window_attention": 6, "flow_warp_blend": 5,
                      "flow_warp_pair": 9, "flow_warp": 4, "conv3x3": 14,
                      "conv3x3_s2": 7, "conv3x3_multi": 2, "deconv2x": 6,
                      "conv3x3_pair": 4}
# the fast profile: no full-resolution pre-align pair (3 + 5 blends)
FAST_PER_FORWARD = dict(PER_FORWARD, flow_warp_pair=8)

# every conv-kernel site of the base main path at 1088x1920 (global
# motion on; frames stacked, so the encoder runs on batch 2):
# (wrapper, site, sources as (B, H, W, C, f32?), Cout, PReLU, launches
# per forward). Deconv sources are the half-resolution inputs. A conv
# source whose channel count is not a multiple of 8 is made as the
# main path gives it: a kernel's output, at a pixel stride rounded up
# to 8 (the deconvs read dense PReLU or concat outputs).
_F, _X = (1088, 1920), (544, 960)
CONV_SITES = [
    ("conv3x3", "encoder 24->24", [(2, *_F, 24, 0)], 24, 1, 1),
    ("conv3x3", "encoder 48->48", [(2, 544, 960, 48, 0)], 48, 1, 1),
    ("conv3x3", "encoder 96->96", [(2, 272, 480, 96, 0)], 96, 1, 1),
    ("conv3x3", "encoder 192->192", [(2, 136, 240, 192, 0)], 192, 1, 1),
    ("conv3x3", "local head 776->576", [(1, 136, 240, 776, 0)], 576, 1, 1),
    ("conv3x3", "local head 576->576", [(1, 136, 240, 576, 0)], 576, 1, 1),
    ("conv3x3", "last_feat 288->288", [(2, 68, 120, 288, 0)], 288, 1, 1),
    ("conv3x3", "global head 1352->768", [(1, 68, 120, 1352, 0)], 768, 1,
     1),
    ("conv3x3", "global head 768->768", [(1, 68, 120, 768, 0)], 768, 1, 1),
    ("conv3x3", "decoder 1/4 389->389", [(1, 272, 480, 389, 0)], 389, 1, 1),
    ("conv3x3", "decoder 1/4 389->389 plain", [(1, 272, 480, 389, 0)], 389,
     0, 1),
    ("conv3x3", "decoder 1/2 197->197", [(1, *_X, 197, 0)], 197, 1, 1),
    ("conv3x3", "decoder 1/2 197->197 plain", [(1, *_X, 197, 0)], 197, 0,
     1),
    ("conv3x3", "decoder 1/1 101->101", [(1, *_F, 101, 0)], 101, 1, 1),
    ("conv3x3", "decoder 1/1 101->101 plain", [(1, *_F, 101, 0)], 101, 0,
     1),
    ("conv3x3", "refine 128->128 1/4 (down2, up1)", [(1, 272, 480, 128, 0)],
     128, 1, 2),
    ("conv3x3", "refine down3 256->256", [(1, 136, 240, 256, 0)], 256, 1, 2),
    ("conv3x3", "refine up2 128->64", [(1, *_X, 128, 0)], 64, 1, 1),
    ("conv3x3", "refine head 128->64", [(1, *_F, 128, 0)], 64, 1, 1),
    ("conv3x3", "refine head 64->3", [(1, *_F, 64, 0)], 3, 1, 1),
    ("conv3x3_s2", "encoder 24->48", [(2, *_F, 24, 0)], 48, 1, 1),
    ("conv3x3_s2", "encoder 48->96", [(2, *_X, 48, 0)], 96, 1, 1),
    ("conv3x3_s2", "encoder 96->192", [(2, 272, 480, 96, 0)], 192, 1, 1),
    ("conv3x3_s2", "last_feat 192->288", [(2, 136, 240, 192, 0)], 288, 1,
     1),
    ("conv3x3_s2", "refine down1 64->64", [(1, *_F, 64, 0)], 64, 1, 1),
    ("conv3x3_s2", "refine down2 256->128", [(1, *_X, 256, 0)], 128, 1, 1),
    ("conv3x3_s2", "refine down3 512->256", [(1, 272, 480, 512, 0)], 256, 1,
     1),
    ("conv3x3_multi", "encoder first conv, f32 frames 3->24",
     [(2, *_F, 3, 1)], 24, 1, 1),
    ("conv3x3_multi", "refine proj 101 + 5 f32 images -> 64",
     [(1, *_F, 101, 0)] + [(1, *_F, 3, 1)] * 5, 64, 1, 1),
    ("deconv2x", "decoder 773->389", [(1, 136, 240, 773, 0)], 389, 1, 1),
    ("deconv2x", "decoder 389->197", [(1, 272, 480, 389, 0)], 197, 1, 1),
    ("deconv2x", "decoder 197->101", [(1, *_X, 197, 0)], 101, 1, 1),
    ("deconv2x", "refine up1 256->128", [(1, 136, 240, 256, 0)], 128, 1, 1),
    ("deconv2x", "refine up2 256->128", [(1, 272, 480, 256, 0)], 128, 1, 1),
    ("deconv2x", "refine up3 128->64", [(1, *_X, 128, 0)], 64, 1, 1),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of fn() over reps launches, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else
                                     "operations")


def edge_flow(torch, g, B: int, H: int, W: int, mag: float):
    """Random flows of magnitude `mag`, pushed outward near the border
    so taps fall off every edge."""
    f = (torch.rand(B, H, W, 2, generator=g, device="cuda") * 2 - 1) * mag
    f[:, :, :8, 0] -= mag      # taps off the left edge
    f[:, :, -8:, 0] += mag     # right
    f[:, :8, :, 1] -= mag      # top
    f[:, -8:, :, 1] += mag     # bottom
    return f.contiguous()


def grid_of(torch, flow):
    """grid_sample's normalised grid (align_corners) for a pixel flow."""
    _, H, W, _ = flow.shape
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda"),
                            torch.arange(W, device="cuda"), indexing="ij")
    return torch.stack([(xs + flow[..., 0]) * (2.0 / (W - 1)) - 1,
                        (ys + flow[..., 1]) * (2.0 / (H - 1)) - 1], -1)


# ---------------------------------------------------------------------
def block_case(torch, net, which: str, dtype):
    """(args, info) of one K1 call at the base 1080p main-path shapes,
    with the seeded model's own weights and random tokens."""
    from atmvfi_tpu_torch import ops

    c = net.cfg
    if which == "global":
        blk, h, w = net.global_motion_atmformer[1], 68, 120
    elif which == "local":
        blk, h, w = net.local_motion_atmformer[1], 136, 240
    else:
        blk, h, w = net.feat_enhance_transformer[0], 136, 240
    ws, ss = blk.window_size, blk.shift_size
    g = torch.Generator(device="cuda").manual_seed(1)
    C = blk.norm1.weight.shape[0]
    tokens = torch.randn(2, h, w, C, generator=g, device="cuda")
    xp = ops.center_pad(tokens, ws)
    x = ops.window_partition(torch.roll(xp, (-ss, -ss), (1, 2)) if ss
                             else xp, ws).to(dtype).contiguous()
    mask = ops.attn_mask_for(h, w, ws, ss, "cuda")
    a = blk.attn
    motion = which != "enhance"
    if motion:
        wq, wkv = a.q.weight, a.kv.weight
        rel = ops.relative_coords(ws, "cuda")
    else:
        wq, wkv = a.qkv.weight[:C], a.qkv.weight[C:]
        rel = None
    args = (x, wq, wkv, a.proj.weight, a.proj.bias, blk.norm1.weight,
            blk.norm1.bias, (C // c.num_heads) ** -0.5, rel, mask,
            c.num_heads, motion)
    BW, N, _ = x.shape
    s = x.element_size()
    hd = C // c.num_heads
    nbytes = (2 * BW * N * C * s + 4 * C * C * s + C * s + 2 * C * 4
              + (mask.numel() * 4 if mask is not None else 0)
              + (2 * N * N * 4 + BW * N * 2 * c.num_heads * s if motion
                 else 0))
    flops = (2 * BW * N * C * 4 * C                    # q, kv, proj
             + 4 * BW * c.num_heads * N * N * hd       # q k^T, p v
             + (4 * BW * c.num_heads * N * N if motion else 0))
    info = dict(BW=BW, N=N, C=C, heads=c.num_heads, swap=motion,
                mask=mask is not None, motion=motion)
    return args, info, nbytes, flops


def phase_kernels(torch):
    """Every kernel against its plain version at the main-path shapes."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch.models import Network, get_config
    from atmvfi_tpu_torch.ops import attention_cuda, warp_cuda
    from atmvfi_tpu_torch.ops.attention import atm_block_reference
    from atmvfi_tpu_torch.ops.warp import flow_warp as warp_plain

    results = {"atm_block": [], "flow_warp_pair": [], "flow_warp": []}
    net = Network(get_config("base")).cuda()
    tol = {torch.float32: ("max", 1e-4), torch.bfloat16: ("mean", 5e-3)}
    for which, reps in (("local", 10), ("global", 10), ("enhance", 10)):
        for dtype in (torch.float32, torch.bfloat16):
            args, info, nbytes, flops = block_case(torch, net, which, dtype)
            with torch.no_grad():
                y, m = attention_cuda.atm_block(*args)
                yr, mr = atm_block_reference(*args)
                torch.cuda.synchronize()
                dy = (y.float() - yr.float()).abs()
                dm = ((m.float() - mr.float()).abs() if m is not None
                      else torch.zeros(1, device="cuda"))
                stat, lim = tol[dtype]
                err = (max(dy.max().item(), dm.max().item()) if stat == "max"
                       else max(dy.mean().item(), dm.mean().item()))
                ms = cuda_ms(lambda: attention_cuda.atm_block(*args), reps)
                plain = cuda_ms(lambda: atm_block_reference(*args), reps)
            dt = "f32" if dtype == torch.float32 else "bf16"
            b_ms, b_by = bound_ms(nbytes, flops, dt)
            rec = dict(phase="kernel", kernel="K1 atm_block", case=which,
                       dtype=dt, **info, max_abs_err=dy.max().item(),
                       mean_abs_err=dy.mean().item(),
                       motion_max_abs_err=dm.max().item(), ms=ms,
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       flops=flops, bytes=nbytes)
            emit(rec)
            if not err <= lim:
                raise AssertionError(f"K1 {which} {dt}: {stat} |d| {err} "
                                     f"> {lim}")
            results["atm_block"].append(rec)
    del net

    g = torch.Generator(device="cuda").manual_seed(2)

    # pair warps of the main path, full resolution down to 1/16 (C = 3)
    # and the 1/8 feature warps (C = 384), as (shape, dtype, launches of
    # this shape per forward, checked tolerance)
    pair_cases = [((1, 1088 >> k, 1920 >> k, 3), torch.float32, n)
                  for k, n in ((0, 2), (1, 2), (2, 2), (3, 2), (4, 1))]
    single_cases = [((1, 136, 240, 384), torch.float32, 0),
                    ((1, 136, 240, 384), torch.bfloat16, 4)]
    for kind, cases in (("flow_warp_pair", pair_cases),
                        ("flow_warp", single_cases)):
        for shape, dtype, n in cases:
            B, H, W, C = shape
            n_img = 2 if kind == "flow_warp_pair" else 1
            imgs = [torch.rand(shape, generator=g, device="cuda").to(dtype)
                    for _ in range(n_img)]
            flows = [edge_flow(torch, g, B, H, W,
                               40.0 * H / 1088 if C == 3 else 8.0)
                     for _ in range(n_img)]
            if kind == "flow_warp_pair":
                run = lambda: warp_cuda.flow_warp_pair(*imgs, *flows)  # noqa
            else:
                run = lambda: (warp_cuda.flow_warp(imgs[0], flows[0]),)  # noqa
            plain = lambda: [warp_plain(i, f) for i, f in zip(imgs, flows)]  # noqa
            grids = [grid_of(torch, f) for f in flows]
            # grid_sample takes its grid in the input's dtype: time it on
            # the f32 values of the images (exact for bf16 ones)
            nchw = [i.float().permute(0, 3, 1, 2) for i in imgs]
            lib = lambda: [F.grid_sample(i, gr, mode="bilinear",  # noqa
                                         padding_mode="zeros",
                                         align_corners=True)
                           for i, gr in zip(nchw, grids)]
            outs, refs = run(), plain()
            torch.cuda.synchronize()
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(outs, refs))
            lib_err = max((l.permute(0, 2, 3, 1).float() - r.float()).abs()
                          .max().item() for l, r in zip(lib(), refs))
            reps = 50 if H >= 544 else 200
            ms, plain_ms, lib_ms = (cuda_ms(run, reps), cuda_ms(plain, reps),
                                    cuda_ms(lib, reps))
            s = imgs[0].element_size()
            nbytes = n_img * B * H * W * (2 * C * s + 2 * 4)
            flops = n_img * B * H * W * (7 * C + 12)
            dt = "f32" if dtype == torch.float32 else "bf16"
            b_ms, b_by = bound_ms(nbytes, flops, "f32")
            rec = dict(phase="kernel", kernel=f"K2 {kind}", shape=list(shape),
                       dtype=dt, per_forward=n, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       library_max_abs_err=lib_err, bound_ms=b_ms,
                       bound_by=b_by, bytes=nbytes)
            emit(rec)
            lim = 1e-5 if dtype == torch.float32 else 1e-2
            if not err <= lim:
                raise AssertionError(f"K2 {kind} {shape} {dt}: max |d| "
                                     f"{err} > {lim}")
            results[kind].append(rec)
    return results


def phase_conv_kernels(torch):
    """K3-K6 against their plain versions at every conv site of the main
    path: f32 max |d| <= 1e-4, bf16 mean |d| <= 1e-3; bf16 times of the
    kernel, the plain version and the library calls it replaces."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch.ops import conv as plain
    from atmvfi_tpu_torch.ops import conv_cuda, deconv_cuda
    from atmvfi_tpu_torch.ops.conv_cuda import empty_nhwc

    kernels = {"conv3x3": conv_cuda.conv3x3,
               "conv3x3_s2": conv_cuda.conv3x3_s2,
               "conv3x3_multi": conv_cuda.conv3x3_multi,
               "deconv2x": deconv_cuda.deconv2x}
    results = {k: [] for k in kernels}
    for k in kernels:  # the site list covers one forward's launches
        n = sum(site[-1] for site in CONV_SITES if site[0] == k)
        if n != PER_FORWARD[k]:
            raise AssertionError(f"CONV_SITES has {n} {k} launches, the "
                                 f"forward {PER_FORWARD[k]}")
    g = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda") * 2 - 1

    for kind, site, shapes, cout, prelu, n in CONV_SITES:
        deconv = kind == "deconv2x"
        stride = 2 if kind == "conv3x3_s2" else 1
        cin = sum(s[3] for s in shapes)
        B, H, W = shapes[0][:3]
        w = (rand(cin, cout, 2, 2) / (4 * cin) ** 0.5 if deconv
             else rand(cout, cin, 3, 3) / (9 * cin) ** 0.5)
        b = rand(cout) * 0.1
        a = rand(cout) * 0.3 if prelu else None
        base = [(rand(*s[:4]) * 0.5 + 0.5 if s[4] else rand(*s[:4]))
                for s in shapes]
        err = {}

        def layout(x, dt):  # as the main path hands the source over
            if deconv or x.shape[3] % 8 == 0:
                return x.to(dt)
            return empty_nhwc(*x.shape, dt, "cuda").copy_(x)

        for dt in (torch.float32, bf16):
            srcs = [x if s[4] else layout(x, dt) for x, s in zip(base, shapes)]
            if deconv:
                run = lambda: deconv_cuda.deconv2x(srcs[0], w, b, a)  # noqa
                ref = lambda: plain.deconv2x(srcs[0], w, b, a)  # noqa
            elif kind == "conv3x3_multi":
                run = lambda: conv_cuda.conv3x3_multi(srcs, w, b, a, dt)  # noqa
                ref = lambda: plain.conv3x3(srcs, w, b, a, 1, dt)  # noqa
            else:
                run = lambda: kernels[kind](srcs[0], w, b, a)  # noqa
                ref = lambda: plain.conv3x3(srcs, w, b, a, stride)  # noqa
            with torch.no_grad():
                y, yr = run(), ref()
                torch.cuda.synchronize()
                d = (y.float() - yr.float()).abs()
            err[dt] = (d.max().item(), d.mean().item())
            if y.dtype != dt or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{kind} {site}: bad output {y.dtype}")
            del y, yr, d
        dense = [x if s[4] else x.to(bf16) for x, s in zip(base, shapes)]

        def library():  # the library calls the kernel replaces, on dense
            # maps: casts, concat, cuDNN, bias, F.prelu
            xs = [x.to(bf16) for x in dense]
            x = (torch.cat(xs, -1) if len(xs) > 1 else xs[0]).permute(
                0, 3, 1, 2)
            if deconv:
                y = F.conv_transpose2d(x, w.to(bf16), b.to(bf16), stride=2)
            else:
                y = F.conv2d(x, w.to(bf16), b.to(bf16), stride, 1)
            return y if a is None else F.prelu(y, a.to(bf16))

        big = B * H * W >= 500_000
        reps = 5 if big else 20
        with torch.no_grad():
            ms, plain_ms, lib_ms = (cuda_ms(run, reps), cuda_ms(ref, reps),
                                    cuda_ms(library, reps))
        out_px = (4 * B * H * W if deconv
                  else B * (-(-H // stride)) * (-(-W // stride)))
        nbytes = (sum(x.numel() * x.element_size() for x in srcs)
                  + 4 * (w.numel() + b.numel() + (a.numel() if prelu else 0))
                  + 2 * out_px * cout)
        flops = (2 * B * H * W * 4 * cout * cin if deconv
                 else 2 * out_px * cout * 9 * cin)
        b_ms, b_by = bound_ms(nbytes, flops, "bf16")
        (f_max, _), (h_max, h_mean) = err[torch.float32], err[bf16]
        rec = dict(phase="kernel", kernel=kind, site=site,
                   sources=[list(s[:4]) + ["f32" if s[4] else "work"]
                            for s in shapes], cout=cout, prelu=bool(prelu),
                   per_forward=n, f32_max_abs_err=f_max,
                   bf16_mean_abs_err=h_mean, bf16_max_abs_err=h_max,
                   max_abs_err=max(f_max, h_max), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   flops=flops, bytes=nbytes)
        emit(rec)
        if not (f_max <= 1e-4 and h_mean <= 1e-3):
            raise AssertionError(f"{kind} {site}: f32 max |d| {f_max} "
                                 f"(<= 1e-4), bf16 mean |d| {h_mean} "
                                 "(<= 1e-3)")
        results[kind].append(rec)
        del srcs, base, dense
        torch.cuda.empty_cache()
    return results


# window shapes of the attention sites at 1080p: (site, tokens h x w of
# one frame, window, shift, motion, channels C of 8 heads); the two
# frames' windows are stacked. Base: head dims 48 and 84; lite: 28 and
# 44, which the bf16 kernel pads to 32 and 48.
ATTN_SITES = [("local", 136, 240, 8, 4, True, 384),
              ("global", 68, 120, 12, 6, True, 672),
              ("enhance", 136, 240, 8, 0, False, 384),
              ("lite local", 136, 240, 8, 4, True, 224),
              ("lite global", 68, 120, 12, 6, True, 352)]
# K9 blend sites (1/16 ... full resolution) and K12 sites: (site, H, W,
# Cin, Cmid, Cout, PReLU after conv_b)
BLEND_SITES = [(1088 >> k, 1920 >> k) for k in (4, 3, 2, 1, 0)]
PAIR_SITES = [("decoder 1/4", 272, 480, 389, 389, 389, False),
              ("decoder 1/2", 544, 960, 197, 197, 197, False),
              ("decoder 1/1", 1088, 1920, 101, 101, 101, False),
              ("refine head", 1088, 1920, 128, 64, 3, True)]


def phase_route_kernels(torch):
    """K7 / K8, K9 and K12 against their plain versions at the main-path
    shapes of the opt-in routes."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch import ops
    from atmvfi_tpu_torch.ops import attention as attn_plain
    from atmvfi_tpu_torch.ops import attention_cuda, conv_cuda, warp_cuda
    from atmvfi_tpu_torch.ops import conv as conv_plain
    from atmvfi_tpu_torch.ops import warp as warp_plain
    from atmvfi_tpu_torch.ops.conv_cuda import empty_nhwc

    results = {"window_attention": [], "window_attention_heads": [],
               "flow_warp_blend": [], "conv3x3_pair": []}
    g = torch.Generator(device="cuda").manual_seed(6)
    tol = {torch.float32: ("max", 1e-4), torch.bfloat16: ("mean", 5e-3)}
    heads = 8
    for site, h, w, ws, ss, motion, C in ATTN_SITES:
        hd = C // heads
        mask = ops.attn_mask_for(h, w, ws, ss, "cuda")
        rel = ops.relative_coords(ws, "cuda") if motion else None
        BW, N = 2 * -(-h // ws) * -(-w // ws), ws * ws  # windows, padded map
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(BW, N, 3 * C, generator=g, device="cuda").to(dtype)
            heads_of = lambda t: t.reshape(BW, N, heads, hd).transpose(1, 2)  # noqa
            q, kv = qkv[..., :C], qkv[..., C:]
            qh, kh, vh = (heads_of(t).contiguous()
                          for t in (q, kv[..., :C], kv[..., C:]))
            full = (None if mask is None else
                    mask.repeat(BW // mask.shape[0], 1, 1)[:, None].to(dtype))
            scale = hd ** -0.5
            for kind in ("window_attention", "window_attention_heads"):
                if kind == "window_attention":
                    args = (q, kv, scale, rel, mask, heads)
                    plain = attn_plain.window_attention
                else:
                    args = (qh, kh, vh, scale, rel, mask)
                    plain = attn_plain.window_attention_heads
                fn = getattr(attention_cuda, kind)
                with torch.no_grad():
                    (o, m), (orf, mrf) = fn(*args), plain(*args)
                    torch.cuda.synchronize()
                    do = (o.float() - orf.float()).abs()
                    dm = ((m.float() - mrf.float()).abs() if motion
                          else torch.zeros(1, device="cuda"))
                    stat, lim = tol[dtype]
                    err = (max(do.max().item(), dm.max().item())
                           if stat == "max"
                           else max(do.mean().item(), dm.mean().item()))
                    ms = cuda_ms(lambda: fn(*args), 10)
                    plain_ms = cuda_ms(lambda: plain(*args), 5)
                    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=full, scale=scale), 10)
                s_ = qkv.element_size()
                nbytes = (4 * BW * N * C * s_
                          + (mask.numel() * 4 if mask is not None else 0)
                          + (2 * N * N * 4 + BW * N * 2 * heads * s_
                             if motion else 0))
                flops = (4 * BW * heads * N * N * hd
                         + (4 * BW * heads * N * N if motion else 0))
                dt = "f32" if dtype == torch.float32 else "bf16"
                b_ms, b_by = bound_ms(nbytes, flops, dt)
                name = "K7" if kind == "window_attention" else "K8"
                rec = dict(phase="kernel", kernel=f"{name} {kind}", case=site,
                           dtype=dt, BW=BW, N=N, C=C, heads=heads,
                           mask=mask is not None, motion=motion,
                           max_abs_err=do.max().item(),
                           mean_abs_err=do.mean().item(),
                           motion_max_abs_err=dm.max().item(),
                           motion_mean_abs_err=dm.mean().item(), ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           ms_over_library=ms / lib_ms,
                           library="scaled_dot_product_attention, out only",
                           bound_ms=b_ms, bound_by=b_by, flops=flops,
                           bytes=nbytes)
                emit(rec)
                if not err <= lim:
                    raise AssertionError(f"{name} {site} {dt}: {stat} |d| "
                                         f"{err} > {lim}")
                results[kind].append(rec)
            del qkv, q, kv, qh, kh, vh, full
    torch.cuda.empty_cache()

    for H, W in BLEND_SITES:
        im0, im1 = (torch.rand(1, H, W, 3, generator=g, device="cuda")
                    for _ in range(2))
        f0, f1 = (edge_flow(torch, g, 1, H, W, 40.0 * H / 1088)
                  for _ in range(2))
        occ = torch.rand(1, H, W, 1, generator=g, device="cuda")
        args = (im0, im1, f0, f1, occ)
        grids = [grid_of(torch, f) for f in (f0, f1)]
        nchw = [i.permute(0, 3, 1, 2) for i in (im0, im1)]
        occ_c = occ.permute(0, 3, 1, 2)

        def library():
            w0, w1 = (F.grid_sample(i, gr, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
                      for i, gr in zip(nchw, grids))
            return occ_c * w0 + (1 - occ_c) * w1

        def k2_pair_blend():
            w0, w1 = warp_cuda.flow_warp_pair(im0, im1, f0, f1)
            return occ * w0 + (1 - occ) * w1

        out = warp_cuda.flow_warp_blend(*args)
        ref = warp_plain.flow_warp_blend(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        pair_err = (k2_pair_blend() - ref).abs().max().item()
        reps = 50 if H >= 544 else 200
        ms = cuda_ms(lambda: warp_cuda.flow_warp_blend(*args), reps)
        plain_ms = cuda_ms(lambda: warp_plain.flow_warp_blend(*args), reps)
        lib_ms = cuda_ms(library, reps)
        pair_ms = cuda_ms(k2_pair_blend, reps)
        nbytes = H * W * (2 * 3 * 4 + 2 * 2 * 4 + 4 + 3 * 4)
        b_ms, b_by = bound_ms(nbytes, H * W * (14 * 3 + 30), "f32")
        rec = dict(phase="kernel", kernel="K9 flow_warp_blend",
                   shape=[1, H, W, 3], dtype="f32", per_forward=1,
                   max_abs_err=err, k2_pair_blend_max_abs_err=pair_err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   library="2 x grid_sample + blend",
                   k2_pair_blend_ms=pair_ms, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes)
        emit(rec)
        if not err <= 1e-6:
            raise AssertionError(f"K9 {H}x{W}: max |d| {err} > 1e-6")
        results["flow_warp_blend"].append(rec)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda") * 2 - 1

    bf16 = torch.bfloat16
    for site, H, W, cin, cmid, cout, prelu_b in PAIR_SITES:
        wa = rand(cmid, cin, 3, 3) / (9 * cin) ** 0.5
        wb = rand(cout, cmid, 3, 3) / (9 * cmid) ** 0.5
        ba, bb = rand(cmid) * 0.1, rand(cout) * 0.1
        sa, sb = rand(cmid) * 0.3, (rand(cout) * 0.3 if prelu_b else None)
        x = rand(1, H, W, cin)
        err = {}
        for dt in (torch.float32, bf16):  # xs stays the bf16 input
            # as the main path hands it over: a K6 output (pixel stride
            # rounded up to 8) or a dense concat
            xs = empty_nhwc(1, H, W, cin, dt, "cuda").copy_(x)
            with torch.no_grad():
                y = conv_cuda.conv3x3_pair(xs, wa, ba, sa, wb, bb, sb)
                yr = conv_plain.conv3x3_pair(xs, wa, ba, sa, wb, bb, sb)
                torch.cuda.synchronize()
                d = (y.float() - yr.float()).abs()
            if y.dtype != dt or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"K12 {site}: bad output {y.dtype}")
            err[dt] = (d.max().item(), d.mean().item())
            del y, yr, d
        dense = x.to(bf16)

        def library():
            y = F.prelu(F.conv2d(dense.permute(0, 3, 1, 2), wa.to(bf16),
                                 ba.to(bf16), 1, 1), sa.to(bf16))
            y = F.conv2d(y, wb.to(bf16), bb.to(bf16), 1, 1)
            return y if sb is None else F.prelu(y, sb.to(bf16))

        run = lambda: conv_cuda.conv3x3_pair(xs, wa, ba, sa, wb, bb, sb)  # noqa
        ref = lambda: conv_plain.conv3x3_pair(xs, wa, ba, sa, wb, bb, sb)  # noqa
        k3 = lambda: conv_cuda.conv3x3(conv_cuda.conv3x3(xs, wa, ba, sa),  # noqa
                                       wb, bb, sb)
        with torch.no_grad():
            ms, plain_ms, lib_ms, k3_ms = (cuda_ms(f, 5) for f in
                                           (run, ref, library, k3))
        nbytes = (H * W * (cin + cout) * 2
                  + 4 * (wa.numel() + wb.numel()) + 4 * 2 * (cmid + cout))
        flops = 2 * H * W * 9 * (cin * cmid + cmid * cout)
        b_ms, b_by = bound_ms(nbytes, flops, "bf16")
        (f_max, _), (h_max, h_mean) = err[torch.float32], err[bf16]
        rec = dict(phase="kernel", kernel="K12 conv3x3_pair", site=site,
                   shape=[1, H, W], channels=[cin, cmid, cout],
                   prelu_b=prelu_b, per_forward=1, f32_max_abs_err=f_max,
                   bf16_mean_abs_err=h_mean, bf16_max_abs_err=h_max,
                   max_abs_err=max(f_max, h_max), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library="cuDNN conv + bias + F.prelu, "
                   "twice", two_k3_ms=k3_ms, ms_over_library=ms / lib_ms,
                   ms_over_two_k3=ms / k3_ms, bound_ms=b_ms, bound_by=b_by,
                   flops=flops, bytes=nbytes)
        emit(rec)
        if not (f_max <= 1e-4 and h_mean <= 1e-3):
            raise AssertionError(f"K12 {site}: f32 max |d| {f_max} (<= 1e-4),"
                                 f" bf16 mean |d| {h_mean} (<= 1e-3)")
        results["conv3x3_pair"].append(rec)
        del xs, x, dense
        torch.cuda.empty_cache()
    return results


def smooth_frames(torch, n: int, H: int, W: int, seed: int):
    """n uint8 frame pairs: smooth random images, the second moved by a
    few pixels, made on the CPU from a seed."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    pairs = []
    for _ in range(n):
        base = torch.rand(1, 3, H // 16 + 2, W // 16 + 2, generator=g)
        img = F.interpolate(base, size=(H + 32, W + 32), mode="bicubic",
                            align_corners=False).clamp(0, 1)
        dx, dy = (int(v) for v in torch.randint(-6, 7, (2,), generator=g))
        f0 = img[0, :, 16:16 + H, 16:16 + W]
        f1 = img[0, :, 16 + dy:16 + dy + H, 16 + dx:16 + dx + W]
        pairs.append(tuple((f * 255).round().to(torch.uint8)
                           .permute(1, 2, 0).contiguous().numpy()
                           for f in (f0, f1)))
    return pairs


COUNTED = {  # wrapper name -> (module, attribute) of every kernel wrapper
    "atm_block": ("attention_cuda", "atm_block"),
    "window_attention": ("attention_cuda", "window_attention"),
    "window_attention_heads": ("attention_cuda", "window_attention_heads"),
    "flow_warp_pair": ("warp_cuda", "flow_warp_pair"),
    "flow_warp": ("warp_cuda", "flow_warp"),
    "flow_warp_blend": ("warp_cuda", "flow_warp_blend"),
    "conv3x3": ("conv_cuda", "conv3x3"),
    "conv3x3_s2": ("conv_cuda", "conv3x3_s2"),
    "conv3x3_multi": ("conv_cuda", "conv3x3_multi"),
    "conv3x3_pair": ("conv_cuda", "conv3x3_pair"),
    "deconv2x": ("deconv_cuda", "deconv2x"),
    "warp_pair_srcfull": ("warp_cuda", "warp_pair_srcfull"),
    "flow_warp_rows": ("warp_cuda", "flow_warp_rows"),
}


def phase_main_path(torch, name: str, routes: dict, fast: bool,
                    per_forward: dict, frames: int):
    """One run of the serving path; every wrapper's count is set to 0
    just before the timed frames and read just after."""
    import dataclasses
    import importlib

    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.models import get_config

    counters = {k: getattr(importlib.import_module(
        f"atmvfi_tpu_torch.ops.{mod}"), attr)
        for k, (mod, attr) in COUNTED.items()}
    cfg = dataclasses.replace(get_config("base"), **routes)
    pipe = InterpolationPipeline(None, cfg, torch.bfloat16,
                                 global_motion=True, device="cuda",
                                 fast=fast)
    pairs = smooth_frames(torch, frames + 1, 1080, 1920, seed=3)
    pipe.interpolate(*pairs[0])  # warm-up: cuDNN plans, masks
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [pipe.interpolate(f0, f1) for f0, f1 in pairs[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n = len(outs)
    for o in outs:
        if o.shape != (1080, 1920, 3) or o.dtype.name != "uint8":
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
    for k in COUNTED:
        if launches[k] != per_forward.get(k, 0) * n:
            raise AssertionError(f"{name}: {k}: {launches[k]} launches in "
                                 f"{n} forwards, expected "
                                 f"{per_forward.get(k, 0)} each")
    # the middle frame of a shifted pair lies near both inputs
    f0, f1 = pairs[1]
    err = float(abs(outs[0].astype("float32") - f0.astype("float32")).mean())
    emit(dict(phase="main_path", config=name, model="base", dtype="bf16",
              routes=routes, fast=fast, frames=n, size=[1080, 1920],
              padded=[1088, 1920], ms_per_frame=dt * 1e3 / n,
              launches=launches, mean_abs_diff_to_frame0_u8=err,
              gpu=nvidia_smi_line()))
    del pipe
    torch.cuda.empty_cache()
    return launches


def phase_agreement(torch):
    """Seeded f32 models on the card (kernels) against the port on the
    CPU (plain versions): base with global motion, lite with and
    without it, base on the opt-in routes and under the fast profile."""
    import dataclasses

    from atmvfi_tpu_torch.models import Network, get_config

    H, W = 256, 448
    f0, f1 = smooth_frames(torch, 1, H, W, seed=5)[0]
    ims = [torch.from_numpy(f).float()[None] / 255.0 for f in (f0, f1)]
    base = get_config("base")
    for model, global_motion, cfg in (
            ("base", True, base), ("lite", True, get_config("lite")),
            ("lite", False, get_config("lite")),
            ("base routes", True, dataclasses.replace(base, **ROUTES)),
            ("base fast", True, base.fast())):
        net = Network(cfg).eval()  # seed 0, f32
        with torch.no_grad():
            cpu = net(*ims, global_motion=global_motion)["I_t"]
            net = net.cuda()
            gpu = net(*(i.cuda() for i in ims),
                      global_motion=global_motion)["I_t"].cpu()
        if not bool(torch.isfinite(gpu).all()) or gpu.shape != (1, H, W, 3):
            raise AssertionError(f"bad I_t {tuple(gpu.shape)}")
        err = (gpu - cpu).abs().max().item()
        emit(dict(phase="agreement", model=model, dtype="f32", size=[H, W],
                  global_motion=global_motion, I_t_max_abs_err=err,
                  tolerance=1e-3))
        if not err <= 1e-3:
            raise AssertionError(f"{model}: card vs CPU I_t max |d| {err} "
                                 "> 1e-3")


def spatial_per_frame(n: int) -> dict:
    """Launches per frame of the deep row-sharded schedule with global
    motion, n shards on one card. Per shard: the front (K5 1, K3 5, K4
    4), the local blocks, head and enhancement (K1 4, K3 2), 2 token
    pre-align + 2 decoder-input row warps, the three decoder stages (K6
    3, K3 6), the scale-0 pre-align and blend (K10 2) and the refinement
    (K5 1, K4 3, K3 7, K6 3); once on the card, the replicated global
    branch (K1 2, K3 2)."""
    return {"atm_block": 4 * n + 2, "conv3x3": 20 * n + 2,
            "conv3x3_s2": 7 * n, "conv3x3_multi": 2 * n, "deconv2x": 6 * n,
            "flow_warp_rows": 4 * n, "warp_pair_srcfull": 2 * n}


def slab(n: int, i: int, H: int = 1088, margin: int = 96):
    """(row0, rows) of shard i's slab (parallel/spatial.py slab_geometry)."""
    h_loc = H // n
    m = min(margin, (n - 1) * h_loc, (H - h_loc) // 2) // 16 * 16
    return min(max(i * h_loc - m, 0), H - h_loc - 2 * m), h_loc + 2 * m


def rows_reached(torch, flow, row0: int, H_src: int, fold: bool) -> int:
    """Source rows between the lowest and highest tap row that a row warp
    of these flows reads (clipped to the source)."""
    H_out = flow.shape[1]
    i = torch.arange(H_out, device=flow.device, dtype=torch.float32)
    fy = flow[0, ..., 1]
    y = (i[:, None] + (fy + row0)) if fold else ((i[:, None] + row0) + fy)
    lo = int(torch.floor(y).min().clamp(0, H_src - 1))
    hi = int((torch.floor(y) + 1).max().clamp(0, H_src - 1))
    return hi - lo + 1


def phase_row_warps(torch):
    """K10 and the single row warp against their plain versions at the
    row-sharded schedule's shapes at 1080p (n = 2 and 4)."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch.ops import warp as warp_plain
    from atmvfi_tpu_torch.ops import warp_cuda

    results = {"warp_pair_srcfull": [], "flow_warp_rows": []}
    g = torch.Generator(device="cuda").manual_seed(8)
    H, W = 1088, 1920
    ims = [torch.rand(1, H, W, 3, generator=g, device="cuda")
           for _ in range(2)]
    nchw = [i.permute(0, 3, 1, 2) for i in ims]

    def norm_grid(flow, row0, H_src, fold):
        _, h, w, _ = flow.shape
        ys, xs = torch.meshgrid(torch.arange(h, device="cuda"),
                                torch.arange(w, device="cuda"), indexing="ij")
        fy = flow[..., 1]
        y = ys + (fy + row0) if fold else (ys + row0) + fy
        return torch.stack([(xs + flow[..., 0]) * (2.0 / (w - 1)) - 1,
                            y * (2.0 / (H_src - 1)) - 1], -1)

    for n in (2, 4):  # every slab of the schedule, 2 launches each/frame
        for i in range(n):
            row0, h = slab(n, i)
            fl = [edge_flow(torch, g, 1, h, W, 40.0) for _ in range(2)]
            run = lambda: warp_cuda.warp_pair_srcfull(*ims, *fl, row0)  # noqa
            plain = lambda: warp_plain.warp_pair_srcfull(*ims, *fl, row0)  # noqa
            grids = [norm_grid(f, row0, H, True) for f in fl]
            lib = lambda: [F.grid_sample(x, gr, mode="bilinear",  # noqa
                                         padding_mode="zeros",
                                         align_corners=True)
                           for x, gr in zip(nchw, grids)]
            outs, refs = run(), plain()
            torch.cuda.synchronize()
            err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
            lib_err = max((l.permute(0, 2, 3, 1) - r).abs().max().item()
                          for l, r in zip(lib(), refs))
            ms, plain_ms, lib_ms = (cuda_ms(run, 50), cuda_ms(plain, 10),
                                    cuda_ms(lib, 50))
            src_rows = sum(rows_reached(torch, f, row0, H, True) for f in fl)
            nbytes = (2 * h * W * (3 * 4 + 2 * 4)   # outputs + flows
                      + src_rows * W * 3 * 4)       # source rows reached
            b_ms, b_by = bound_ms(nbytes, 2 * h * W * (7 * 3 + 14), "f32")
            rec = dict(phase="kernel", kernel="K10 warp_pair_srcfull",
                       shards=n, shard=i, row0=row0, out_rows=h,
                       source=[1, H, W, 3], dtype="f32", per_forward=2,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library="2 x grid_sample of the "
                       "full source", library_max_abs_err=lib_err,
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                       source_rows_reached=src_rows)
            emit(rec)
            if not err <= 1e-6:
                raise AssertionError(f"K10 n={n} shard {i}: max |d| {err} "
                                     "> 1e-6")
            results["warp_pair_srcfull"].append(rec)
    del ims, nchw

    # the row warps of the 1/8 token maps (base: 384 channels per frame;
    # the decoder-input warps read a channel half of the 768-wide
    # enhanced features in place): (site, rows, row0, per frame), from
    # the 4-shard schedule (token slab 112 rows at 0 or 24, decoder-input
    # slab 58 rows) and the 2-shard one (136 rows at 0; 92 rows)
    tok = torch.rand(1, 136, 240, 768, generator=g,
                     device="cuda").to(torch.bfloat16)
    for site, src, h, row0, per in (
            ("token pre-align, 4 shards", tok[..., :384].contiguous(), 112,
             24, 8),
            ("decoder input, 4 shards", tok[..., :384], 58, 56, 8),
            ("token pre-align, 2 shards", tok[..., :384].contiguous(), 136,
             0, 4),
            ("decoder input, 2 shards", tok[..., 384:], 92, 44, 4)):
        fl = edge_flow(torch, g, 1, h, 240, 8.0)
        run = lambda: warp_cuda.flow_warp_rows(src, fl, row0)  # noqa
        plain = lambda: warp_plain.flow_warp_rows(src, fl, row0)  # noqa
        src_f = src.float().permute(0, 3, 1, 2)
        grid = norm_grid(fl, row0, 136, False)
        lib = lambda: F.grid_sample(src_f, grid, mode="bilinear",  # noqa
                                    padding_mode="zeros", align_corners=True)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ms, plain_ms, lib_ms = (cuda_ms(run, 100), cuda_ms(plain, 20),
                                cuda_ms(lib, 100))
        nbytes = (h * 240 * (384 * 2 + 2 * 4)
                  + rows_reached(torch, fl, row0, 136, False) * 240 * 384 * 2)
        b_ms, b_by = bound_ms(nbytes, h * 240 * (7 * 384 + 14), "f32")
        rec = dict(phase="kernel", kernel="flow_warp_rows", site=site,
                   out_rows=h, row0=row0, source=[1, 136, 240, 384],
                   pixel_stride=src.stride(2), dtype="bf16", per_forward=per,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library="grid_sample of the full "
                   "source (f32 values)", bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes)
        emit(rec)
        if not err <= 1e-2:  # K2's bf16 limit; one rounding on both
            raise AssertionError(f"flow_warp_rows {site}: max |d| {err} "
                                 "> 1e-2")
        results["flow_warp_rows"].append(rec)
    del tok
    torch.cuda.empty_cache()
    return results


def phase_spatial_main_path(torch, n: int, frames: int = 2):
    """The row-sharded schedule with n shards on the card through the
    pipeline; every wrapper's count is set to 0 just before the timed
    frames and read just after."""
    import importlib

    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.parallel import make_mesh

    counters = {k: getattr(importlib.import_module(
        f"atmvfi_tpu_torch.ops.{mod}"), attr)
        for k, (mod, attr) in COUNTED.items()}
    mesh = make_mesh((1, n), ["cuda:0"] * n)
    pipe = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, mesh=mesh)
    mono = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, device="cuda")
    pairs = smooth_frames(torch, frames + 1, 1080, 1920, seed=7)
    pipe.interpolate(*pairs[0])  # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [pipe.interpolate(f0, f1) for f0, f1 in pairs[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    per_frame = spatial_per_frame(n)
    for o in outs:
        if o.shape != (1080, 1920, 3) or o.dtype.name != "uint8":
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
    for k in COUNTED:
        if launches[k] != per_frame.get(k, 0) * frames:
            raise AssertionError(f"spatial n={n}: {k}: {launches[k]} "
                                 f"launches in {frames} frames, expected "
                                 f"{per_frame.get(k, 0)} each")
    # I_t of the padded frames against the monolithic forward
    x0, x1 = (torch.from_numpy(f).cuda().float()[None] / 255.0
              for f in pairs[1])
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x.permute(0, 3, 1, 2), (0, 0, 4, 4), mode="replicate").permute(
            0, 2, 3, 1)
    x0, x1 = pad(x0), pad(x1)
    d = (pipe.interpolate_device(x0, x1)
         - mono.interpolate_device(x0, x1)).abs()
    mean, mx = d.mean().item(), d.max().item()
    emit(dict(phase="spatial_main_path", model="base", dtype="bf16",
              shards=n, devices=[str(v) for v in pipe.shard_devices],
              margin=96, slabs=[list(slab(n, i)) for i in range(n)],
              frames=frames, size=[1080, 1920], padded=[1088, 1920],
              ms_per_frame=dt * 1e3 / frames,
              launches_per_frame={k: v / frames for k, v in launches.items()
                                  if v},
              I_t_vs_monolithic_mean_abs=mean, I_t_vs_monolithic_max_abs=mx,
              tolerance_mean=1e-3, gpu=nvidia_smi_line()))
    if not mean <= 1e-3:
        raise AssertionError(f"spatial n={n}: I_t mean |d| {mean} against "
                             "the monolithic forward > 1e-3")
    del pipe, mono
    torch.cuda.empty_cache()
    return launches


def phase_spatial_agreement(torch):
    """f32, TF32 off, base at 640x448: 2-shard spatial on the card against
    the monolithic forward on the card and against spatial on the CPU;
    the ensemble forward on the card against the CPU."""
    from atmvfi_tpu_torch.models import Network, get_config
    from atmvfi_tpu_torch.parallel import make_mesh, make_spatial_forward

    H, W = 640, 448
    f0, f1 = smooth_frames(torch, 1, H, W, seed=9)[0]
    ims = [torch.from_numpy(f).float()[None] / 255.0 for f in (f0, f1)]
    net = Network(get_config("base")).eval()  # seed 0, f32
    with torch.no_grad():
        cpu = make_spatial_forward(net, make_mesh((1, 2), ["cpu"] * 2))(*ims)
        cpu_ens = net(*ims, ensemble_global_motion=True)["I_t"]
        net = net.cuda()
        g = [i.cuda() for i in ims]
        gpu = make_spatial_forward(net, make_mesh((1, 2), ["cuda:0"] * 2))(*g)
        mono = net(*g)["I_t"].clamp(0, 1)
        gpu_ens = net(*g, ensemble_global_motion=True)["I_t"]
    for name, a, b, lim in (
            ("spatial card vs monolithic card", gpu, mono, 1e-4),
            ("spatial card vs spatial CPU", gpu.cpu(), cpu, 1e-3),
            ("ensemble card vs CPU", gpu_ens.cpu(), cpu_ens, 1e-3)):
        if not bool(torch.isfinite(a).all()) or a.shape != (1, H, W, 3):
            raise AssertionError(f"{name}: bad I_t {tuple(a.shape)}")
        err = (a - b).abs().max().item()
        emit(dict(phase="spatial_agreement", check=name, model="base",
                  dtype="f32", size=[H, W], shards=2, margin=96,
                  I_t_max_abs_err=err, tolerance=lim))
        if not err <= lim:
            raise AssertionError(f"{name}: I_t max |d| {err} > {lim}")


def kernel_line(results, launches):
    """One entry per kernel wrapper; times are per launch, averaged over
    the cases of one forward weighted by their launches per forward.
    `launches` holds each wrapper's count from the run of the path it is
    on, and "k11" the K2 launches of the fast profile's run."""
    meta = {
        "atm_block": ("K1 fused ATM block", "atmvfi_tpu_torch/csrc/atm_block.cu",
                      "atmvfi_tpu/ops/attention_pallas.py:435"),
        "flow_warp_pair": ("K2 backward warp, pair form",
                           "atmvfi_tpu_torch/csrc/warp.cu",
                           "atmvfi_tpu/ops/warp_pallas.py:291"),
        "flow_warp": ("K2 backward warp, single form",
                      "atmvfi_tpu_torch/csrc/warp.cu",
                      "atmvfi_tpu/ops/warp_pallas.py:291"),
        "conv3x3": ("K3 conv3x3 + bias + PReLU",
                    "atmvfi_tpu_torch/csrc/conv3x3.cu",
                    "atmvfi_tpu/ops/conv_pallas.py:148"),
        "conv3x3_s2": ("K4 stride-2 conv3x3 + bias + PReLU",
                       "atmvfi_tpu_torch/csrc/conv3x3.cu",
                       "atmvfi_tpu/ops/conv_pallas.py:792"),
        "conv3x3_multi": ("K5 multi-source conv3x3 + bias + PReLU",
                          "atmvfi_tpu_torch/csrc/conv3x3.cu",
                          "atmvfi_tpu/ops/conv_pallas.py:363"),
        "deconv2x": ("K6 deconv2x + bias + PReLU",
                     "atmvfi_tpu_torch/csrc/deconv2x.cu",
                     "atmvfi_tpu/ops/deconv_pallas.py:102"),
        "window_attention": ("K7 window attention + motion, packed "
                             "(bf16: tensor-core attn_mma_kernel; f32: "
                             "scalar attn_kernel)",
                             "atmvfi_tpu_torch/csrc/atm_block.cu",
                             "atmvfi_tpu/ops/attention_pallas.py:233"),
        "window_attention_heads": ("K8 window attention + motion, "
                                   "head-major (K7's kernels)",
                                   "atmvfi_tpu_torch/csrc/atm_block.cu",
                                   "atmvfi_tpu/ops/attention_pallas.py:119"),
        "flow_warp_blend": ("K9 fused dual warp + occlusion blend",
                            "atmvfi_tpu_torch/csrc/warp.cu",
                            "atmvfi_tpu/ops/warp_pallas.py:437"),
        "k11": ("K11 warp routes (tiled v1 / v2 / nhwc, unchecked), "
                "served by K2", "atmvfi_tpu_torch/csrc/warp.cu",
                "atmvfi_tpu/ops/warp_pallas.py:42"),
        "conv3x3_pair": ("K12 fused conv3x3 pair (cp.async ring, "
                         "one 192-row stage A pass per Cmid block)",
                         "atmvfi_tpu_torch/csrc/conv_pair.cu",
                         "atmvfi_tpu/ops/conv_pallas.py:1371"),
        "warp_pair_srcfull": ("K10 slab-row warp pair (full sources, "
                              "row offset folded into the flow)",
                              "atmvfi_tpu_torch/csrc/warp.cu",
                              "atmvfi_tpu/ops/warp_pallas.py:1407"),
        "flow_warp_rows": ("row warp of feature maps (K10's single form)",
                           "atmvfi_tpu_torch/csrc/warp.cu",
                           "atmvfi_tpu/ops/warp.py:137"),
    }
    results = dict(results, k11=results["flow_warp_pair"]
                   + results["flow_warp"])
    out = []
    for k, (name, src, rep) in meta.items():
        recs = results[k]
        base = [r for r in recs if r.get("dtype") == "bf16"
                and not r.get("case", "").startswith("lite")]
        if k in ("atm_block", "window_attention"):
            # the main paths run base bf16, 2 calls per window shape
            used = [(r, 2) for r in base]
        elif k == "window_attention_heads":  # on no main path
            used = [(r, 1) for r in base]
        else:
            used = [(r, r["per_forward"]) for r in recs if r["per_forward"]]
        n = sum(w for _, w in used)
        avg = lambda key: sum(r[key] * w for r, w in used) / n  # noqa: E731
        lib = (avg("library_ms") if all("library_ms" in r for r, _ in used)
               else None)
        entry = dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[k],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=avg("ms"), plain_ms=avg("plain_ms"), bound_ms=avg("bound_ms"),
            bound_by=max(used, key=lambda rw: rw[0]["bound_ms"])[0]["bound_by"],
            library_ms=lib)
        if k in ("window_attention", "window_attention_heads"):
            entry["bf16_max_abs_err"] = max(r["max_abs_err"] for r in recs
                                            if r["dtype"] == "bf16")
        if k == "conv3x3_pair":
            entry["bf16_max_abs_err"] = max(r["bf16_max_abs_err"]
                                            for r in recs)
            entry["ms_over_two_k3"] = entry["ms"] / avg("two_k3_ms")
        if k in ("window_attention", "window_attention_heads",
                 "conv3x3_pair"):
            entry["ms_over_library"] = entry["ms"] / lib
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "atmvfi_tpu_torch")):
        print("chip_smoke.py: the atmvfi_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from atmvfi_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit(dict(phase="device", gpu=smi, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))
    t0 = time.perf_counter()
    _build.load_library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=_build.build_seconds,
              ptxas=[ln.strip() for ln in _build.ptxas_log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln][:80]))
    if sys.argv[1:] == ["--route-kernels"]:
        phase_route_kernels(torch)
        emit(dict(route_kernels="done", gpu=nvidia_smi_line()))
        return 0
    if sys.argv[1:] == ["--conv-sites"]:
        sites = {r["site"] + f" ({k})": r["ms"]
                 for k, recs in phase_conv_kernels(torch).items()
                 for r in recs}
        emit(dict(conv_site_ms=sites, sum_ms=sum(sites.values()),
                  gpu=nvidia_smi_line()))
        return 0
    results = phase_kernels(torch)
    results.update(phase_conv_kernels(torch))
    results.update(phase_route_kernels(torch))
    launches = phase_main_path(torch, "default", {}, False, PER_FORWARD, 3)
    routes = phase_main_path(torch, "routes", ROUTES, False,
                             ROUTES_PER_FORWARD, 2)
    fast = phase_main_path(torch, "fast", {}, True, FAST_PER_FORWARD, 2)
    for k in ROUTES_PER_FORWARD:  # the kernels the default path does not run
        if k not in PER_FORWARD:
            launches[k] = routes[k]
    launches["k11"] = fast["flow_warp_pair"] + fast["flow_warp"]
    phase_agreement(torch)
    results.update(phase_row_warps(torch))
    spatial = [phase_spatial_main_path(torch, n) for n in (2, 4)]
    for k in ("warp_pair_srcfull", "flow_warp_rows"):  # this path's own
        launches[k] = sum(run[k] for run in spatial)
    phase_spatial_agreement(torch)
    emit(kernel_line(results, launches))
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
