#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`atmvfi_tpu_torch`) on one GPU.

    python3 chip_smoke.py

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
  4. main path: InterpolationPipeline.interpolate (base, bf16 towers,
     global motion on, seeded weights) on three 1080x1920 frame pairs;
     checks the output and the kernel launch counts, reports ms/frame.
  5. agreement: seeded f32 models on the card (kernels) against the
     port on the CPU (plain versions) at 256x448: base with global
     motion, lite with and without it.
Then the {"kernels": [...]} line, the card's name and power limit, and
the last line {"ok": true, "device": {...}}. Any failed phase raises
and the script exits non-zero; without a CUDA device, or without the
repo beside it, it exits non-zero before printing any result.
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

    def edge_flow(B, H, W, mag):
        f = (torch.rand(B, H, W, 2, generator=g, device="cuda") * 2 - 1) * mag
        f[:, :, :8, 0] -= mag      # taps off the left edge
        f[:, :, -8:, 0] += mag     # right
        f[:, :8, :, 1] -= mag      # top
        f[:, -8:, :, 1] += mag     # bottom
        return f.contiguous()

    def grid_of(flow):
        B, H, W, _ = flow.shape
        ys, xs = torch.meshgrid(torch.arange(H, device="cuda"),
                                torch.arange(W, device="cuda"), indexing="ij")
        gx = (xs + flow[..., 0]) * (2.0 / (W - 1)) - 1
        gy = (ys + flow[..., 1]) * (2.0 / (H - 1)) - 1
        return torch.stack([gx, gy], -1)

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
            flows = [edge_flow(B, H, W, 40.0 * H / 1088 if C == 3 else 8.0)
                     for _ in range(n_img)]
            if kind == "flow_warp_pair":
                run = lambda: warp_cuda.flow_warp_pair(*imgs, *flows)  # noqa
            else:
                run = lambda: (warp_cuda.flow_warp(imgs[0], flows[0]),)  # noqa
            plain = lambda: [warp_plain(i, f) for i, f in zip(imgs, flows)]  # noqa
            grids = [grid_of(f) for f in flows]
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


def phase_main_path(torch):
    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.ops import (attention_cuda, conv_cuda,
                                      deconv_cuda, warp_cuda)

    counters = {"atm_block": attention_cuda.atm_block,
                "flow_warp_pair": warp_cuda.flow_warp_pair,
                "flow_warp": warp_cuda.flow_warp,
                "conv3x3": conv_cuda.conv3x3,
                "conv3x3_s2": conv_cuda.conv3x3_s2,
                "conv3x3_multi": conv_cuda.conv3x3_multi,
                "deconv2x": deconv_cuda.deconv2x}
    pipe = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, device="cuda")
    frames = smooth_frames(torch, 4, 1080, 1920, seed=3)
    pipe.interpolate(*frames[0])  # warm-up: cuDNN plans, masks
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [pipe.interpolate(f0, f1) for f0, f1 in frames[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n = len(outs)
    for o in outs:
        if o.shape != (1080, 1920, 3) or o.dtype.name != "uint8":
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
    for k, per in PER_FORWARD.items():
        if launches[k] != per * n:
            raise AssertionError(f"{k}: {launches[k]} launches in {n} "
                                 f"forwards, expected {per} each")
    # the middle frame of a shifted pair lies near both inputs
    f0, f1 = frames[1]
    err = float(abs(outs[0].astype("float32") - f0.astype("float32")).mean())
    emit(dict(phase="main_path", model="base", dtype="bf16", frames=n,
              size=[1080, 1920], padded=[1088, 1920],
              ms_per_frame=dt * 1e3 / n, launches=launches,
              mean_abs_diff_to_frame0_u8=err, gpu=nvidia_smi_line()))
    return launches


def phase_agreement(torch):
    """Seeded f32 models on the card (kernels) against the port on the
    CPU (plain versions): base with global motion, lite with and
    without it."""
    from atmvfi_tpu_torch.models import Network, get_config

    H, W = 256, 448
    f0, f1 = smooth_frames(torch, 1, H, W, seed=5)[0]
    ims = [torch.from_numpy(f).float()[None] / 255.0 for f in (f0, f1)]
    for model, global_motion in (("base", True), ("lite", True),
                                 ("lite", False)):
        net = Network(get_config(model)).eval()  # seed 0, f32
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


def kernel_line(results, launches):
    """One entry per kernel wrapper; times are per launch, averaged over
    the cases of one forward weighted by their launches per forward."""
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
    }
    out = []
    for k, recs in results.items():
        if k == "atm_block":  # the main path runs bf16, 2 calls per case
            used = [(r, 2) for r in recs if r["dtype"] == "bf16"]
        else:
            used = [(r, r["per_forward"]) for r in recs if r["per_forward"]]
        n = sum(w for _, w in used)
        avg = lambda key: sum(r[key] * w for r, w in used) / n  # noqa: E731
        lib = (avg("library_ms") if all("library_ms" in r for r, _ in used)
               else None)
        name, src, rep = meta[k]
        out.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[k],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=avg("ms"), plain_ms=avg("plain_ms"), bound_ms=avg("bound_ms"),
            bound_by=max(used, key=lambda rw: rw[0]["bound_ms"])[0]["bound_by"],
            library_ms=lib))
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
    results = phase_kernels(torch)
    results.update(phase_conv_kernels(torch))
    launches = phase_main_path(torch)
    phase_agreement(torch)
    emit(kernel_line(results, launches))
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
