#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`atmvfi_tpu_torch`) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k1-launches   # the build and phase 3's K1
    python3 chip_smoke.py --conv-sites   # the build and phase 3's convs
    python3 chip_smoke.py --route-kernels   # the build and phase 4 alone
    python3 chip_smoke.py --gradients   # the build and phase 10 alone
    python3 chip_smoke.py --stream   # the build and phase 5b alone
    python3 chip_smoke.py --windows   # the build and phase 11 alone
    python3 chip_smoke.py --eval   # the build and phase 12 alone
    python3 chip_smoke.py --windows --eval   # both, one build
    python3 chip_smoke.py --windows-split   # the build and K7's split
    python3 chip_smoke.py --train   # the build and phase 13 alone
    python3 chip_smoke.py --roofline   # the build, K2's spread gather,
                                       # phase 5's default run and phase 14

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
     F.prelu that they replace), at every distinct conv site, the
     sources made in the layout the main path hands over. A bf16 site
     runs the wgmma + TMA kernel where it takes the sources (K3 / K4 from
     32 channels; K5 and K6 where every source takes a TMA map: every
     main-path site) and is also timed on the mma.sync implicit GEMM
     (K3: `conv3x3_multi` with one source, the same `launch_igemm`; K4-K6
     their implicit-GEMM launch; K4 both kernels whichever runs, the
     wgmma form also checked; K5's two bodies at the encoder's site and
     K6's two column tiles, each checked; yardsticks, outside the
     per-forward launch checks). One K5 and one K6 site in the odd layout
     (a dense 101- / 389-channel map) must run the implicit GEMM, right.
     Five repeated launches at each site are bit-equal. K1 at the base
     local, global and enhancement and the lite local and global shapes;
     in bf16 its three launches are also timed apart, each beside its
     bound and a library yardstick. Row P's warp-v2 loop probes: K2's
     exact gather of p6's pattern (an 8 x 128 tile whose pixels read
     rows 9 + i + (l % 3), a spread of 3, of a 64 x 128 map; integer
     flows), single and pair, f32 and bf16, max |d| 0 against numpy.
     Every bound of phases 3, 4 and 7 is the counted roofline's count of
     the call (`utils/roofline.py`: the wrapper's plain version on fake
     copies of the card tensors), but K10's and the row warp's, whose
     bytes depend on the rows the flows reach: there the hand count.
  4. route kernels: K7 / K8 (window attention + motion, packed and
     head-major; the launch K1 runs too) at the three base window shapes
     and at the lite local and global ones (head dims 28 and 44), f32
     and bf16, K9 (fused warp + blend) at the five blend sites (also
     bit-equal to the K2 pair + eager blend, five repeats bit-equal) and K12
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
     every wrapper (set to 0 just before it; the K3-K6 launches on the
     wgmma kernels among them) and reports ms/frame.
 5b. stream: InterpolationPipeline.interpolate_stream_batched (base,
     bf16, default routes, global motion on) over 9 smooth 1080x1920
     frames, factor 2, at batch 1, 2 and 4: ms per output frame (host
     clock, after an untimed run at the same batch), peak device memory,
     the launches of every wrapper (set to 0 just before the timed run:
     PER_FORWARD per forward call at every batch), I_t against batch 1
     (mean |d| <= 1e-3 per frame); f32 at 256x448, 6 frames, batch 2
     and 3 (padded tails): max |d| <= 1e-4 against batch 1 on the card
     and <= 1e-3 against the CPU port's batched stream;
     set_window_sizes(6, 8) card vs CPU (f32, <= 1e-3), back to (8, 12)
     bit-equal uint8; the CLI's --video on a 5-frame C420 .y4m (lite,
     256x448, --batch 2): 9 frames at twice the frame rate.
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
 10. gradients: every kernel wrapper at a small shape on the card with
     grad enabled (f32, TF32 off; the wgmma routes of K3-K6 and K1's
     GEMMs in bf16): its output has a grad_fn and its input and
     parameter gradients match autograd
     through the plain version (max |d| <= 1e-5 x the gradient's max
     |g|; bf16 1e-2, one bf16 step); then the narrow lite network at
     64x96 f32, loss = weighted mean of I_t: every parameter gets a
     gradient within 1e-3 x that tensor's max |g| of the CPU port's.
 11. windows above 12: K7 at every ATTN_SITES site, K8 at the local
     one and K1 at all five, at windows 13, 16, 24 and 32 (N = 169-1024:
     the key-tiled attention forms), f32 and bf16, against their plain
     versions (f32 max |d| <= 1e-4, bf16 mean <= 5e-3), with CUDA-event
     times, bounds, the plain version's and SDPA's times (base sites);
     the single-pass form at the main path's windows (local and
     enhancement 8, global 12) timed beside them; each launch must take
     the form its N calls for (the wrappers' tiled counts: 0 at windows
     8 and 12, 1 above), the compact one on every model mask (the
     wrappers' general counts: 0); the general form (GENERAL_CASES: a
     random mask with -inf entries and a random rel, head dims 28-128,
     K1 with swap, K7, K8) and the compact form at head dim 128, f32
     and bf16, in the same bands; the pipeline at set_window_sizes(16, 24): base
     f32 256x448 card against the CPU port (I_t <= 1e-3); base bf16
     1080p at (8, 12) and (16, 24) in turns, two rounds of 6 timed
     frames each (ms/frame, mean and median; every wrapper's count set
     to 0 just before a window's frames and read just after: 6 K1 per
     frame, 4 of them on the tiled form at (16, 24), none at (8, 12)),
     bit-equal uint8 at (8, 12) after each stay at (16, 24). Every
     main-path run of the other phases also requires 0 tiled launches.
 12. eval: the benchmark protocols of `evalkit.harness` with seeded base
     weights, every wrapper's count set to 0 just before each run and
     read just after (K1, K2, K3 and K6 must launch): Vimeo over
     tests/fixtures/mini_vimeo (10 triplets, global motion off), f32 on
     the card against f32 on the CPU port (mean PSNR <= 0.01 dB, SSIM
     <= 1e-4), and bf16 (PSNR, SSIM, steady fps), and the host's PNG
     decode time of the fixture's frames; Xiph on a synthetic 11-frame
     2160x4096 C420 clip staged to PNG by `utils.video.prepare_xiph`
     (both categories, 5 items each, bf16, global motion, 1088x2048
     forwards, ms per forward over the 4 after the first, peak memory;
     TTA on 3 items); SNU-FILM's four splits on three 720x1280 triplets
     (pad 64);
     DAVIS 4x on 3 frames of 480x854; the checkpoint CLIs' round trip
     .npz -> .pt -> .npz (the forward bit-equal before and after) and
     the benchmark CLI over the fixture on the .pt.
 13. train: a Vimeo tree over the fixture's 10 triplets (its train list
     30 times over) in a temporary directory. `python -m
     atmvfi_tpu_torch.cli.train`'s main (base, phase 1, batch 24, 256x256
     crops, f32, 3 steps, validation, the epoch's .npz: finite, its peak
     memory printed, also when batch 24 does not fit). `Trainer` on base
     phases 1 (batch 24) and 3 (batch 16) in bf16 and f32 and phase 4
     (the VGG terms on seeded random weights) in bf16, each frame decoded
     once, and phase 3 bf16 decoding every frame in the loader's 8
     threads beside the steps: 2 warm-up steps, then 5 (phase 4: 3; with
     the decode: 6) timed ones, the host clock around each step
     ended by torch.cuda.synchronize(), the loader's wait apart, the
     CUDA-event span and the main thread's CPU time of each step, peak
     memory, every step's losses (finite); the first warm-up step of
     each run holds every kernel call against its plain version on the
     same card tensors (TRAIN_KERNEL_BANDS); one more phase 3 bf16 step
     of each of its two runs under torch.profiler (device busy time by
     kernel family); every wrapper's count set to 0 just before each
     timed step and read just after: K1-K6 and both K2 forms launch
     through the autograd path (phases 3 and 4: exactly PER_FORWARD). Agreement, f32, TF32 off: narrow lite 64x96, batch 2,
     phase 3 with every criterion switch on, loss terms on the card
     against the CPU port (<= 1e-4 relative) and every parameter
     gradient (<= 1e-3 x its max |g|); every kernel wrapper's bf16
     gradients against its plain version's (<= 1e-2). Weight packs: the
     bf16 K3 (wgmma) and K1 forwards of a lite layer after a step
     (foreach and fused AdamW; two 'data' shards on the card, each
     replica's layers) equal their plain versions on the new weights,
     and after `restore_train_state` the pre-step outputs, bit for bit.
     Data parallelism (`Trainer(mesh=...)`, base phase 3): (a)
     `make_mesh((2, 1), ["cuda:0", "cuda:0"])`, batch 16, bf16 and f32:
     a step against one device from the same weights on the same batch,
     taken whole and as two micro-steps of the shards' rows (grad_accum
     2), on 3 batches (metrics and each parameter's first moment,
     DP_BANDS; every kernel call of the first mesh step against its plain
     version; launches twice the one-device step's), then 2 warm-up and
     5 timed steps (launches exactly twice the one-device phase 3 run's
     per step), every replica bit-equal to the home one, step time and
     peak memory beside the one-device run's, no synchronising CUDA call
     from the code the shard loop runs (torch's sync debug mode, one
     more step); (b) `["cuda:0", "cpu"]`,
     f32, batch 2, 128x128, against the one-device card trainer (card
     vs CPU bands; the card shard launches one forward's kernels, the
     CPU replica copies the card's weights); (c) (a) on `["cuda:0",
     "cuda:1"]` where two cards are visible, else a line that says it
     did not run.
 14. roofline (run after phase 7, before phase 8): (a) row P's gridded matmul ([128, 64] @ [64, 64] f32,
     `csrc/grid_matmul.cu`) through `grid_probe`, every count set to
     0 just before and read just after (one launch), against the f64
     product (max |d| <= 1e-5 of the scale, reported apart as
     `f64_rel_err`) and its plain version (`max_abs_err`); its
     count on card tensors exactly 2 * 2 * 64**3 tc FLOPs; its time,
     the plain version's and torch.matmul's (CUDA events), its bound.
     (b) each timed case of phases 3, 4 and 7: the tool's bytes and
     FLOPs beside the hand counts, per kernel, the cases more than 10 %
     apart listed. (c) `model_roofline` of base and lite, bf16, at
     1088x1920 and 2176x3840 (on the host, fake tensors), base 1080p
     beside phase 5's ms/frame as a share of SOL. (d)
     `profiling.capture` / `summarize` over 3 base 1080p frames: device
     busy ms per frame by family and stage, idle share. (e)
     `parallel.make_deep_shard_sim` at n = 2 and 4, 1080p: ms per shard
     program (median of 7, CUDA events), bytes between devices, the
     projected fps at NVLink 4's 450 GB/s one way.
Then the {"kernels": [...]} line (the key-tiled attention as
"attention_tiled", its launches from phase 11's 1080p run), the card's
name and power limit, and the last line {"ok": true, "device": {...}}.
With --conv-sites it runs only the build and the K3-K6 sites and prints
their times as one JSON line (to compare two checkouts in one call);
with --k1-launches only the build and the K1 cases of phase 3; with
--route-kernels only the build and phase 4; with --gradients only the
build and phase 10; with --stream only the build and phase 5b; with
--windows and / or --eval only the build and phases 11 / 12; with
--windows-split only the build and K7's local split (`windows_split`:
a copy of this script beside an older checkout times the same calls
there); with --train only the build and phase 13; with --roofline the build, K2's
spread gather, phase 5's default run and phase 14.
Any failed phase raises and the script exits non-zero; without a CUDA
device, or without the repo beside it, it exits non-zero before
printing any result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# K3 launches on the wgmma kernel: all but the encoder's 24->24 site
# (fewer than 32 input channels), which stays on igemm
WGMMA_PER_FORWARD = {"default": 21, "routes": 13, "fast": 21}
# the wrappers with a wgmma route; every K5 and K6 launch of the main
# paths takes it (the main path hands them TMA-legal maps)
WGMMA_WRAPPERS = ("conv3x3", "conv3x3_s2", "conv3x3_multi", "deconv2x")


def reset_wgmma(counters) -> None:
    for k in WGMMA_WRAPPERS:
        counters[k].wgmma_launches = 0


def read_wgmma(counters, launches: dict) -> None:
    for k in WGMMA_WRAPPERS:
        launches[k + "_wgmma"] = counters[k].wgmma_launches

# every conv-kernel site of the base main path at 1088x1920 (global
# motion on; frames stacked, so the encoder runs on batch 2):
# (wrapper, site, sources as (B, H, W, C, f32?[, dense]), Cout, PReLU,
# launches per forward). Deconv sources are the half-resolution inputs.
# A source whose channel count is not a multiple of 8 is made as the
# main path hands it over: a kernel's, PReLU's or the decoder input's
# map at a pixel stride rounded up to 8. A source marked dense is made
# at pixel stride C (the layout the deconvs read before the main path
# padded it; 0 launches a forward): the implicit GEMM must still take it.
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
    ("conv3x3_multi", "refine proj, feature dense at 101 (odd layout)",
     [(1, *_F, 101, 0, 1)] + [(1, *_F, 3, 1)] * 5, 64, 1, 0),
    ("deconv2x", "decoder 773->389", [(1, 136, 240, 773, 0)], 389, 1, 1),
    ("deconv2x", "decoder 389->197", [(1, 272, 480, 389, 0)], 197, 1, 1),
    ("deconv2x", "decoder 389->197, dense 389 (odd layout)",
     [(1, 272, 480, 389, 0, 1)], 197, 1, 0),
    ("deconv2x", "decoder 197->101", [(1, *_X, 197, 0)], 101, 1, 1),
    ("deconv2x", "refine up1 256->128", [(1, 136, 240, 256, 0)], 128, 1, 1),
    ("deconv2x", "refine up2 256->128", [(1, 272, 480, 256, 0)], 128, 1, 1),
    ("deconv2x", "refine up3 128->64", [(1, *_X, 128, 0)], 64, 1, 1),
    # the lite model's K5 and K6 sites (checks: 0 launches a forward of
    # the base main path)
    ("conv3x3_multi", "lite encoder first conv, f32 frames 3->16",
     [(2, *_F, 3, 1)], 16, 1, 0),
    ("conv3x3_multi", "lite refine proj 61 + 5 f32 images -> 32",
     [(1, *_F, 61, 0)] + [(1, *_F, 3, 1)] * 5, 32, 1, 0),
    ("deconv2x", "lite decoder 453->229", [(1, 136, 240, 453, 0)], 229, 1,
     0),
    ("deconv2x", "lite decoder 229->117", [(1, 272, 480, 229, 0)], 117, 1,
     0),
    ("deconv2x", "lite decoder 117->61", [(1, *_X, 117, 0)], 61, 1, 0),
    ("deconv2x", "lite refine up1 128->64", [(1, 136, 240, 128, 0)], 64, 1,
     0),
    ("deconv2x", "lite refine up2 128->64", [(1, 272, 480, 128, 0)], 64, 1,
     0),
    ("deconv2x", "lite refine up3 64->32", [(1, *_X, 64, 0)], 32, 1, 0),
]


def k4_igemm_per_forward() -> int:
    """K4 launches a forward below the wgmma kernel's channel floor (the
    encoder's 24 -> 48 conv unless its route changes), which run igemm."""
    from atmvfi_tpu_torch.ops.conv_cuda import WGMMA_MIN_CHANNELS

    return sum(n for kind, _, shapes, _, _, n in CONV_SITES
               if kind == "conv3x3_s2"
               and sum(x[3] for x in shapes) < WGMMA_MIN_CHANNELS)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of fn() over reps launches, timed with CUDA events, with
    autograd off as serving runs the kernels."""
    import torch

    with torch.no_grad():
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


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device ms of fn(): `reps` calls captured in one CUDA graph,
    replayed `replays` times between CUDA events, so that the host's
    time per call (the Python wrapper) is not in the reading."""
    import torch

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / (reps * replays)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else
                                     "operations")


# (b) of the roofline phase: each timed kernel case's count by the
# counted roofline (utils/roofline.py) beside its hand count
COUNT_ROWS = []
# kernels whose bytes depend on the flows' data (the source rows they
# reach): the hand count reads the data, the tool charges the whole
# source, so the hand count stays their byte count
HAND_BYTES = ("K10 warp_pair_srcfull", "flow_warp_rows")
# kernels whose plain version emulates a per-pixel gather: the tool
# would charge its index arithmetic (floor, clamps, compares, an integer
# index a tap) as the function's work, so the hand count of the taps'
# multiply-adds and weights stays their FLOP count
HAND_FLOPS = ("K2 flow_warp", "K2 flow_warp_pair", "K9 flow_warp_blend",
              "K10 warp_pair_srcfull", "flow_warp_rows")


def counted_bound(kernel: str, case: str, run, hand_bytes: float,
                  hand_flops: float, hand_dtype: str, read_as=()):
    """(bound_ms, bound_by, bytes, flops) of one kernel call run(): the
    counted roofline's count of it (the wrapper's plain version on fake
    copies of the card tensors: no launch), the one count of the bound
    (bf16 tc work at the tensor cores' rate, f32 tc and simt work at the
    CUDA cores' f32 rate, units overlapping), except for the bytes of
    HAND_BYTES kernels and the FLOPs of HAND_FLOPS kernels, which are the
    hand count's. `read_as` holds (tensor, element size) pairs of the
    operands that the kernel reads at another width than the wrapper is
    given (K1's weights, read from their cached packs in the working
    type): the tool's bytes count them at that width. The hand count is
    kept beside the tool's in COUNT_ROWS."""
    from atmvfi_tpu_torch.utils import roofline

    c = roofline.count_flops(run)
    nbytes = c["bytes_min"] - sum(t.numel() * (t.element_size() - size)
                                  for t, size in read_as)
    flops = c["total_flops"]
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = max(c["tc_bf16_flops"] / PEAK_FLOPS["bf16"],
                (c["tc_f32_flops"] + c["simt_flops"]) / PEAK_FLOPS["f32"])
    tool_ms = max(t_mem, t_ops) * 1e3
    hand_ms, _ = bound_ms(hand_bytes, hand_flops, hand_dtype)
    used = {"bytes": "hand" if kernel in HAND_BYTES else "tool",
            "flops": "hand" if kernel in HAND_FLOPS else "tool"}
    COUNT_ROWS.append(dict(
        kernel=kernel, case=case, tool_bytes=nbytes,
        tool_operand_bytes=c["bytes_min"], hand_bytes=hand_bytes,
        bytes_ratio=nbytes / hand_bytes, tool_flops=flops,
        tool_tc_bf16_flops=c["tc_bf16_flops"],
        tool_tc_f32_flops=c["tc_f32_flops"], tool_simt_flops=c["simt_flops"],
        hand_flops=hand_flops, hand_dtype=hand_dtype,
        flops_ratio=flops / hand_flops if hand_flops else None,
        tool_bound_ms=tool_ms, hand_bound_ms=hand_ms,
        bound_ratio=tool_ms / hand_ms, used=used))
    if used["bytes"] == "hand":
        nbytes, t_mem = hand_bytes, hand_bytes / HBM_BYTES_PER_S
    if used["flops"] == "hand":
        flops, t_ops = hand_flops, hand_flops / PEAK_FLOPS[hand_dtype]
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations", nbytes, flops)


def edge_flow(torch, g, B: int, H: int, W: int, mag: float):
    """Random flows of magnitude `mag`, pushed outward near the border
    so taps fall off every edge."""
    f = (torch.rand(B, H, W, 2, generator=g, device="cuda") * 2 - 1) * mag
    f[:, :, :8, 0] -= mag      # taps off the left edge
    f[:, :, -8:, 0] += mag     # right
    f[:, :8, :, 1] -= mag      # top
    f[:, -8:, :, 1] += mag     # bottom
    return f.contiguous()


def smooth_flow(torch, g, B: int, H: int, W: int, mag: float):
    """Smooth random flows of magnitude up to `mag` (a coarse random
    field, bicubic-upsampled), as a motion field is: neighbouring pixels
    sample neighbouring taps."""
    import torch.nn.functional as F

    coarse = torch.rand(B, 2, H // 32 + 2, W // 32 + 2, generator=g,
                        device="cuda") * 2 - 1
    f = F.interpolate(coarse, size=(H, W), mode="bicubic",
                      align_corners=False) * mag
    return f.permute(0, 2, 3, 1).contiguous()


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
    which = which.split()[-1]  # "lite local" is the lite net's local block
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


def k1_launches(torch, args) -> dict:
    """K1's three launches timed apart on one call's operands and scratch
    (bf16), each beside its bound (its own inputs and outputs, the
    scratch xn, qkv and app included) and a library yardstick that the
    port never calls: launch 1 F.layer_norm then F.linear(xn, [Wq |
    Wkv]); launch 2 scaled_dot_product_attention (out only, no motion,
    no frame swap); launch 3 F.linear(app, Wproj, bproj) + xn."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch.ops import attention_cuda

    x, wq, wkv, wp, bp, ln_g, ln_b, scale, rel, mask, h, swap = args
    BW, N, C = x.shape
    M, hd, dt, s = BW * N, C // h, x.dtype, x.element_size()
    run, buf = attention_cuda.block_launches(*args)
    with torch.no_grad():
        run(0)
        wqkv = torch.cat([wq, wkv], 0).to(dt)
        g_, b_ = ln_g.to(dt), ln_b.to(dt)
        wp_, bp_ = wp.to(dt), bp.to(dt)
        qkv, app, xn = buf["qkv"], buf["app"], buf["xn"]
        heads_of = lambda t: t.reshape(BW, N, h, hd).transpose(1, 2)  # noqa
        qh, kh, vh = (heads_of(qkv[..., i * C:(i + 1) * C]).contiguous()
                      for i in range(3))
        full = (None if mask is None else
                mask.repeat(BW // mask.shape[0], 1, 1)[:, None].to(dt))
        libs = [
            lambda: F.linear(F.layer_norm(x, (C,), g_, b_, 1e-5), wqkv),
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   attn_mask=full,
                                                   scale=scale),
            lambda: F.linear(app, wp_, bp_) + xn]
        lib_err = [(libs[0]().float() - qkv.float()).abs().mean().item(),
                   None,
                   (libs[2]().float() - buf["y"].float()).abs().mean()
                   .item()]
        ms = [cuda_ms(lambda i=i: run(i), 20) for i in (1, 2, 3)]
        lib_ms = [cuda_ms(f, 20) for f in libs]
    mask_b = mask.numel() * 4 if mask is not None else 0
    motion_b = 2 * N * N * 4 + M * 2 * h * s if rel is not None else 0
    work = [  # (bytes, flops) of each launch
        (M * C * s + 3 * C * C * s + 2 * C * 4 + M * C * s + 3 * M * C * s,
         2 * M * C * 3 * C),
        (3 * M * C * s + M * C * s + mask_b + motion_b,
         4 * BW * h * N * N * hd + (4 * BW * h * N * N if rel is not None
                                    else 0)),
        (2 * M * C * s + C * C * s + C * s + M * C * s, 2 * M * C * C)]
    names = ("LayerNorm + q/kv GEMM", "attention + motion",
             "projection GEMM + bias + residual")
    library = ("F.layer_norm + F.linear",
               "scaled_dot_product_attention, out only",
               "F.linear + add")
    out = []
    for i in range(3):
        b_ms, b_by = bound_ms(*work[i], "bf16")
        rec = dict(launch=i + 1, name=names[i], ms=ms[i], bound_ms=b_ms,
                   bound_by=b_by, ms_over_bound=ms[i] / b_ms,
                   library=library[i], library_ms=lib_ms[i],
                   ms_over_library=ms[i] / lib_ms[i], bytes=work[i][0],
                   flops=work[i][1])
        if lib_err[i] is not None:
            rec["library_mean_abs_diff"] = lib_err[i]
        out.append(rec)
    del qh, kh, vh, full, buf
    return dict(launches=out, library_ms=sum(lib_ms),
                library="F.layer_norm + F.linear, scaled_dot_product_"
                        "attention (out only), F.linear + add")


def phase_kernels(torch, k1_only: bool = False):
    """Every kernel against its plain version at the main-path shapes
    (with k1_only K1 alone)."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch.models import Network, get_config
    from atmvfi_tpu_torch.ops import attention_cuda, warp_cuda
    from atmvfi_tpu_torch.ops.attention import atm_block_reference
    from atmvfi_tpu_torch.ops.warp import flow_warp as warp_plain

    results = {"atm_block": [], "flow_warp_pair": [], "flow_warp": []}
    tol = {torch.float32: ("max", 1e-4), torch.bfloat16: ("mean", 5e-3)}
    for model in ("base", "lite"):
        # frozen, as served: K1 keeps its weight packs across the timed
        # calls (a weight that requires grad is packed at every call)
        net = Network(get_config(model)).cuda().requires_grad_(False)
        cases = (("local", "global", "enhance") if model == "base"
                 else ("lite local", "lite global"))
        for which in cases:
            for dtype in (torch.float32, torch.bfloat16):
                args, info, nbytes, flops = block_case(torch, net, which,
                                                       dtype)
                with torch.no_grad():
                    y, m = attention_cuda.atm_block(*args)
                    yr, mr = atm_block_reference(*args)
                    torch.cuda.synchronize()
                    dy = (y.float() - yr.float()).abs()
                    dm = ((m.float() - mr.float()).abs() if m is not None
                          else torch.zeros(1, device="cuda"))
                    stat, lim = tol[dtype]
                    err = (max(dy.max().item(), dm.max().item())
                           if stat == "max"
                           else max(dy.mean().item(), dm.mean().item()))
                    repeat_equal = all(
                        torch.equal(y, attention_cuda.atm_block(*args)[0])
                        for _ in range(5))
                    ms = cuda_ms(lambda: attention_cuda.atm_block(*args), 10)
                    plain = cuda_ms(lambda: atm_block_reference(*args), 10)
                dt = "f32" if dtype == torch.float32 else "bf16"
                # the kernel reads [wq | wkv], wproj and bproj from their
                # packs in the working type
                b_ms, b_by, nbytes, flops = counted_bound(
                    "K1 atm_block", f"{which} {dt}",
                    lambda: attention_cuda.atm_block(*args), nbytes, flops,
                    dt, [(w, args[0].element_size()) for w in args[1:5]])
                rec = dict(phase="kernel", kernel="K1 atm_block", case=which,
                           dtype=dt, **info, max_abs_err=dy.max().item(),
                           mean_abs_err=dy.mean().item(),
                           motion_max_abs_err=dm.max().item(),
                           motion_mean_abs_err=dm.mean().item(),
                           repeat_equal=repeat_equal, ms=ms,
                           plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                           flops=flops, bytes=nbytes)
                if dtype == torch.bfloat16:
                    rec.update(k1_launches(torch, args))
                emit(rec)
                if not err <= lim:
                    raise AssertionError(f"K1 {which} {dt}: {stat} |d| {err} "
                                         f"> {lim}")
                if not repeat_equal:
                    raise AssertionError(f"K1 {which} {dt}: a repeated call "
                                         "differs")
                results["atm_block"].append(rec)
                del y, yr, m, mr, dy, dm, args
        del net
        torch.cuda.empty_cache()
    if k1_only:
        return results

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
            b_ms, b_by, nbytes, flops = counted_bound(
                f"K2 {kind}", f"{list(shape)} {dt}", run, nbytes, flops,
                "f32")
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
    phase_spread_gather(torch)
    return results


def phase_spread_gather(torch):
    """Row P's warp-v2 loop probes on K2: p6's gather (an 8 x 128 tile
    whose pixels read rows 9 + i + (l % 3), a spread of 3, and columns
    (7 l + i) % 128 of a 64 x 128 f32 map) as an integer flow, single and
    pair forms, f32 and bf16: max |d| 0 against numpy's x[row, col]."""
    from atmvfi_tpu_torch.ops import probe_cuda, warp_cuda

    x, flow, want = probe_cuda.spread_gather_case()
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).cuda().to(dtype)
        ft = torch.from_numpy(flow).cuda()
        wt = torch.from_numpy(want).cuda()
        with torch.no_grad():
            outs = {"single": [warp_cuda.flow_warp(xt, ft)],
                    "pair": list(warp_cuda.flow_warp_pair(xt, xt, ft, ft))}
        torch.cuda.synchronize()
        for form, os_ in outs.items():
            err = max((o.float() - wt).abs().max().item() for o in os_)
            emit(dict(phase="kernel", kernel="K2 spread gather (row P)",
                      form=form, dtype=str(dtype).split(".")[-1],
                      shape=list(x.shape), row_spread=3, max_abs_err=err,
                      exact=err == 0))
            if err != 0 or any(o.dtype != dtype for o in os_):
                raise AssertionError(f"K2 spread gather {form} {dtype}: "
                                     f"max |d| {err} (must be 0)")


def phase_conv_kernels(torch):
    """K3-K6 against their plain versions at every conv site of the main
    path: f32 max |d| <= 1e-4, bf16 mean |d| <= 1e-3; bf16 times of the
    kernel, the plain version and the library calls it replaces. A bf16
    site runs the wgmma kernel where the main path's layout lets it (K3 /
    K4 from 32 channels; K5 / K6 where every source takes a TMA map) and
    is also timed on the implicit GEMM; a site in the odd layout runs the
    implicit GEMM."""
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

        odd = any(len(s) > 5 and s[5] for s in shapes)

        def layout(x, dt, s):  # as the main path hands the source over
            if (len(s) > 5 and s[5]) or x.shape[3] % 8 == 0:
                return x.to(dt)
            return empty_nhwc(*x.shape, dt, "cuda").copy_(x)

        wgmma0 = getattr(kernels[kind], "wgmma_launches", 0)
        repeat_equal = None
        for dt in (torch.float32, bf16):
            srcs = [x if s[4] else layout(x, dt, s)
                    for x, s in zip(base, shapes)]
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
            if dt == bf16:  # no atomics: a second launch is bit-equal
                with torch.no_grad():
                    repeat_equal = all(torch.equal(y, run())
                                       for _ in range(5))
                if not repeat_equal:
                    raise AssertionError(f"{kind} {site}: a repeated "
                                         "launch differs")
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

        route = ("wgmma" if getattr(kernels[kind], "wgmma_launches", 0)
                 > wgmma0 else "igemm")
        big = B * H * W >= 500_000
        reps = 5 if big else 20
        extra = {}
        with torch.no_grad():
            ms, plain_ms, lib_ms = (cuda_ms(run, reps), cuda_ms(ref, reps),
                                    cuda_ms(library, reps))
            if kind == "conv3x3":  # K3 as PR 5 ran it: launch_igemm
                extra = dict(route=route, igemm_ms=cuda_ms(
                    lambda: conv_cuda.conv3x3_multi(srcs, w, b, a), reps))
            if kind == "conv3x3_s2":  # K4 on both kernels, whichever runs
                igemm = lambda: conv_cuda._launch(  # noqa: E731
                    "conv3x3s2", srcs, w, b, a, 2, bf16)
                wg = lambda: conv_cuda._launch_wgmma(  # noqa: E731
                    srcs[0], w, b, a, 2)
                yw = wg()
                yr = plain.conv3x3(srcs, w, b, a, 2)
                wg_err = (yw.float() - yr.float()).abs().mean().item()
                extra = dict(route=route, igemm_ms=cuda_ms(igemm, reps),
                             wgmma_ms=cuda_ms(wg, reps),
                             wgmma_bf16_mean_abs_err=wg_err)
                del yw, yr
                if not wg_err <= 1e-3:
                    raise AssertionError(f"K4 {site} on wgmma: bf16 mean "
                                         f"|d| {wg_err} > 1e-3")
            if kind in ("conv3x3_multi", "deconv2x"):
                # K5 / K6: the parent's implicit GEMM through the same
                # wrapper code, and the wgmma kernel's other forms
                if deconv:
                    igemm = lambda: deconv_cuda._launch(  # noqa: E731
                        srcs[0], w, b, a)
                    forms = {f"tile {n}": lambda n=n: deconv_cuda
                             ._launch_wgmma(srcs[0], w, b, a, n)
                             for n in (128, 224)}
                else:
                    igemm = lambda: conv_cuda._launch(  # noqa: E731
                        "conv3x3_multi", srcs, w, b, a, 1, bf16)
                    forms = ({"fold": lambda: conv_cuda._launch_multi_wgmma(
                                  srcs, w, b, a, True),
                              "taps": lambda: conv_cuda._launch_multi_wgmma(
                                  srcs, w, b, a, False)}
                             if len(srcs) == 1 else {})
                extra = dict(route=route, igemm_ms=cuda_ms(igemm, reps))
                if route == "wgmma":
                    yr = ref()
                    form_err = {k: (f().float() - yr.float()).abs().mean()
                                .item() for k, f in forms.items()}
                    extra.update(form_ms={k: cuda_ms(f, reps)
                                          for k, f in forms.items()},
                                 form_bf16_mean_abs_err=form_err)
                    del yr
                    bad = {k: e for k, e in form_err.items()
                           if not e <= 1e-3}
                    if bad:
                        raise AssertionError(f"{kind} {site}: bf16 mean |d| "
                                             f"of the forms {bad} > 1e-3")
        out_px = (4 * B * H * W if deconv
                  else B * (-(-H // stride)) * (-(-W // stride)))
        nbytes = (sum(x.numel() * x.element_size() for x in srcs)
                  + 4 * (w.numel() + b.numel() + (a.numel() if prelu else 0))
                  + 2 * out_px * cout)
        flops = (2 * B * H * W * 4 * cout * cin if deconv
                 else 2 * out_px * cout * 9 * cin)
        b_ms, b_by, nbytes, flops = counted_bound(kind, site, run, nbytes,
                                                  flops, "bf16")
        (f_max, _), (h_max, h_mean) = err[torch.float32], err[bf16]
        rec = dict(phase="kernel", kernel=kind, site=site,
                   sources=[list(s[:4]) + ["f32" if s[4] else "work"]
                            + (["dense"] if len(s) > 5 and s[5] else [])
                            for s in shapes], cout=cout, prelu=bool(prelu),
                   per_forward=n, repeat_equal=repeat_equal,
                   f32_max_abs_err=f_max,
                   bf16_mean_abs_err=h_mean, bf16_max_abs_err=h_max,
                   max_abs_err=max(f_max, h_max), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   flops=flops, bytes=nbytes, **extra)
        emit(rec)
        if not (f_max <= 1e-4 and h_mean <= 1e-3):
            raise AssertionError(f"{kind} {site}: f32 max |d| {f_max} "
                                 f"(<= 1e-4), bf16 mean |d| {h_mean} "
                                 "(<= 1e-3)")
        if kind in ("conv3x3", "conv3x3_s2"):
            want = ("igemm" if cin < conv_cuda.WGMMA_MIN_CHANNELS
                    else "wgmma")
        else:  # K5, K6: every main-path site on wgmma, the odd layout not
            want = "igemm" if odd else "wgmma"
        if route != want:
            raise AssertionError(f"{kind} {site}: bf16 ran on {route}")
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
# K9 checks at other shapes: (B, H, W, C, pixel stride)
K9_ODD_SHAPES = [(2, 37, 70, 3, 3), (1, 301, 451, 3, 4), (3, 33, 65, 1, 1),
                 (2, 40, 64, 4, 4), (4, 150, 230, 3, 3), (2, 200, 344, 3, 3)]
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
                name = "K7" if kind == "window_attention" else "K8"
                b_ms, b_by, nbytes, flops = counted_bound(
                    f"{name} {kind}", f"{site} {dt}", lambda: fn(*args),
                    nbytes, flops, dt)
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

        with torch.no_grad():
            out = warp_cuda.flow_warp_blend(*args)
            ref = warp_plain.flow_warp_blend(*args)
            pair = k2_pair_blend()
            repeats = all(torch.equal(warp_cuda.flow_warp_blend(*args), out)
                          for _ in range(5))
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        pair_err = (pair - ref).abs().max().item()
        pair_equal = torch.equal(out, pair)
        reps = 50 if H >= 544 else 200
        ms = cuda_ms(lambda: warp_cuda.flow_warp_blend(*args), reps)
        plain_ms = cuda_ms(lambda: warp_plain.flow_warp_blend(*args), reps)
        lib_ms = cuda_ms(library, reps)
        pair_ms = cuda_ms(k2_pair_blend, reps)
        # device time alone (CUDA graph), on these flows and on smooth
        # ones (the main path's kind: coherent taps)
        dev = {"k9": graph_ms(lambda: warp_cuda.flow_warp_blend(*args)),
               "library": graph_ms(library),
               "k2_pair_blend": graph_ms(k2_pair_blend)}
        f0, f1 = (smooth_flow(torch, g, 1, H, W, 40.0 * H / 1088)
                  for _ in range(2))
        grids = [grid_of(torch, f) for f in (f0, f1)]
        args = (im0, im1, f0, f1, occ)
        with torch.no_grad():
            smooth_err = (warp_cuda.flow_warp_blend(*args)
                          - warp_plain.flow_warp_blend(*args)).abs().max()
        dev.update({
            "k9_smooth": graph_ms(lambda: warp_cuda.flow_warp_blend(*args)),
            "library_smooth": graph_ms(library),
            "k2_pair_blend_smooth": graph_ms(k2_pair_blend)})
        err = max(err, smooth_err.item())
        nbytes = H * W * (2 * 3 * 4 + 2 * 2 * 4 + 4 + 3 * 4)
        b_ms, b_by, nbytes, _ = counted_bound(
            "K9 flow_warp_blend", f"{H}x{W}",
            lambda: warp_cuda.flow_warp_blend(*args), nbytes,
            H * W * (14 * 3 + 30), "f32")
        rec = dict(phase="kernel", kernel="K9 flow_warp_blend",
                   shape=[1, H, W, 3], dtype="f32", per_forward=1,
                   max_abs_err=err, k2_pair_blend_max_abs_err=pair_err,
                   bit_equal_to_k2_pair_blend=pair_equal,
                   repeats_bit_equal=repeats, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library="2 x grid_sample + blend",
                   k2_pair_blend_ms=pair_ms, bound_ms=b_ms, bound_by=b_by,
                   ms_over_bound=ms / b_ms, bytes=nbytes,
                   device_ms=dev, device_ms_over_bound={
                       k: v / b_ms for k, v in dev.items()
                       if k.startswith("k9")},
                   registers=ptxas_registers(
                       r"warp_blend_kernelILi(\d+)ELi(\d+)E", "PPT {} C {}"))
        emit(rec)
        if not (err <= 1e-6 and pair_equal and repeats):
            raise AssertionError(f"K9 {H}x{W}: max |d| {err} (<= 1e-6), "
                                 f"bit-equal to the K2 pair + blend: "
                                 f"{pair_equal}, repeats bit-equal: "
                                 f"{repeats}")
        results["flow_warp_blend"].append(rec)

    # K9 off the main path's shapes: batches, ragged tiles, rows that do
    # not start 16-byte aligned, a pixel stride above C, other C
    for B, H, W, C, ps in K9_ODD_SHAPES:
        im0, im1 = (torch.rand(B, H, W, ps, generator=g,
                               device="cuda")[..., :C] for _ in range(2))
        f0, f1 = (edge_flow(torch, g, B, H, W, 6.0) for _ in range(2))
        occ = torch.rand(B, H, W, 1, generator=g, device="cuda")
        with torch.no_grad():
            out = warp_cuda.flow_warp_blend(im0, im1, f0, f1, occ)
            ref = warp_plain.flow_warp_blend(im0, im1, f0, f1, occ)
            w0, w1 = warp_cuda.flow_warp_pair(im0, im1, f0, f1)
            pair_equal = torch.equal(out, occ * w0 + (1 - occ) * w1)
        err = (out - ref).abs().max().item()
        emit(dict(phase="kernel", kernel="K9 flow_warp_blend, odd shape",
                  shape=[B, H, W, C], pixel_stride=ps, max_abs_err=err,
                  bit_equal_to_k2_pair_blend=pair_equal))
        if not (err <= 1e-6 and pair_equal):
            raise AssertionError(f"K9 {[B, H, W, C]} stride {ps}: max |d| "
                                 f"{err} (<= 1e-6), bit-equal to the K2 "
                                 f"pair + blend: {pair_equal}")

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
        b_ms, b_by, nbytes, flops = counted_bound(
            "K12 conv3x3_pair", site, run, nbytes, flops, "bf16")
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


def smooth_stream(torch, n: int, H: int, W: int, seed: int):
    """n uint8 frames of one smooth random canvas, each cut at its own
    offset of up to 6 pixels, made on the CPU from a seed."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    base = torch.rand(1, 3, H // 16 + 2, W // 16 + 2, generator=g)
    img = F.interpolate(base, size=(H + 32, W + 32), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    frames = []
    for _ in range(n):
        dx, dy = (int(v) for v in torch.randint(-6, 7, (2,), generator=g))
        f = img[0, :, 16 + dy:16 + dy + H, 16 + dx:16 + dx + W]
        frames.append((f * 255).round().to(torch.uint8).permute(1, 2, 0)
                      .contiguous().numpy())
    return frames


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
    "grid_matmul": ("probe_cuda", "grid_matmul"),
}


def wrapper_counters() -> dict:
    """Every kernel wrapper by its name in COUNTED."""
    import importlib

    return {k: getattr(importlib.import_module(
        f"atmvfi_tpu_torch.ops.{mod}"), attr)
        for k, (mod, attr) in COUNTED.items()}


# the wrappers of the attention launch, which count their launches of
# its key-tiled form (windows above 12) apart: "<name>_tiled" in a run's
# launches, 0 on every path at the default windows
TILED_WRAPPERS = ("atm_block", "window_attention", "window_attention_heads")


def reset_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
    for k in TILED_WRAPPERS:
        counters[k].tiled_launches = 0
    reset_wgmma(counters)


def read_counts(counters) -> dict:
    launches = {k: fn.launches for k, fn in counters.items()}
    for k in TILED_WRAPPERS:
        launches[k + "_tiled"] = counters[k].tiled_launches
    read_wgmma(counters, launches)
    return launches


def with_wgmma(name: str, per_forward: dict) -> dict:
    """Launches per forward of a path, with those of the K3-K6 wgmma
    kernels among them."""
    return dict(per_forward, conv3x3_wgmma=WGMMA_PER_FORWARD[name],
                conv3x3_s2_wgmma=per_forward["conv3x3_s2"]
                - k4_igemm_per_forward(),
                conv3x3_multi_wgmma=per_forward["conv3x3_multi"],
                deconv2x_wgmma=per_forward["deconv2x"])


def check_launches(name: str, launches: dict, per_forward: dict,
                   forwards: int) -> None:
    for k in launches:
        if launches[k] != per_forward.get(k, 0) * forwards:
            raise AssertionError(f"{name}: {k}: {launches[k]} launches in "
                                 f"{forwards} forwards, expected "
                                 f"{per_forward.get(k, 0)} each")


MEASURED = {}  # ms per frame of each main-path run (phase 5), by config


def phase_main_path(torch, name: str, routes: dict, fast: bool,
                    per_forward: dict, frames: int):
    """One run of the serving path; every wrapper's count is set to 0
    just before the timed frames and read just after."""
    import dataclasses

    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.models import get_config

    counters = wrapper_counters()
    cfg = dataclasses.replace(get_config("base"), **routes)
    pipe = InterpolationPipeline(None, cfg, torch.bfloat16,
                                 global_motion=True, device="cuda",
                                 fast=fast)
    pairs = smooth_frames(torch, frames + 1, 1080, 1920, seed=3)
    pipe.interpolate(*pairs[0])  # warm-up: cuDNN plans, masks
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    outs = [pipe.interpolate(f0, f1) for f0, f1 in pairs[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    n = len(outs)
    for o in outs:
        if o.shape != (1080, 1920, 3) or o.dtype.name != "uint8":
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
    check_launches(name, launches, with_wgmma(name, per_forward), n)
    # the middle frame of a shifted pair lies near both inputs
    f0, f1 = pairs[1]
    err = float(abs(outs[0].astype("float32") - f0.astype("float32")).mean())
    MEASURED[name] = dt * 1e3 / n
    emit(dict(phase="main_path", config=name, model="base", dtype="bf16",
              routes=routes, fast=fast, frames=n, size=[1080, 1920],
              padded=[1088, 1920], ms_per_frame=dt * 1e3 / n,
              launches=launches, mean_abs_diff_to_frame0_u8=err,
              gpu=nvidia_smi_line()))
    del pipe
    torch.cuda.empty_cache()
    return launches


STREAM_BATCHES = (1, 2, 4)


def phase_stream(torch):
    """Batched streaming: the 1080p stream at each batch of
    STREAM_BATCHES (base, bf16, default routes, 9 frames, factor 2;
    every wrapper's count set to 0 just before the timed run and read
    just after), its I_t against batch 1; f32 at 256x448 with padded
    tails against batch 1 on the card and the CPU port; run-time window
    sizes; the CLI's --video mode. Returns the batch-4 run's launches."""
    import contextlib
    import io
    import math
    import tempfile

    from atmvfi_tpu_torch.cli import demo_2x
    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.utils.video import Y4MReader, Y4MWriter

    counters = wrapper_counters()
    pipe = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, device="cuda")
    frames = smooth_stream(torch, 9, 1080, 1920, seed=11)
    n_out = 2 * (len(frames) - 1) + 1
    one = None
    for batch in STREAM_BATCHES:
        # untimed run first (warm-up at this batch): the I_t kept
        its = [x for k, x in enumerate(
            pipe.interpolate_stream_device(frames, 2, batch)) if k % 2]
        torch.cuda.synchronize()
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = list(pipe.interpolate_stream_batched(frames, 2, batch))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts(counters)
        forwards = math.ceil((len(frames) - 1) / batch)
        if len(outs) != n_out or any(o.shape != (1080, 1920, 3)
                                     or o.dtype.name != "uint8"
                                     for o in outs):
            raise AssertionError(f"stream batch {batch}: bad output")
        check_launches(f"stream batch {batch}", launches,
                       with_wgmma("default", PER_FORWARD), forwards)
        if one is None:
            one = its
        d = torch.stack([(a - b).abs().mean() for a, b in zip(its, one)])
        dmax = max((a - b).abs().max().item() for a, b in zip(its, one))
        emit(dict(phase="stream", model="base", dtype="bf16", batch=batch,
                  frames_in=len(frames), frames_out=n_out, factor=2,
                  forwards=forwards, size=[1080, 1920], padded=[1088, 1920],
                  ms_per_output_frame=dt * 1e3 / n_out,
                  ms_per_interpolated_frame=dt * 1e3 / (len(frames) - 1),
                  peak_memory_bytes=torch.cuda.max_memory_allocated(),
                  launches_per_forward={k: v / forwards
                                        for k, v in launches.items() if v},
                  I_t_vs_batch1_mean_abs=d.max().item(),
                  I_t_vs_batch1_max_abs=dmax, tolerance_mean=1e-3,
                  gpu=nvidia_smi_line()))
        if not d.max().item() <= 1e-3:
            raise AssertionError(f"stream batch {batch}: I_t mean |d| "
                                 f"{d.max().item()} > 1e-3 against batch 1")
    del pipe, one, its, outs
    torch.cuda.empty_cache()

    # f32 (TF32 off): padded tails, against batch 1 and the CPU port
    card = InterpolationPipeline(None, "base", torch.float32, device="cuda")
    cpu = InterpolationPipeline(None, "base", torch.float32, device="cpu")
    frames = smooth_stream(torch, 6, 256, 448, seed=12)
    one = [x.cpu() for x in card.interpolate_stream_device(frames, 2, 1)]
    for batch in (2, 3):
        got = [x.cpu() for x in card.interpolate_stream_device(frames, 2,
                                                               batch)]
        ref = list(cpu.interpolate_stream_device(frames, 2, batch))
        d_card = max((a - b).abs().max().item() for a, b in zip(got, one))
        d_cpu = max((a - b).abs().max().item() for a, b in zip(got, ref))
        emit(dict(phase="stream_agreement", model="base", dtype="f32",
                  size=[256, 448], frames_in=len(frames), batch=batch,
                  frames_out=len(got), I_t_vs_card_batch1_max_abs=d_card,
                  I_t_vs_cpu_max_abs=d_cpu, tolerance_card=1e-4,
                  tolerance_cpu=1e-3))
        if not (len(got) == len(one) == 11 and d_card <= 1e-4
                and d_cpu <= 1e-3):
            raise AssertionError(f"f32 stream batch {batch}: {len(got)} "
                                 f"frames, max |d| {d_card} against batch 1 "
                                 f"(<= 1e-4), {d_cpu} against the CPU "
                                 "(<= 1e-3)")

    # run-time window sizes (6, 8), then back to (8, 12)
    f0, f1 = frames[:2]
    first = card.interpolate(f0, f1)
    for p in (card, cpu):
        p.set_window_sizes(local=6, global_=8)
    mid = [list(p.interpolate_stream_device([f0, f1], 2, 1))[1].cpu()
           for p in (card, cpu)]
    d_win = (mid[0] - mid[1]).abs().max().item()
    card.set_window_sizes(local=8, global_=12)
    back = card.interpolate(f0, f1)
    same = bool((back == first).all())
    emit(dict(phase="window_sizes", model="base", dtype="f32",
              size=[256, 448], windows=[6, 8, 8],
              I_t_card_vs_cpu_max_abs=d_win, tolerance=1e-3,
              back_to_8_12_bit_equal=same))
    if not (d_win <= 1e-3 and same):
        raise AssertionError(f"window sizes (6, 8): card vs CPU max |d| "
                             f"{d_win} (<= 1e-3); back to (8, 12) "
                             f"bit-equal: {same}")
    del card, cpu
    torch.cuda.empty_cache()

    # the CLI's --video mode: lite, a 5-frame C420 .y4m, batch 2
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in.y4m"), os.path.join(d, "out.y4m")
        with Y4MWriter(src, 448, 256, fps=(30, 1), colorspace="C420") as w:
            for f in smooth_stream(torch, 5, 256, 448, seed=13):
                w.write(f)
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = demo_2x.main(["--video", src, "--out", out, "--model_type",
                               "lite", "--batch", "2"])
        with Y4MReader(out) as r:
            head = (r.width, r.height, r.fps, r.colorspace)
            n = sum(1 for f in r if f.shape == (256, 448, 3))
    emit(dict(phase="cli_video", model="lite", dtype="bf16", batch=2,
              rc=rc, header=list(head), frames_out=n,
              said=said.getvalue().strip().splitlines()))
    if rc != 0 or head != (448, 256, (60, 1), "C420") or n != 9:
        raise AssertionError(f"--video: rc {rc}, header {head}, {n} frames "
                             "(expected 0, (448, 256, (60, 1), 'C420'), 9)")
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


# windows above 12 (the key-tiled attention forms): the window sizes and
# the attention sites they run at (ATTN_SITES' token maps, channels and
# shifts of half the window; enhancement unshifted)
BIG_WINDOWS = (13, 16, 24, 32)
WINDOW_FRAMES = 6  # timed 1080p frames a window pair, in each of 2 rounds


def attention_operands(torch, g, site: str, ws: int, dtype):
    """(q, kv, rel, mask, heads, C, BW, N) of one window-attention call at
    an ATTN_SITES site with window ws: random q and kv, the site's mask
    and relative coordinates."""
    from atmvfi_tpu_torch import ops

    _, h, w, _, ss, motion, C = next(a for a in ATTN_SITES if a[0] == site)
    ss = 0 if site == "enhance" else ws // 2
    mask = ops.attn_mask_for(h, w, ws, ss, "cuda")
    rel = ops.relative_coords(ws, "cuda") if motion else None
    BW, N = 2 * -(-h // ws) * -(-w // ws), ws * ws
    qkv = torch.randn(BW, N, 3 * C, generator=g, device="cuda").to(dtype)
    return qkv[..., :C], qkv[..., C:], rel, mask, 8, C, BW, N


def attention_work(BW, N, C, heads, s, mask, motion):
    """(bytes, flops) of one window-attention call: q, k, v read, out
    written, the mask and rel read and motion written."""
    nbytes = (4 * BW * N * C * s + (mask.numel() * 4 if mask is not None
                                    else 0)
              + (2 * N * N * 4 + BW * N * 2 * heads * s if motion else 0))
    flops = (4 * BW * heads * N * N * (C // heads)
             + (4 * BW * heads * N * N if motion else 0))
    return nbytes, flops


def k7_split_ms(fn, q, kv, scale, mask, heads) -> dict:
    """The time the mask and the motion add to a K7 call: ms a launch
    with the mask alone and with neither."""
    return dict(mask=cuda_ms(lambda: fn(q, kv, scale, None, mask, heads), 10),
                none=cuda_ms(lambda: fn(q, kv, scale, None, None, heads), 10))


def windows_split(torch):
    """K7 at the base local site, windows 16 and 24 (key-tiled), bf16 and
    f32: ms a launch with mask and rel, the mask alone and neither
    (phase 11's `split_ms`), scaled_dot_product_attention's beside. It
    calls only what the port has had since it took windows above 12, so
    a copy of this script beside an older checkout measures the same
    split there."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch.ops import attention_cuda

    g = torch.Generator(device="cuda").manual_seed(21)
    fn = attention_cuda.window_attention
    for ws in (16, 24):
        for dtype in (torch.bfloat16, torch.float32):
            q, kv, rel, mask, heads, C, BW, N = attention_operands(
                torch, g, "local", ws, dtype)
            qh, kh, vh = (t.reshape(BW, N, heads, C // heads).transpose(1, 2)
                          .contiguous() for t in (q, kv[..., :C], kv[..., C:]))
            full = mask.repeat(BW // mask.shape[0], 1, 1)[:, None].to(dtype)
            scale = (C // heads) ** -0.5
            with torch.no_grad():
                emit(dict(phase="windows_split", case="local", window=ws,
                          dtype="f32" if dtype == torch.float32 else "bf16",
                          full=cuda_ms(lambda: fn(q, kv, scale, rel, mask,
                                                  heads), 10),
                          **k7_split_ms(fn, q, kv, scale, mask, heads),
                          library_ms=cuda_ms(
                              lambda: F.scaled_dot_product_attention(
                                  qh, kh, vh, attn_mask=full, scale=scale),
                              10),
                          gpu=nvidia_smi_line()))
            del q, kv, qh, kh, vh, full


def phase_windows(torch):
    """Windows above 12 on the card: K7 (all sites), K8 (base local) and
    K1 (all sites) at windows 13, 16, 24 and 32 against their plain
    versions (f32 max |d| <= 1e-4, bf16 mean <= 5e-3), timed with the
    plain version, the bound and scaled_dot_product_attention (K7 at the
    local site also with the mask alone and with neither mask nor rel:
    `split_ms`); the single-pass form's bf16 times at the main path's
    windows beside them; each launch's form checked by the wrappers'
    tiled counts, and the key-tiled form compact on every model mask
    (`form`); the general form on a random mask and rel
    (`windows_general_cases`); the f32 pipeline at set_window_sizes(16,
    24) card against the CPU port; the base bf16 1080p path at (8, 12)
    and (16, 24) in turns (ms/frame, every wrapper's launches set to 0
    just before and read just after), bit-equal at (8, 12) after (16,
    24). Returns (records, launches of the (16, 24) frames)."""
    import torch.nn.functional as F

    from atmvfi_tpu_torch.ops import attention as attn_plain
    from atmvfi_tpu_torch.ops import attention_cuda

    g = torch.Generator(device="cuda").manual_seed(21)
    tol = {torch.float32: ("max", 1e-4), torch.bfloat16: ("mean", 5e-3)}
    recs = []
    sites = [a[0] for a in ATTN_SITES]
    for ws in (8, 12) + BIG_WINDOWS:
        for site in sites:
            if ws in (8, 12) and (site.startswith("lite") or (
                    ws == 12) != (site == "global")):
                continue  # the single-pass form at the main path's sites
            for dtype in (torch.float32, torch.bfloat16):
                if ws in (8, 12) and dtype == torch.float32:
                    continue
                q, kv, rel, mask, heads, C, BW, N = attention_operands(
                    torch, g, site, ws, dtype)
                hd = C // heads
                scale = hd ** -0.5
                qh, kh, vh = (t.reshape(BW, N, heads, hd).transpose(1, 2)
                              .contiguous()
                              for t in (q, kv[..., :C], kv[..., C:]))
                kinds = [("K7", attention_cuda.window_attention,
                          attn_plain.window_attention,
                          (q, kv, scale, rel, mask, heads))]
                if site == "local":
                    kinds.append(("K8", attention_cuda.window_attention_heads,
                                  attn_plain.window_attention_heads,
                                  (qh, kh, vh, scale, rel, mask)))
                timed = not site.startswith("lite")
                for name, fn, plain, args in kinds:
                    with torch.no_grad():
                        before = fn.tiled_launches, fn.general_launches
                        (o, m), (orf, mrf) = fn(*args), plain(*args)
                        tiled = fn.tiled_launches - before[0]
                        general = fn.general_launches - before[1]
                        form = launch_form(tiled, general)
                        torch.cuda.synchronize()
                        do = (o.float() - orf.float()).abs()
                        dm = ((m.float() - mrf.float()).abs()
                              if rel is not None
                              else torch.zeros(1, device="cuda"))
                    stat, lim = tol[dtype]
                    err = (max(do.max().item(), dm.max().item())
                           if stat == "max"
                           else max(do.mean().item(), dm.mean().item()))
                    dt = "f32" if dtype == torch.float32 else "bf16"
                    nbytes, flops = attention_work(BW, N, C, heads,
                                                   q.element_size(), mask,
                                                   rel is not None)
                    b_ms, b_by = bound_ms(nbytes, flops, dt)
                    rec = dict(phase="windows_kernel", kernel=name, case=site,
                               window=ws, dtype=dt, BW=BW, N=N, C=C,
                               tiled=bool(tiled), form=form,
                               max_abs_err=do.max().item(),
                               mean_abs_err=do.mean().item(),
                               motion_max_abs_err=dm.max().item(),
                               motion_mean_abs_err=dm.mean().item(),
                               bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                               flops=flops)
                    if timed:
                        full = (None if mask is None else
                                mask.repeat(BW // mask.shape[0], 1, 1)[:, None]
                                .to(dtype))
                        rec.update(
                            ms=cuda_ms(lambda: fn(*args), 10),
                            plain_ms=cuda_ms(lambda: plain(*args), 3, 1),
                            library_ms=cuda_ms(
                                lambda: F.scaled_dot_product_attention(
                                    qh, kh, vh, attn_mask=full, scale=scale),
                                10),
                            library="scaled_dot_product_attention, out only")
                        del full
                        if name == "K7" and tiled and site == "local":
                            rec["split_ms"] = dict(
                                full=rec["ms"], **k7_split_ms(
                                    fn, q, kv, scale, mask, heads))
                    emit(rec)
                    recs.append(rec)
                    if not err <= lim:
                        raise AssertionError(
                            f"{name} {site} window {ws} {dt}: {stat} |d| "
                            f"{err} > {lim}")
                    if tiled != (ws not in (8, 12)):  # N > 160 alone
                        raise AssertionError(
                            f"{name} {site} window {ws} {dt}: {tiled} "
                            "launches of the key-tiled form")
                    if general:  # the model's masks: regions
                        raise AssertionError(
                            f"{name} {site} window {ws} {dt}: {general} "
                            "launches of the general form")
                    del o, m, orf, mrf, do, dm
                del q, kv, qh, kh, vh, kinds
        # K1 (its attention launch is the same kernel) at this window
        for site in sites if ws not in (8, 12) else ():
            for dtype in (torch.float32, torch.bfloat16):
                recs.append(windows_block_case(torch, g, site, ws, dtype,
                                               tol[dtype]))
        torch.cuda.empty_cache()
    recs += windows_general_cases(torch, g, tol)
    launches = windows_pipelines(torch)
    return recs, launches


def launch_form(tiled: int, general: int):
    """The form of one attention launch from its wrapper's counts over
    it: None (single-pass), "compact" or "general" (key-tiled)."""
    return None if not tiled else "general" if general else "compact"


def general_mask_rel(torch, g, mask, rel):
    """A random mask and rel of the shapes of `mask` and `rel` that have
    no compact form: -100 at a fifth of the scores, -inf at a twentieth
    and over the first 64-key tile of every fourth query row (a tile in
    which such a row sees no key), rel Gaussian."""
    u = torch.rand(mask.shape, generator=g, device="cuda")
    mask = torch.where(u < 0.2, -100.0, 0.0)
    mask = torch.where(u > 0.95, -torch.inf, mask)
    mask[:, ::4, :64] = -torch.inf
    return mask, 4.0 * torch.randn(rel.shape, generator=g, device="cuda")


def wide_head_operands(torch, g, dtype):
    """(q, kv, rel, mask, heads, C, BW, N) of K7 at head dim 128 (2 heads,
    window 16 shifted by 8 over a 48 x 64 token map, 2 images): the
    widest head the kernels take."""
    from atmvfi_tpu_torch import ops

    mask = ops.attn_mask_for(48, 64, 16, 8, "cuda")
    rel = ops.relative_coords(16, "cuda")
    BW, N, C = 2 * mask.shape[0], 256, 256
    qkv = torch.randn(BW, N, 3 * C, generator=g, device="cuda").to(dtype)
    return qkv[..., :C], qkv[..., C:], rel, mask, 2, C, BW, N


# (kernel, site, window, general) of windows_general_cases: the general
# form at head dims 48 (windows 13 and 16, K7 and K8), 84 (global), 28
# (lite local) and 128, through K1 with swap; the compact form at 128
GENERAL_CASES = [("K7", "local", 13, True), ("K7", "local", 16, True),
                 ("K8", "local", 16, True), ("K7", "global", 24, True),
                 ("K7", "lite local", 16, True), ("K1", "local", 16, True),
                 ("K7", "head dim 128", 16, True),
                 ("K7", "head dim 128", 16, False)]


def windows_general_cases(torch, g, tol):
    """The key-tiled forms' general form (mask and rel tiles staged beside
    k and v), forced by a random mask that is no region mask, with -inf
    entries (`general_mask_rel`), and a random rel that is no coordinate
    difference, and the compact form at head dim 128 (GENERAL_CASES), f32
    and bf16, each against the plain version on the same inputs, timed;
    the form each launch took read from its wrapper's counts."""
    from atmvfi_tpu_torch.ops import attention as attn_plain
    from atmvfi_tpu_torch.ops import attention_cuda

    recs = []
    for kernel, site, ws, general_case in GENERAL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            if kernel == "K1":
                recs.append(windows_block_case(torch, g, site, ws, dtype,
                                               tol[dtype], general=True))
                continue
            q, kv, rel, mask, heads, C, BW, N = (
                wide_head_operands(torch, g, dtype) if site == "head dim 128"
                else attention_operands(torch, g, site, ws, dtype))
            if general_case:
                mask, rel = general_mask_rel(torch, g, mask, rel)
            hd = C // heads
            scale = hd ** -0.5
            if kernel == "K7":
                fn, plain = (attention_cuda.window_attention,
                             attn_plain.window_attention)
                args = (q, kv, scale, rel, mask, heads)
            else:
                fn, plain = (attention_cuda.window_attention_heads,
                             attn_plain.window_attention_heads)
                args = (*(t.reshape(BW, N, heads, hd).transpose(1, 2)
                          .contiguous() for t in (q, kv[..., :C], kv[..., C:])),
                        scale, rel, mask)
            with torch.no_grad():
                before = fn.tiled_launches, fn.general_launches
                (o, m), (orf, mrf) = fn(*args), plain(*args)
                form = launch_form(fn.tiled_launches - before[0],
                                   fn.general_launches - before[1])
                torch.cuda.synchronize()
                do = (o.float() - orf.float()).abs()
                dm = (m.float() - mrf.float()).abs()
            stat, lim = tol[dtype]
            err = (max(do.max().item(), dm.max().item()) if stat == "max"
                   else max(do.mean().item(), dm.mean().item()))
            dt = "f32" if dtype == torch.float32 else "bf16"
            rec = dict(phase="windows_kernel", kernel=kernel,
                       case=site + (", random mask and rel" if general_case
                                    else ""),
                       window=ws, dtype=dt, BW=BW, N=N, C=C, head_dim=hd,
                       tiled=True, form=form, max_abs_err=do.max().item(),
                       mean_abs_err=do.mean().item(),
                       motion_max_abs_err=dm.max().item(),
                       motion_mean_abs_err=dm.mean().item(),
                       ms=cuda_ms(lambda: fn(*args), 5))
            emit(rec)
            recs.append(rec)
            if not err <= lim:  # NaN fails too
                raise AssertionError(f"{kernel} {rec['case']} window {ws} "
                                     f"{dt}: {stat} |d| {err} > {lim}")
            want = "general" if general_case else "compact"
            if form != want:
                raise AssertionError(f"{kernel} {rec['case']} window {ws} "
                                     f"{dt}: form {form}, not {want}")
            del o, m, orf, mrf, do, dm, q, kv, args, mask, rel
    return recs


def windows_block_case(torch, g, site: str, ws: int, dtype, tol,
                       general: bool = False):
    """K1 at an ATTN_SITES site with window ws (random tokens and
    weights; with general=True a random mask and rel, `general_mask_rel`)
    against its plain version; bf16 base sites also time the attention
    launch alone."""
    from atmvfi_tpu_torch.ops import attention_cuda
    from atmvfi_tpu_torch.ops.attention import atm_block_reference

    q, _, rel, mask, heads, C, BW, N = attention_operands(torch, g, site, ws,
                                                          dtype)
    if general:
        mask, rel = general_mask_rel(torch, g, mask, rel)
    x = q.contiguous()
    del q, _
    def w(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * C ** -0.5

    args = (x, w(C, C), w(2 * C, C), w(C, C), w(C) * 0.1,
            1.0 + 0.1 * w(C), 0.1 * w(C), (C // heads) ** -0.5, rel, mask,
            heads, rel is not None)
    block = attention_cuda.atm_block
    with torch.no_grad():
        before = block.tiled_launches, block.general_launches
        (y, m), (yr, mr) = block(*args), atm_block_reference(*args)
        tiled = block.tiled_launches - before[0]
        form = launch_form(tiled, block.general_launches - before[1])
        torch.cuda.synchronize()
        dy = (y.float() - yr.float()).abs()
        dm = ((m.float() - mr.float()).abs() if m is not None
              else torch.zeros(1, device="cuda"))
    stat, lim = tol
    err = (max(dy.max().item(), dm.max().item()) if stat == "max"
           else max(dy.mean().item(), dm.mean().item()))
    dt = "f32" if dtype == torch.float32 else "bf16"
    rec = dict(phase="windows_kernel", kernel="K1",
               case=site + (", random mask and rel" if general else ""),
               window=ws, dtype=dt, BW=BW, N=N, C=C, swap=args[-1],
               form=form, max_abs_err=dy.max().item(),
               mean_abs_err=dy.mean().item(),
               motion_max_abs_err=dm.max().item(),
               motion_mean_abs_err=dm.mean().item())
    if dtype == torch.bfloat16 and not site.startswith("lite"):
        run, _ = attention_cuda.block_launches(*args)
        with torch.no_grad():
            run(0)
            rec["attention_launch_ms"] = cuda_ms(lambda: run(2), 10)
    emit(rec)
    if not err <= lim:
        raise AssertionError(f"K1 {rec['case']} window {ws} {dt}: {stat} "
                             f"|d| {err} > {lim}")
    want = "general" if general else "compact"
    if tiled != 1 or form != want:
        raise AssertionError(f"K1 {rec['case']} window {ws} {dt}: {tiled} "
                             f"launches of the key-tiled form, form {form}, "
                             f"not {want}")
    return rec


def windows_pipelines(torch):
    """The pipeline at set_window_sizes(16, 24): base f32 256x448 card
    against the CPU port; base bf16 1080p at (8, 12) and (16, 24) in
    turns, two rounds of WINDOW_FRAMES timed frames each (ms per frame,
    every wrapper's launches set to 0 just before a window's frames and
    read just after), bit-equal at (8, 12) after each stay at (16, 24).
    Returns the (16, 24) frames' launches."""
    from atmvfi_tpu_torch.infer import InterpolationPipeline

    f0, f1 = smooth_frames(torch, 1, 256, 448, seed=22)[0]
    outs = []
    for dev in ("cuda", "cpu"):
        p = InterpolationPipeline(None, "base", torch.float32, device=dev)
        p.set_window_sizes(local=16, global_=24)
        x0, x1 = (torch.from_numpy(f).to(dev).float()[None] / 255.0
                  for f in (f0, f1))
        outs.append(p.interpolate_device(x0, x1).cpu())
        del p
    err = (outs[0] - outs[1]).abs().max().item()
    emit(dict(phase="windows_pipeline", model="base", dtype="f32",
              size=[256, 448], windows=[16, 24, 8],
              I_t_card_vs_cpu_max_abs=err, tolerance=1e-3))
    if not (err <= 1e-3 and bool(torch.isfinite(outs[0]).all())):
        raise AssertionError(f"windows (16, 24) f32: card vs CPU max |d| "
                             f"{err} > 1e-3")

    # base bf16 1080p at (8, 12) and (16, 24) in turns, twice: one
    # untimed forward after each switch, then WINDOW_FRAMES timed frames
    counters = wrapper_counters()
    pipe = InterpolationPipeline(None, "base", torch.bfloat16, device="cuda")
    pairs = smooth_frames(torch, WINDOW_FRAMES + 1, 1080, 1920, seed=23)
    first = pipe.interpolate(*pairs[0])
    times = {(8, 12): [], (16, 24): []}
    launches, same, ok = {}, True, True
    for _ in range(2):
        for ws in times:
            pipe.set_window_sizes(local=ws[0], global_=ws[1])
            back = pipe.interpolate(*pairs[0])  # warm-up at these windows
            if ws == (8, 12):
                same = same and bool((back == first).all())
            torch.cuda.synchronize()
            reset_counts(counters)
            for a, b in pairs[1:]:
                t0 = time.perf_counter()
                o = pipe.interpolate(a, b)
                times[ws].append((time.perf_counter() - t0) * 1e3)
                ok = ok and o.shape == (1080, 1920, 3)
            got = read_counts(counters)
            # 2 local and 2 global blocks per forward run the tiled form
            check_launches(f"windows {ws} 1080p", got, dict(
                with_wgmma("default", PER_FORWARD),
                atm_block_tiled=4 if ws == (16, 24) else 0), WINDOW_FRAMES)
            launches[ws] = {k: launches.get(ws, {}).get(k, 0) + v
                            for k, v in got.items()}
    med = {ws: statistics.median(t) for ws, t in times.items()}
    emit(dict(phase="windows_main_path", model="base", dtype="bf16",
              size=[1080, 1920], frames_per_window=len(times[(16, 24)]),
              ms_per_frame={str(ws): statistics.mean(t)
                            for ws, t in times.items()},
              median_ms_per_frame={str(ws): m for ws, m in med.items()},
              ms_per_frame_by_round={str(ws): [
                  statistics.mean(t[:WINDOW_FRAMES]),
                  statistics.mean(t[WINDOW_FRAMES:])]
                  for ws, t in times.items()},
              frame_ms={str(ws): t for ws, t in times.items()},
              median_ms_16_24_minus_8_12=med[(16, 24)] - med[(8, 12)],
              launches={str(ws): v for ws, v in launches.items()},
              back_to_8_12_bit_equal=same, gpu=nvidia_smi_line()))
    if not (ok and same):
        raise AssertionError(f"windows 1080p: outputs {ok}, back to (8, 12) "
                             f"bit-equal {same}")
    del pipe
    torch.cuda.empty_cache()
    return launches[(16, 24)]


def eval_counted(torch, counters, name: str, run):
    """run() with every wrapper's count set to 0 just before and read
    just after; raises unless K1, K2, K3 and K6 launched. Returns
    (run's result, launches)."""
    torch.cuda.synchronize()
    reset_counts(counters)
    out = run()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    for k in ("atm_block", "flow_warp_pair", "conv3x3", "deconv2x"):
        if not launches[k]:
            raise AssertionError(f"eval {name}: no {k} launch ({launches})")
    return out, {k: v for k, v in launches.items() if v}


def phase_eval(torch):
    """The evaluation protocols on the card (evalkit.harness), seeded base
    weights: Vimeo over tests/fixtures/mini_vimeo (global motion off) in
    f32 against the CPU port (mean PSNR <= 0.01 dB, SSIM <= 1e-4 apart)
    and in bf16, with the host's PNG decode time of the fixture; Xiph on
    a synthetic 11-frame 2160x4096 clip (staged from a .y4m by
    utils.video.prepare_xiph; both categories, 5 items each, bf16,
    global motion, 1088x2048 forwards; ms per forward over the 4 after
    the first, peak memory; TTA on 3 items); SNU-FILM's four splits on
    three 720x1280 triplets (pad 64); DAVIS 4x on 3
    frames; the benchmark CLI on the fixture; the checkpoint CLIs' round
    trip (.npz -> .pt -> .npz), the forward bit-equal before and after.
    Every wrapper's count is set to 0 just before each protocol's run
    and read just after."""
    import contextlib
    import io
    import tempfile

    from atmvfi_tpu_torch import convert
    from atmvfi_tpu_torch.cli import benchmark, convert_checkpoint
    from atmvfi_tpu_torch.cli import export_checkpoint
    from atmvfi_tpu_torch.evalkit import harness
    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.utils import images, video

    counters = wrapper_counters()
    fixture = os.path.join(HERE, "tests", "fixtures", "mini_vimeo")
    gpu = nvidia_smi_line()

    # Vimeo: f32 card against f32 CPU, then bf16 on the card
    res = {}
    for name, dev, dt in (("f32 card", "cuda", torch.float32),
                          ("f32 cpu", "cpu", torch.float32),
                          ("bf16 card", "cuda", torch.bfloat16)):
        pipe = InterpolationPipeline(None, "base", dt, global_motion=False,
                                     device=dev)
        def run():
            return harness.run_vimeo90k(pipe, fixture, progress=False)

        if dev == "cuda":
            res[name], launches = eval_counted(torch, counters,
                                               f"vimeo {name}", run)
            res[name]["launches"] = launches
        else:
            res[name] = run()
        del pipe
    d_psnr = abs(res["f32 card"]["psnr"] - res["f32 cpu"]["psnr"])
    d_ssim = abs(res["f32 card"]["ssim"] - res["f32 cpu"]["ssim"])
    # the host's PNG decode of the fixture's 30 frames (Paeth rows)
    pngs = sorted(os.path.join(r, f) for r, _, fs in os.walk(fixture)
                  for f in fs if f.endswith(".png"))
    t0 = time.perf_counter()
    for f in pngs:
        images.read_image(f)
    png_ms = (time.perf_counter() - t0) * 1e3 / len(pngs)
    emit(dict(phase="eval", protocol="vimeo90k", model="base",
              global_motion=False, size=[256, 448], results=res,
              f32_psnr_card_vs_cpu=d_psnr, f32_ssim_card_vs_cpu=d_ssim,
              tolerance_psnr_db=0.01, tolerance_ssim=1e-4,
              steady_forwards=res["bf16 card"]["n"] - 1,
              bf16_ms_per_forward=1e3 / res["bf16 card"]["steady_fps"],
              host_png_read_ms_per_image=png_ms,
              host_png_read_ms_per_item=3 * png_ms, gpu=gpu))
    if not (res["f32 card"]["n"] == 10 and d_psnr <= 0.01
            and d_ssim <= 1e-4 and math.isfinite(res["bf16 card"]["psnr"])):
        raise AssertionError(f"vimeo f32 card vs CPU: PSNR {d_psnr} dB "
                             f"(<= 0.01), SSIM {d_ssim} (<= 1e-4)")
    torch.cuda.empty_cache()

    pipe = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, pad_divisor=32,
                                 device="cuda")
    with tempfile.TemporaryDirectory() as d:
        # Xiph: an 11-frame 2160x4096 C420 clip -> 001..011.png, 5 items
        # a category (the first forward of a shape is left out of
        # steady_fps: 4 timed)
        with video.Y4MWriter(os.path.join(d, "Tango.y4m"), 4096, 2160,
                             colorspace="C420") as w:
            for f in smooth_stream(torch, 11, 2160, 4096, seed=31):
                w.write(f)
        staged = video.prepare_xiph(d, os.path.join(d, "xiph"), ["Tango"])
        torch.cuda.reset_peak_memory_stats()
        xiph, launches = eval_counted(torch, counters, "xiph", lambda: (
            harness.run_xiph(pipe, os.path.join(d, "xiph"), clips=("Tango",),
                             frame_limit=5)))
        peak = torch.cuda.max_memory_allocated()
        tta, _ = eval_counted(torch, counters, "xiph tta", lambda: (
            harness.run_xiph(pipe, os.path.join(d, "xiph"),
                             categories=("cropped-4k",), clips=("Tango",),
                             frame_limit=3, tta=True)))
        emit(dict(phase="eval", protocol="xiph", model="base", dtype="bf16",
                  global_motion=True, source=[2160, 4096], staged=staged,
                  forward_size=[1088, 2048], results=xiph,
                  steady_forwards={k: v["n"] - 1 for k, v in xiph.items()},
                  ms_per_forward={k: 1e3 / v["steady_fps"]
                                  for k, v in xiph.items()},
                  peak_memory_bytes=peak, launches=launches, tta=tta,
                  tta_ms_per_item=1e3 / tta["cropped-4k"]["steady_fps"],
                  gpu=gpu))
        if not (staged == {"Tango": 11}
                and all(v["n"] == 5 and math.isfinite(v["psnr"])
                        and v["steady_fps"] > 0 for v in xiph.values())
                and tta["cropped-4k"]["n"] == 3
                and tta["cropped-4k"]["steady_fps"] > 0):
            raise AssertionError(f"xiph: staged {staged}, {xiph}, {tta}")

        # SNU-FILM: three 720x1280 triplets (padded to 768x1280) from 5
        # frames, the same in each of the four splits
        os.makedirs(os.path.join(d, "snu", "f"))
        for i, f in enumerate(smooth_stream(torch, 5, 720, 1280, seed=32)):
            images.write_image(os.path.join(d, "snu", "f", f"{i}.png"), f)
        for split in harness.SNU_SPLITS:
            with open(os.path.join(d, "snu", f"test-{split}.txt"), "w") as fh:
                fh.writelines(f"f/{i}.png f/{i + 1}.png f/{i + 2}.png\n"
                              for i in range(3))
        snu, launches = eval_counted(torch, counters, "snufilm", lambda: (
            harness.run_snufilm(pipe, os.path.join(d, "snu"))))
        emit(dict(phase="eval", protocol="snufilm", model="base",
                  dtype="bf16", global_motion=True, size=[720, 1280],
                  padded=[768, 1280], results=snu,
                  steady_forwards={k: v["n"] - 1 for k, v in snu.items()},
                  ms_per_forward={k: 1e3 / v["steady_fps"]
                                  for k, v in snu.items()},
                  launches=launches))
        if not all(v["n"] == 3 and math.isfinite(v["psnr"])
                   and v["steady_fps"] > 0 for v in snu.values()):
            raise AssertionError(f"snufilm: {snu}")

        # DAVIS 4x on 3 frames (480x854, padded to 512x896)
        frames = smooth_stream(torch, 3, 480, 854, seed=33)
        out, launches = eval_counted(torch, counters, "davis", lambda: (
            harness.run_davis_4x(pipe, frames)))
        ok = (len(out) == 9 and all(o.shape == (480, 854, 3) for o in out)
              and (out[4] == frames[1]).all())
        emit(dict(phase="eval", protocol="davis_4x", model="base",
                  dtype="bf16", size=[480, 854], frames_in=3,
                  frames_out=len(out), launches=launches))
        if not ok:
            raise AssertionError("davis 4x: bad output")
        del pipe
        torch.cuda.empty_cache()

        # the checkpoint CLIs' round trip, then the benchmark CLI on it
        ref = InterpolationPipeline(None, "base", torch.bfloat16,
                                    device="cuda")
        f0, f1 = smooth_frames(torch, 1, 256, 448, seed=34)[0]
        before = ref.interpolate(f0, f1)
        src, pt, back = (os.path.join(d, f) for f in ("a.npz", "b.pt",
                                                       "c.npz"))
        convert.save_npz(src, ref.net.state_dict())
        said, printed = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = (export_checkpoint.main([src, pt])
                  or convert_checkpoint.main([pt, back]))
            after = InterpolationPipeline(convert.load_npz(back)[0], "base",
                                          torch.bfloat16,
                                          device="cuda").interpolate(f0, f1)
        with contextlib.redirect_stdout(printed):
            rc = rc or benchmark.main(["--dataset", "vimeo90k", "--path",
                                       fixture, "--ckpt", pt, "--profiling"])
        text = printed.getvalue()
        bench = json.loads(text[text.rindex("\n{") + 1:])
        same = bool((before == after).all())
        emit(dict(phase="eval", protocol="clis", rc=rc,
                  export_round_trip_bit_equal=same, benchmark=bench))
        if rc != 0 or not same or bench["n"] != 10 or not (
                abs(bench["psnr"] - res["bf16 card"]["psnr"]) <= 0.05):
            raise AssertionError(f"CLIs: rc {rc}, round trip bit-equal "
                                 f"{same}, benchmark {bench}")
    return res


def spatial_per_frame(n: int) -> dict:
    """Launches per frame of the deep row-sharded schedule with global
    motion, n shards on one card. Per shard: the front (K5 1, K3 5, K4
    4), the local blocks, head and enhancement (K1 4, K3 2), 2 token
    pre-align + 2 decoder-input row warps, the three decoder stages (K6
    3, K3 6), the scale-0 pre-align and blend (K10 2) and the refinement
    (K5 1, K4 3, K3 7, K6 3); once on the card, the replicated global
    branch (K1 2, K3 2). All K3 launches but each shard's encoder 24->24
    run the wgmma kernel, all K4 launches but those below its channel
    floor (k4_igemm_per_forward), and every K5 and K6 launch."""
    return {"atm_block": 4 * n + 2, "conv3x3": 20 * n + 2,
            "conv3x3_wgmma": 19 * n + 2, "conv3x3_s2": 7 * n,
            "conv3x3_s2_wgmma": (7 - k4_igemm_per_forward()) * n,
            "conv3x3_multi": 2 * n, "conv3x3_multi_wgmma": 2 * n,
            "deconv2x": 6 * n, "deconv2x_wgmma": 6 * n,
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
            b_ms, b_by, nbytes, _ = counted_bound(
                "K10 warp_pair_srcfull", f"{n} shards, shard {i}", run,
                nbytes, 2 * h * W * (7 * 3 + 14), "f32")
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
        b_ms, b_by, nbytes, _ = counted_bound(
            "flow_warp_rows", site, run, nbytes, h * 240 * (7 * 384 + 14),
            "f32")
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
    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.parallel import make_mesh

    counters = wrapper_counters()
    mesh = make_mesh((1, n), ["cuda:0"] * n)
    pipe = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, mesh=mesh)
    mono = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, device="cuda")
    pairs = smooth_frames(torch, frames + 1, 1080, 1920, seed=7)
    pipe.interpolate(*pairs[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    outs = [pipe.interpolate(f0, f1) for f0, f1 in pairs[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    for o in outs:
        if o.shape != (1080, 1920, 3) or o.dtype.name != "uint8":
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
    check_launches(f"spatial n={n}", launches, spatial_per_frame(n), frames)
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


# narrow lite widths of the gradient check (the port tests' NARROW)
NARROW = dict(hidden_dims=(8, 16, 16, 32), last_feat_extra=16,
              global_mlp_hidden=64, refine_hidden=16)


def grad_cases(torch):
    """(wrapper name, wrapper, its plain version, arguments, limit) of
    every kernel wrapper at a small shape on the card; the floating
    arguments that require grad are the ones differentiated."""
    from atmvfi_tpu_torch import ops
    from atmvfi_tpu_torch.ops import attention as attn_plain
    from atmvfi_tpu_torch.ops import attention_cuda, conv_cuda, deconv_cuda
    from atmvfi_tpu_torch.ops import conv as conv_plain
    from atmvfi_tpu_torch.ops import warp as warp_plain
    from atmvfi_tpu_torch.ops import warp_cuda

    g = torch.Generator(device="cuda").manual_seed(10)

    def t(*shape, scale=1.0, grad=True, dtype=torch.float32):
        x = torch.randn(*shape, generator=g, device="cuda") * scale
        return x.to(dtype).requires_grad_(grad)

    def flow(B, H, W):
        return edge_flow(torch, g, B, H, W, 3.0).requires_grad_(True)

    def conv1(x, w, b, a, stride=1):
        return conv_plain.conv3x3([x], w, b, a, stride)

    rel = ops.relative_coords(8, "cuda")
    mask = ops.attn_mask_for(16, 16, 8, 4, "cuda")  # 4 windows, shifted
    C, h = 64, 8
    bf16 = torch.bfloat16
    return [
        ("flow_warp", warp_cuda.flow_warp, warp_plain.flow_warp,
         (t(1, 16, 24, 40), flow(1, 16, 24)), 1e-5),
        ("flow_warp_pair", warp_cuda.flow_warp_pair,
         lambda a, b, f0, f1: (warp_plain.flow_warp(a, f0),
                               warp_plain.flow_warp(b, f1)),
         (t(1, 16, 24, 3), t(1, 16, 24, 3), flow(1, 16, 24),
          flow(1, 16, 24)), 1e-5),
        ("flow_warp_blend", warp_cuda.flow_warp_blend,
         warp_plain.flow_warp_blend,
         (t(1, 16, 24, 3), t(1, 16, 24, 3), flow(1, 16, 24),
          flow(1, 16, 24), torch.rand(1, 16, 24, 1, generator=g,
                                      device="cuda").requires_grad_(True)),
         1e-5),
        ("warp_pair_srcfull", warp_cuda.warp_pair_srcfull,
         warp_plain.warp_pair_srcfull,
         (t(1, 32, 24, 3), t(1, 32, 24, 3), flow(1, 12, 24),
          flow(1, 12, 24), 10), 1e-5),
        ("flow_warp_rows", warp_cuda.flow_warp_rows,
         warp_plain.flow_warp_rows,
         (t(2, 20, 24, 16), flow(2, 8, 24), 5), 1e-5),
        ("conv3x3", conv_cuda.conv3x3, conv1,
         (t(1, 12, 20, 24), t(16, 24, 3, 3, scale=0.1), t(16, scale=0.1),
          t(16, scale=0.3)), 1e-5),
        # the wgmma route: bf16 (plain VJP in bf16; one bf16 step)
        ("conv3x3 (wgmma, bf16)", conv_cuda.conv3x3, conv1,
         (t(1, 16, 32, 64, dtype=bf16), t(72, 64, 3, 3, scale=0.05),
          t(72, scale=0.1), t(72, scale=0.3)), 1e-2),
        ("conv3x3_s2", conv_cuda.conv3x3_s2,
         lambda x, w, b, a: conv1(x, w, b, a, 2),
         (t(1, 12, 20, 24), t(16, 24, 3, 3, scale=0.1), t(16, scale=0.1),
          t(16, scale=0.3)), 1e-5),
        ("conv3x3_s2 (wgmma, bf16)", conv_cuda.conv3x3_s2,
         lambda x, w, b, a: conv1(x, w, b, a, 2),
         (t(1, 16, 32, 64, dtype=bf16), t(72, 64, 3, 3, scale=0.05),
          t(72, scale=0.1), t(72, scale=0.3)), 1e-2),
        ("conv3x3_multi", conv_cuda.conv3x3_multi,
         lambda s, w, b, a: conv_plain.conv3x3(s, w, b, a, 1),
         ([t(1, 12, 20, 16), t(1, 12, 20, 3, grad=False)],
          t(8, 19, 3, 3, scale=0.1), t(8, scale=0.1), t(8, scale=0.3)),
         1e-5),
        ("conv3x3_pair", conv_cuda.conv3x3_pair, conv_plain.conv3x3_pair,
         (t(1, 12, 20, 16), t(16, 16, 3, 3, scale=0.1), t(16, scale=0.1),
          t(16, scale=0.3), t(8, 16, 3, 3, scale=0.1), t(8, scale=0.1),
          None), 1e-5),
        # K5's wgmma route: a bf16 map and an f32 image, bf16
        ("conv3x3_multi (wgmma, bf16)", conv_cuda.conv3x3_multi,
         lambda s, w, b, a: conv_plain.conv3x3(s, w, b, a, 1),
         ([t(1, 12, 32, 40, dtype=bf16), t(1, 12, 32, 3, grad=False)],
          t(16, 43, 3, 3, scale=0.05), t(16, scale=0.1), t(16, scale=0.3)),
         1e-2),
        ("deconv2x", deconv_cuda.deconv2x, conv_plain.deconv2x,
         (t(1, 8, 12, 16), t(16, 8, 2, 2, scale=0.1), t(8, scale=0.1),
          t(8, scale=0.3)), 1e-5),
        ("deconv2x (wgmma, bf16)", deconv_cuda.deconv2x, conv_plain.deconv2x,
         (t(1, 8, 12, 40, dtype=bf16), t(40, 20, 2, 2, scale=0.1),
          t(20, scale=0.1), t(20, scale=0.3)), 1e-2),
        ("atm_block", attention_cuda.atm_block,
         attn_plain.atm_block_reference,
         (t(4, 64, C), t(C, C, scale=0.05), t(2 * C, C, scale=0.05),
          t(C, C, scale=0.05), t(C, scale=0.05), t(C, scale=0.1) + 1,
          t(C, scale=0.1), (C // h) ** -0.5, rel, mask, h, True), 1e-5),
        # the wgmma GEMM launches: bf16
        ("atm_block (wgmma, bf16)", attention_cuda.atm_block,
         attn_plain.atm_block_reference,
         (t(4, 64, C, dtype=bf16), t(C, C, scale=0.05),
          t(2 * C, C, scale=0.05), t(C, C, scale=0.05), t(C, scale=0.05),
          t(C, scale=0.1) + 1, t(C, scale=0.1), (C // h) ** -0.5, rel, mask,
          h, True), 1e-2),
        ("window_attention", attention_cuda.window_attention,
         attn_plain.window_attention,
         (t(4, 64, C), t(4, 64, 2 * C), (C // h) ** -0.5, rel, mask, h),
         1e-5),
        ("window_attention_heads", attention_cuda.window_attention_heads,
         attn_plain.window_attention_heads,
         (t(4, h, 64, 8), t(4, h, 64, 8), t(4, h, 64, 8), 8 ** -0.5, rel,
          None), 1e-5),
    ]


def phase_gradients(torch):
    """With grad enabled on the card: every kernel wrapper's output has a
    grad_fn and its gradients match autograd through its plain version;
    the narrow lite network's parameter gradients match the CPU port's."""
    import dataclasses

    from atmvfi_tpu_torch.models import Network, get_config
    from atmvfi_tpu_torch.ops import conv_cuda

    torch.backends.cudnn.deterministic = True  # repeatable conv VJPs
    for case in grad_cases(torch):
        check_grad_case(torch, *case, "gradients")
    torch.backends.cudnn.deterministic = False

    H, W = 64, 96
    f0, f1 = smooth_frames(torch, 1, H, W, seed=11)[0]
    ims = [torch.from_numpy(f).float()[None] / 255.0 for f in (f0, f1)]
    wts = torch.rand(1, H, W, 3, generator=torch.Generator().manual_seed(12))
    net = Network(dataclasses.replace(get_config("lite"), **NARROW))

    def param_grads(dev):
        n = net.to(dev)
        n.zero_grad(set_to_none=True)
        out = n(*(i.to(dev) for i in ims), global_motion=True)["I_t"]
        (out * wts.to(dev)).mean().backward()
        return {k: None if p.grad is None else p.grad.detach().cpu()
                for k, p in n.named_parameters()}

    cpu = param_grads("cpu")
    k3 = conv_cuda.conv3x3
    before = k3.launches
    gpu = param_grads("cuda")
    missing = sorted(k for k, v in gpu.items() if v is None)
    worst, worst_name = 0.0, None
    for k, v in gpu.items():
        if v is None or cpu[k] is None:
            continue
        e = ((v - cpu[k]).abs().max() / cpu[k].abs().max().clamp_min(1e-30)
             ).item()
        if e > worst:
            worst, worst_name = e, k
    emit(dict(phase="gradients", model="lite narrow", size=[H, W],
              dtype="f32", parameters=len(gpu), without_gradient=missing,
              k3_launches=k3.launches - before,
              max_rel_abs_err=worst, worst_parameter=worst_name,
              tolerance=1e-3))
    if missing or any(v is None for v in cpu.values()):
        raise AssertionError(f"gradients: parameters without a gradient on "
                             f"the card: {missing}")
    if not worst <= 1e-3:
        raise AssertionError(f"gradients: {worst_name}: max |d| {worst} > "
                             "1e-3 x max |g|")


# ---- phase 13: training ----------------------------------------------
# the kernel wrappers a training forward must launch (K1-K6 and K2's
# two forms), through the autograd path
TRAIN_WRAPPERS = ("atm_block", "flow_warp_pair", "flow_warp", "conv3x3",
                  "conv3x3_s2", "conv3x3_multi", "deconv2x")
TRAIN_TIMED = 5  # timed steps after 2 warm-up steps


def vimeo_train_tree(root: str, repeat: int) -> str:
    """A Vimeo triplet tree over tests/fixtures/mini_vimeo: its 10
    sequences as the test list and `repeat` times over as the train
    list (the sequences are a symlink)."""
    fixture = os.path.join(HERE, "tests", "fixtures", "mini_vimeo")
    os.symlink(os.path.join(fixture, "sequences"),
               os.path.join(root, "sequences"))
    with open(os.path.join(fixture, "tri_testlist.txt")) as f:
        seqs = [ln for ln in f.read().splitlines() if len(ln) > 1]
    for name, lines in (("tri_testlist.txt", seqs),
                        ("tri_trainlist.txt", seqs * repeat)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def random_vgg_npz(path: str, seed: int = 0) -> str:
    """VGG16 feature weights (HWIO kernels, biases; the layout of the JAX
    package's `export_vgg16_npz`) drawn He-scaled from a seed: real ones
    are not in the repository."""
    import numpy as np

    from atmvfi_tpu_torch.losses.vgg import VGG16_PLAN

    rng = np.random.default_rng(seed)
    arrays, cin = {}, 3
    for p in VGG16_PLAN:
        if p == "M":
            continue
        name, cout = p
        arrays[f"{name}.kernel"] = (np.sqrt(2.0 / (9 * cin)) * rng
                                    .standard_normal((3, 3, cin, cout))
                                    ).astype(np.float32)
        arrays[f"{name}.bias"] = (0.01 * rng.standard_normal(cout)
                                  ).astype(np.float32)
        cin = cout
    np.savez(path, **arrays)
    return path


# bands of a kernel's outputs against its plain version's on the same
# inputs, by the call's working type (bf16 where any operand or output
# is bf16),
# as phase 3 holds them: f32 max |d|, bf16 mean |d|, each over max(1,
# the plain output's max |.| (f32) or mean |.| (bf16)), since training
# activations are not of unit scale
TRAIN_KERNEL_BANDS = {"float32": ("max", 1e-4), "bfloat16": ("mean", 5e-3)}


class _CountFunctions:
    """Counts the kernel calls that went through the autograd Function
    (`ops._autograd`) while active. With check=True each call also runs
    the kernel's plain version on the same card tensors (no grad) and
    keeps the worst error of each plain version against
    TRAIN_KERNEL_BANDS; `verify` prints them and raises on a miss."""

    def __init__(self, torch=None, check: bool = False):
        from atmvfi_tpu_torch.ops import _autograd

        self.cls, self.n, self.torch = _autograd._KernelFunction, 0, torch
        self.check, self.unflatten, self.worst = check, _autograd._unflatten, {}

    def _compare(self, plain, spec, flat, out):
        torch = self.torch
        with torch.no_grad():
            want = plain(*self.unflatten(spec, [t.detach() for t in flat]))
        pairs = [(o, w) for o, w in zip(
            out if isinstance(out, tuple) else (out,),
            want if isinstance(want, tuple) else (want,))
            if isinstance(o, torch.Tensor)]
        dt = ("bfloat16" if any(t.dtype == torch.bfloat16 for t in
                                [*flat, *(o for o, _ in pairs)])
              else "float32")
        stat, band = TRAIN_KERNEL_BANDS[dt]
        for o, w in pairs:
            d = (o.detach().float() - w.float()).abs()
            scale = max(1.0, (w.float().abs().max() if stat == "max"
                              else w.float().abs().mean()).item())
            err = (d.max() if stat == "max" else d.mean()).item() / scale
            rec = self.worst.setdefault(
                f"{plain.__name__} {dt}",
                dict(calls=0, stat=stat, band=band, err=-1.0))
            rec["calls"] += 1
            if not math.isnan(rec["err"]) and not err <= rec["err"]:
                rec.update(err=err, scale=scale, shape=list(o.shape))

    def __enter__(self):
        orig = self.cls.apply

        def apply(kernel, plain, spec, *flat):
            self.n += 1
            out = orig(kernel, plain, spec, *flat)
            if self.check:
                self._compare(plain, spec, flat, out)
            return out

        self.cls.apply = apply
        return self

    def __exit__(self, *exc):
        del self.cls.apply  # the inherited classmethod again

    def verify(self, name: str) -> None:
        emit(dict(phase="train_kernels", run=name, kernel_calls=self.n,
                  plain_versions=self.worst))
        bad = {k: r for k, r in self.worst.items()
               if not r["err"] <= r["band"]}
        if bad or not self.worst:
            raise AssertionError(f"train {name}: kernels against their "
                                 f"plain versions: {bad or 'no call'}")


def port_kernel_names() -> set:
    """The __global__ functions of atmvfi_tpu_torch/csrc."""
    import glob
    import re

    names = set()
    for path in glob.glob(os.path.join(HERE, "atmvfi_tpu_torch", "csrc",
                                       "*.cu*")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                r"\s*)?(?:void\s+)?(\w+)\s*\(", f.read()))
    return names


def profile_step(torch, trainer, batch, median_ms: float) -> dict:
    """One training step under torch.profiler (CPU and CUDA activities),
    its batch already loaded: the union of the device's activity
    intervals (kernels, copies, sets; not the `span` ranges mirrored on
    the device's timeline: the time the card was busy), that union over
    the port's kernels (csrc), cuDNN / cuBLAS (the plain VJPs' convs and
    products), torch's own kernels (elementwise, reductions, AdamW) and
    the rest (copies, sets), the busy share of the profiled step and of
    the timed steps' median, and the 12 device names with the most time.
    Where the trace holds no device activity, device_busy_ms is None
    ("not measured")."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ours = re.compile(r"\b(" + "|".join(sorted(port_kernel_names())) + r")\b")
    library = re.compile(r"xmma|cudnn|cublas|gemm|convolve|wgrad|dgrad|"
                         r"cutlass|nchwToNhwc|nhwcToNchw")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    spans, by_name = {}, {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name in host_names
                or getattr(e, "is_user_annotation", False)):
            continue
        kind = ("port" if ours.search(e.name) else
                "library" if library.search(e.name) else
                "torch" if "at::native" in e.name else "other")
        a, b = e.time_range.start, e.time_range.end
        spans.setdefault(kind, []).append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    if not spans:
        return dict(device_busy_ms=None, profiled_step_ms=wall)

    def union_ms(iv):
        total, end = 0.0, None
        for a, b in sorted(iv):
            if end is None or a > end:
                total, end = total + (b - a), b
            elif b > end:
                total, end = total + (b - end), b
        return total / 1e3

    busy = union_ms([iv for v in spans.values() for iv in v])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(profiled_step_ms=wall, device_busy_ms=busy,
                device_ms={k: union_ms(v) for k, v in spans.items()},
                device_events={k: len(v) for k, v in spans.items()},
                busy_share_of_profiled_step=busy / wall,
                busy_share_of_median_step=busy / median_ms,
                top_device_ms=[[n[:120], t] for n, t in top])


def train_run(torch, name: str, trainer, loader, steps: int,
              warmup: int = 2, per_forward: dict = None,
              profile: bool = False):
    """`warmup` untimed steps, then `steps` timed ones: the host clock
    around each step, ended by torch.cuda.synchronize(), and the loader's
    wait for its batch apart. The first warm-up step holds every kernel
    call's output against its plain version on the same inputs
    (`_CountFunctions`, check=True). Every wrapper's count is set to 0
    just before each timed step and read just after: each of
    TRAIN_WRAPPERS must launch, through the autograd path (and
    per_forward's counts, exactly, where given). Losses must be finite.
    With profile=True one more step runs under torch.profiler
    (`profile_step`)."""
    counters = wrapper_counters()
    it = iter(loader)
    for i in range(warmup):
        with _CountFunctions(torch, check=i == 0) as fc:
            trainer.train_step(*next(it))
        if i == 0:
            fc.verify(name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, waits, losses, launches, functions = [], [], [], None, 0
    span, main_cpu = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        reset_counts(counters)
        c0 = time.thread_time()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
        with _CountFunctions() as fc:
            e0.record()
            metrics = trainer.train_step(*batch)
            e1.record()
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        main_cpu.append((time.thread_time() - c0) * 1e3)
        span.append(e0.elapsed_time(e1))
        got = read_counts(counters)
        waits.append((t1 - t0) * 1e3)
        ms.append((t2 - t1) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
        for k in TRAIN_WRAPPERS:
            if got[k] == 0:
                raise AssertionError(f"train {name}: {k} did not launch")
        if per_forward is not None:
            check_launches(f"train {name}", {k: got[k] for k in
                                             per_forward}, per_forward, 1)
        if fc.n < sum(got[k] for k in TRAIN_WRAPPERS):
            raise AssertionError(f"train {name}: {fc.n} autograd kernel "
                                 "calls, fewer than the launches")
        launches, functions = got, fc.n
        bad = [k for k, v in losses[-1].items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"train {name}: non-finite {bad}")
    trace = (profile_step(torch, trainer, next(it), statistics.median(ms))
             if profile else None)
    it.close()  # the loader's threads stop taking batches
    rec = dict(phase="train", run=name, steps=steps, warmup_steps=warmup,
               ms_per_step_median=statistics.median(ms),
               ms_per_step_min=min(ms), ms_per_step_max=max(ms),
               ms_per_step=ms, loader_wait_ms=waits,
               device_span_ms=span, main_thread_cpu_ms=main_cpu,
               load_average=os.getloadavg()[0],
               loader_wait_ms_median=statistics.median(waits),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               tf32=bool(torch.backends.cudnn.allow_tf32),
               launches_per_step=launches, autograd_kernel_calls=functions,
               losses=losses, profile=trace, gpu=nvidia_smi_line())
    emit(rec)
    return rec


def train_loader(path: str, batch: int, seed: int, decode: bool):
    """Vimeo training batches, 8 loader threads. decode=False reads each
    of the fixture's 10 triplets once and keeps it (the crops and flips
    still run per item), so the steps are timed without the PNG decode
    beside them; decode=True decodes every frame of every item, as
    training over a real dataset does."""
    from atmvfi_tpu_torch.data import DataLoader, VimeoDataset

    import threading

    ds = VimeoDataset("train", path, seed=seed)
    if not decode:
        read, kept, lock = ds._read, {}, threading.Lock()

        def read_once(index):
            seq = ds.meta_data[index]
            with lock:
                if seq not in kept:
                    kept[seq] = read(index)
                return kept[seq]

        ds._read = read_once
    return DataLoader(ds, batch, shuffle=True, num_workers=8, seed=seed)


def phase_train_steps(torch, tree: str, vgg: str):
    """Base, phases 1 (batch 24, global motion off) and 3 (batch 16,
    global motion on) in bf16 and f32, and phase 4's criterion (the VGG
    terms on random weights) in bf16, through `Trainer` on 256x256 crops
    of the fixture's frames, the frames decoded once; then phase 3 in
    bf16 with every frame decoded in the loader's threads while the
    steps run (their decode holds the GIL beside the step)."""
    from atmvfi_tpu_torch.losses import VGGPerceptualLoss
    from atmvfi_tpu_torch.train import Trainer, TrainerConfig, get_phase

    runs = []
    for ph, dt, decode, steps in (("1", torch.bfloat16, False, TRAIN_TIMED),
                                  ("1", torch.float32, False, TRAIN_TIMED),
                                  ("3", torch.bfloat16, False, TRAIN_TIMED),
                                  ("3", torch.float32, False, TRAIN_TIMED),
                                  ("4", torch.bfloat16, False, 3),
                                  ("3", torch.bfloat16, True, 6)):
        phase = get_phase(ph)
        loader = train_loader(tree, phase.batch_size, int(ph), decode)
        vgg_loss = VGGPerceptualLoss(vgg) if ph == "4" else None
        trainer = Trainer(TrainerConfig(
            phase, variant="base", dtype=dt, steps_per_epoch=len(loader),
            device="cuda", seed=5), perceptual_loss=vgg_loss)
        name = (f"phase{ph} {str(dt).split('.')[-1]} batch "
                f"{phase.batch_size}{', PNG decode' if decode else ''}")
        rec = train_run(torch, name, trainer, loader, steps,
                        per_forward=None if ph == "1" else PER_FORWARD,
                        profile=ph == "3" and dt == torch.bfloat16)
        if ph == "4" and "perceptual_loss" not in rec["losses"][0]:
            raise AssertionError("train phase 4: no VGG terms")
        runs.append(rec)
        del trainer, loader
        torch.cuda.empty_cache()
    return runs


def phase_train_cli(torch, tree: str):
    """`python -m atmvfi_tpu_torch.cli.train` (its `main`, in this
    process, so its launches and memory are read): base phase 1 at batch
    24 on 256x256 crops, f32, 3 steps (2 loader threads), validation on
    the fixture's test list, the epoch's .npz."""
    from atmvfi_tpu_torch.cli import train as train_cli
    from atmvfi_tpu_torch.convert import load_npz

    ckpt = os.path.join(tree, "ckpt")
    counters = wrapper_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    try:
        rc = train_cli.main([
            "--phase", "1", "--variant", "base", "--vimeo_path", tree,
            "--batch_size", "24", "--num_epoch", "1", "--debug",
            "--debug_iter", "3", "--num_workers", "2",
            "--model_checkpoints", ckpt, "--device", "cuda"])
    except torch.cuda.OutOfMemoryError:
        emit(dict(phase="train_cli", error="out of memory at batch 24",
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9))
        raise
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    names = os.listdir(ckpt)
    if rc != 0 or len(names) != 1:
        raise AssertionError(f"train CLI: rc {rc}, checkpoints {names}")
    sd, meta = load_npz(os.path.join(ckpt, names[0]))
    bad = [k for k, v in meta["train_metric"].items()
           if not math.isfinite(v)]
    if bad or not all(torch.isfinite(v).all() for v in sd.values()):
        raise AssertionError(f"train CLI: non-finite {bad or 'weights'}")
    for k in TRAIN_WRAPPERS:
        if launches[k] == 0:
            raise AssertionError(f"train CLI: {k} did not launch")
    emit(dict(phase="train_cli", model="base", train_phase="phase1_local",
              batch=24, crop=256, dtype="f32", steps=3, seconds=dt,
              checkpoint=names[0], meta=meta, launches=launches,
              peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
              gpu=nvidia_smi_line()))


def train_grad_cases_bf16(torch):
    """(name, wrapper, plain version, arguments) of every kernel wrapper
    in bf16 at a small shape: the working type of the towers in a bf16
    training step (the K3-K6 and K1 wgmma routes are phase 10's)."""
    from atmvfi_tpu_torch import ops
    from atmvfi_tpu_torch.ops import attention as attn_plain
    from atmvfi_tpu_torch.ops import attention_cuda, conv_cuda, deconv_cuda
    from atmvfi_tpu_torch.ops import conv as conv_plain
    from atmvfi_tpu_torch.ops import warp as warp_plain
    from atmvfi_tpu_torch.ops import warp_cuda

    g = torch.Generator(device="cuda").manual_seed(13)
    bf16 = torch.bfloat16

    def t(*shape, scale=1.0, dtype=bf16, grad=True):
        x = torch.randn(*shape, generator=g, device="cuda") * scale
        return x.to(dtype).requires_grad_(grad)

    def w(*shape, scale=0.1):
        return t(*shape, scale=scale, dtype=torch.float32)

    def flow(B, H, W):
        return edge_flow(torch, g, B, H, W, 3.0).requires_grad_(True)

    def conv1(x, wt, b, a, stride=1):
        return conv_plain.conv3x3([x], wt, b, a, stride)

    rel = ops.relative_coords(8, "cuda")
    mask = ops.attn_mask_for(16, 16, 8, 4, "cuda")
    C, h = 64, 8
    return [
        ("flow_warp", warp_cuda.flow_warp, warp_plain.flow_warp,
         (t(1, 16, 24, 40), flow(1, 16, 24))),
        ("flow_warp_rows", warp_cuda.flow_warp_rows,
         warp_plain.flow_warp_rows, (t(2, 20, 24, 16), flow(2, 8, 24), 5)),
        ("conv3x3 (igemm, bf16)", conv_cuda.conv3x3, conv1,
         (t(1, 12, 20, 24), w(16, 24, 3, 3), w(16), w(16, scale=0.3))),
        ("conv3x3_s2 (igemm, bf16)", conv_cuda.conv3x3_s2,
         lambda x, wt, b, a: conv1(x, wt, b, a, 2),
         (t(1, 12, 20, 24), w(16, 24, 3, 3), w(16), w(16, scale=0.3))),
        ("conv3x3_multi (igemm, bf16)", conv_cuda.conv3x3_multi,
         lambda s, wt, b, a: conv_plain.conv3x3(s, wt, b, a, 1),
         ([t(1, 12, 20, 16), t(1, 12, 20, 3, dtype=torch.float32,
                                grad=False)],
          w(8, 19, 3, 3), w(8), w(8, scale=0.3))),
        ("conv3x3_pair", conv_cuda.conv3x3_pair, conv_plain.conv3x3_pair,
         (t(1, 12, 20, 16), w(16, 16, 3, 3), w(16), w(16, scale=0.3),
          w(8, 16, 3, 3), w(8), None)),
        ("deconv2x (igemm, bf16)", deconv_cuda.deconv2x, conv_plain.deconv2x,
         (t(1, 8, 12, 16), w(16, 8, 2, 2), w(8), w(8, scale=0.3))),
        ("window_attention", attention_cuda.window_attention,
         attn_plain.window_attention,
         (t(4, 64, C), t(4, 64, 2 * C), (C // h) ** -0.5, rel, mask, h)),
        ("window_attention_heads", attention_cuda.window_attention_heads,
         attn_plain.window_attention_heads,
         (t(4, h, 64, 8), t(4, h, 64, 8), t(4, h, 64, 8), 8 ** -0.5, rel,
          None)),
    ]


def check_grad_case(torch, name, fn, plain, args, lim, phase):
    """fn's gradients (kernel forward, plain VJP) against autograd
    through `plain`, with the same cotangents: max |d| <= lim x the
    gradient's max |g|."""
    leaves = [a for a in args if isinstance(a, torch.Tensor)
              and a.requires_grad]
    leaves += [s for a in args if isinstance(a, list) for s in a
               if s.requires_grad]

    def grads(f):
        outs = f(*args)
        outs = [o for o in (outs if isinstance(outs, tuple) else (outs,))
                if o is not None]
        g = torch.Generator(device="cuda").manual_seed(11)
        cts = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
               for o in outs]
        return outs, torch.autograd.grad(outs, leaves, cts)

    outs, got = grads(fn)
    _, want = grads(plain)
    if any(o.grad_fn is None for o in outs):
        raise AssertionError(f"{phase}: {name}: an output has no grad_fn")
    err = max((a.float() - b.float()).abs().max().item()
              / max(b.float().abs().max().item(), 1e-30)
              for a, b in zip(got, want))
    emit(dict(phase=phase, wrapper=name, inputs=len(leaves),
              dtype=str(outs[0].dtype).split(".")[-1],
              max_rel_abs_err=err, tolerance=lim))
    if not err <= lim:
        raise AssertionError(f"{phase}: {name}: max relative |d| {err} > "
                             f"{lim}")


def phase_train_agreement(torch, vgg: str):
    """f32, TF32 off: the narrow lite network at 64x96, batch 2, phase 3
    with every switch of the criterion on (the VGG terms on random
    weights): loss terms (<= 1e-4 relative) and every parameter gradient
    (<= 1e-3 x its max |g|) on the card against the CPU port; then every
    kernel wrapper's bf16 gradients against its plain version's (<= 1e-2
    x max |g|, as phase 10's bf16 routes)."""
    import dataclasses

    from atmvfi_tpu_torch.losses import VGGPerceptualLoss
    from atmvfi_tpu_torch.models import Network, get_config
    from atmvfi_tpu_torch.train import PHASE3, make_criterion

    phase = dataclasses.replace(
        PHASE3, use_l1_loss=True, use_bidirect_warp_loss=True,
        use_sobel_loss=True, use_perceptual_loss=True, use_style_loss=True)
    H, W = 64, 96
    pairs = smooth_frames(torch, 2, H, W, seed=21)
    im0, im1 = (torch.stack([torch.from_numpy(p[i]) for p in pairs]).float()
                / 255.0 for i in (0, 1))
    gt = (0.5 * (im0 + im1)).clamp(0, 1)
    net = Network(dataclasses.replace(get_config("lite"), **NARROW),
                  torch.Generator().manual_seed(21))
    vgg_loss = VGGPerceptualLoss(vgg)
    crit = make_criterion(phase, vgg_loss)

    def step(dev):
        n = net.to(dev)
        vgg_loss.to(dev)
        n.zero_grad(set_to_none=True)
        out = n(im0.to(dev), im1.to(dev), global_motion=True)
        loss, ld = crit(out, gt.to(dev))
        loss.backward()
        return ({"loss": loss.item(),
                 **{k: v.item() for k, v in ld.items()}},
                {k: p.grad.detach().cpu() for k, p in n.named_parameters()
                 if p.grad is not None})

    cpu_l, cpu_g = step("cpu")
    counters = wrapper_counters()
    reset_counts(counters)
    gpu_l, gpu_g = step("cuda")
    launches = read_counts(counters)
    loss_err = max(abs(gpu_l[k] - cpu_l[k]) / abs(cpu_l[k]) for k in cpu_l)
    worst, worst_name = 0.0, None
    for k, v in cpu_g.items():
        e = ((gpu_g[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)
             ).item()
        if e > worst:
            worst, worst_name = e, k
    emit(dict(phase="train_agreement", model="lite narrow", size=[H, W],
              batch=2, dtype="f32", tf32=False, terms=sorted(cpu_l),
              loss_card=gpu_l, loss_cpu=cpu_l, max_rel_loss_err=loss_err,
              parameters=len(cpu_g), max_rel_grad_err=worst,
              worst_parameter=worst_name, launches=launches,
              tolerance=dict(loss=1e-4, grad=1e-3)))
    if set(gpu_g) != set(cpu_g) or len(cpu_l) != 8:
        raise AssertionError("train agreement: terms or gradients differ "
                             f"({sorted(cpu_l)})")
    if not (loss_err <= 1e-4 and worst <= 1e-3):
        raise AssertionError(f"train agreement: loss {loss_err} > 1e-4 or "
                             f"{worst_name} {worst} > 1e-3")
    for k in TRAIN_WRAPPERS:
        if launches[k] == 0:
            raise AssertionError(f"train agreement: {k} did not launch")
    torch.backends.cudnn.deterministic = True  # repeatable conv VJPs
    for case in train_grad_cases_bf16(torch):
        check_grad_case(torch, *case, 1e-2, "train_grad_bf16")
    torch.backends.cudnn.deterministic = False


def phase_train_packs(torch, tree: str):
    """No stale weight pack: the K3 (wgmma, bf16) and K1 (bf16) forwards
    of a lite layer after a training step (foreach and fused AdamW, a
    learning rate that moves the bf16 weights) equal their plain versions
    on the updated weights (K3 mean |d| <= 1e-3, K1 <= 5e-3) and differ
    from the pre-step output; after `restore_train_state` they equal the
    pre-step outputs bit for bit. The trainer runs two 'data' shards on
    the card, and each replica's layers are checked: the home one, which
    the optimizer updates, and the other, which copies its weights."""
    import dataclasses

    from atmvfi_tpu_torch import ops
    from atmvfi_tpu_torch.ops import attention as attn_plain
    from atmvfi_tpu_torch.ops import attention_cuda
    from atmvfi_tpu_torch.ops import conv as conv_plain
    from atmvfi_tpu_torch.parallel import make_mesh
    from atmvfi_tpu_torch.train import PHASE3, Trainer, TrainerConfig
    from atmvfi_tpu_torch.train.checkpoints import (
        restore_train_state,
        save_train_state,
    )

    g = torch.Generator(device="cuda").manual_seed(31)
    x3 = torch.randn(2, 32, 48, 32, generator=g, device="cuda").to(
        torch.bfloat16)
    x1 = torch.randn(4, 64, 224, generator=g, device="cuda").to(
        torch.bfloat16)
    rel = ops.relative_coords(8, "cuda")
    phase = dataclasses.replace(PHASE3, init_lr=1e-2, warmup_steps=1)
    pairs = smooth_frames(torch, 2, 64, 96, seed=32)
    im0, im1 = (torch.stack([torch.from_numpy(p[i]) for p in pairs]).float()
                / 255.0 for i in (0, 1))
    batch = (im0, (0.5 * (im0 + im1)), im1)

    def k3(net):
        conv = net.feat_extracts[1][1]  # 32 -> 32: K3 on wgmma
        with torch.no_grad():
            return conv(x3), conv_plain.conv3x3(
                [x3], conv[0].weight, conv[0].bias, conv[1].weight, 1)

    def k1(net):
        blk = net.local_motion_atmformer[0]  # C 224, 8 heads: K1
        a, n = blk.attn, blk.norm1
        args = (x1, a.q.weight, a.kv.weight, a.proj.weight, a.proj.bias,
                n.weight, n.bias, 28 ** -0.5, rel, None, 8, True)
        with torch.no_grad():
            return (attention_cuda.atm_block(*args)[0],
                    attn_plain.atm_block_reference(*args)[0])

    for impl in ("foreach", "fused"):
        tr = Trainer(TrainerConfig(phase, variant="lite",
                                   dtype=torch.bfloat16, device="cuda",
                                   steps_per_epoch=4, seed=33),
                     mesh=make_mesh((2, 1), ["cuda:0", "cuda:0"]))
        tr.optimizer = torch.optim.AdamW(
            tr.trainable, weight_decay=phase.weight_decay, **{impl: True})
        ckpt = os.path.join(tree, f"state_{impl}")
        save_train_state(ckpt, tr.state_dict(), 0)
        before = [{"K3": k3(r), "K1": k1(r)} for r in tr.replicas]
        before_w = [r.feat_extracts[1][1][0].weight.detach().clone()
                    for r in tr.replicas]
        tr.train_step(*batch)
        for i, r in enumerate(tr.replicas):
            if torch.equal(before_w[i], r.feat_extracts[1][1][0].weight):
                raise AssertionError(f"packs {impl}: replica {i}: the step "
                                     "moved no weight")
        after = [{"K3": k3(r), "K1": k1(r)} for r in tr.replicas]
        restore_train_state(ckpt, 0, tr)
        restored = [{"K3": k3(r), "K1": k1(r)} for r in tr.replicas]
        for i in range(len(tr.replicas)):
            rec = dict(phase="train_packs", adamw=impl, replica=i,
                       shards=len(tr.replicas))
            for k, band in (("K3", 1e-3), ("K1", 5e-3)):
                (y0, p0), (y1, p1), (y2, p2) = (before[i][k], after[i][k],
                                                restored[i][k])
                err = (y1.float() - p1.float()).abs().mean().item()
                moved = (p1.float() - p0.float()).abs().mean().item()
                stale = (y1.float() - y0.float()).abs().mean().item()
                rec[k] = dict(mean_abs_err_after_step=err, band=band,
                              plain_moved_by=moved, kernel_moved_by=stale,
                              restored_bit_equal=bool(torch.equal(y2, y0)),
                              restored_err=(y2.float() - p2.float()).abs()
                              .mean().item())
                # a stale pack (the old weights' output) would break the
                # band
                if not (err <= band and moved > 2 * band
                        and stale > 2 * band and torch.equal(y2, y0)
                        and rec[k]["restored_err"] <= band):
                    emit(rec)
                    raise AssertionError(f"packs {impl}: replica {i}: {k}: "
                                         f"{rec[k]}")
            emit(rec)
        del tr
        torch.cuda.empty_cache()


# bands of a data-parallel step against one device from the same
# weights: the metrics (relative), and each trainable parameter's first
# moment after the step (0.1 x the reduced gradient) over its max |.|,
# the worst tensor's and the median. Two references. "accum": one device
# taking the batch as two micro-steps of the shards' rows (grad_accum 2:
# the same per-sample forwards, the mean of the two gradients), which
# only the card's atomics and the order of the sums set apart. "full":
# one device taking the whole batch at once. The card's libraries pick
# other algorithms for 16 samples than for 8, and the warps' cell
# crossings and the L1 terms' signs amplify those last-bit differences
# in a few tensors; in bf16 each shard's weight gradient is moreover a
# bf16 product, rounded before the two meet (as the partial sums of
# JAX's partitioned product are before its all-reduce) where one device
# rounds the whole sum once. Measured on an H100 80GB HBM3 at 700 W over
# 18 loader batches: f32 accum worst <= 2.1e-6, full worst 5.6e-5 to
# 4.4e-4 with medians <= 6.6e-7; bf16 accum worst 5.0e-3 to 1.06e-2
# (medians <= 6.3e-4; one device against itself: worst 6.8e-3), full
# worst up to 6.3e-2 with medians 2.5e-3 to 3.5e-3 (2^-8), and the
# metrics up to 4.2e-6 apart (f32 1.3e-7). So the worst tensor against
# the whole batch is printed and its median gated, and the metrics are
# held to 1e-5 against the micro-steps' mean. A card shard beside a CPU
# shard: the card-vs-CPU band of the agreement.
DP_BANDS = {
    "bfloat16": dict(accum_metric=1e-5, metric=1e-4, accum=5e-2,
                     accum_median=2e-3, full_median=1e-2),
    "float32": dict(accum_metric=1e-5, metric=1e-5, accum=1e-4,
                    full_median=1e-5),
    "cuda+cpu": dict(metric=1e-4, full=1e-3)}


DP_BATCHES = 3  # batches of (a)'s comparison, each from the same weights

# the port's code that runs inside the trainer's shard loop
FORWARD_CODE = tuple(f"atmvfi_tpu_torch/{d}/" for d in ("ops", "models",
                                                         "losses"))


def moment_errs(one, other) -> dict:
    """{name: max |first moment of other - one's| / max |one's|} over the
    trainable parameters of two trainers after a step each."""
    errs = {}
    names = [n for n, p in one.net.named_parameters() if p.requires_grad]
    for n, p, q in zip(names, one.trainable, other.trainable):
        a = one.optimizer.state[p]["exp_avg"]
        b = other.optimizer.state[q]["exp_avg"].to(a.device)
        errs[n] = ((b - a).abs().max() / a.abs().max().clamp_min(1e-30)
                   ).item()
    return errs


def dp_step_agreement(torch, name: str, one, two, batch, check: bool,
                      accum=None) -> dict:
    """One training step of the one-device trainer `one` and the mesh
    trainer `two` (same weights) on the same batch; every wrapper's count
    set to 0 just before each step and read just after. With check=True
    the mesh step holds every kernel call against its plain version
    (`_CountFunctions`). Returns the metrics' worst relative difference,
    the first moments' worst and median difference over each tensor's
    max ("full"), and the launches of each step; with `accum` (a
    one-device trainer from the same weights with grad_accum 2), the
    same against it after it took the two shards' rows as two
    micro-steps ("accum"; its metrics: the two micro-steps' mean)."""
    counters = wrapper_counters()
    reset_counts(counters)
    m1 = one.train_step(*batch)
    torch.cuda.synchronize()
    launches_one = read_counts(counters)
    reset_counts(counters)
    with _CountFunctions(torch, check=check) as fc:
        m2 = two.train_step(*batch)
        torch.cuda.synchronize()
    launches_two = read_counts(counters)
    if check:
        fc.verify(f"{name}, first step")
    errs = moment_errs(one, two)
    worst = max(errs, key=errs.get)
    rec = dict(metrics_one_device={k: float(v) for k, v in m1.items()},
               metrics_mesh={k: float(v) for k, v in m2.items()},
               metric=max(abs(float(m2[k]) / float(m1[k]) - 1) for k in m1),
               full=errs[worst], full_median=statistics.median(errs.values()),
               full_worst_parameter=worst, parameters=len(errs),
               launches_one_device=launches_one, launches_mesh=launches_two)
    if accum is not None:
        rows = len(batch[0]) // 2
        ma = [accum.train_step(*(x[half] for x in batch))
              for half in (slice(0, rows), slice(rows, None))]
        errs = moment_errs(accum, two)
        worst = max(errs, key=errs.get)
        rec.update(accum_metric=max(
            abs(2 * float(m2[k]) / (float(ma[0][k]) + float(ma[1][k])) - 1)
            for k in m2),
                   accum=errs[worst],
                   accum_median=statistics.median(errs.values()),
                   accum_worst_parameter=worst)
    return rec


def host_syncs(torch, fn) -> dict:
    """The synchronising CUDA calls fn() makes (torch's sync debug mode,
    "warn"), counted by the line of Python that made each (its file,
    number and code)."""
    import linecache
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            k = (f"{os.path.relpath(w.filename, HERE)}:{w.lineno} "
                 f"{linecache.getline(w.filename, w.lineno).strip()}")
            sites[k] = sites.get(k, 0) + 1
    return sites


def replicas_bit_equal(torch, trainer) -> bool:
    return all(torch.equal(p, q.to(p.device)) for r in trainer.replicas[1:]
               for p, q in zip(trainer.net.parameters(), r.parameters()))


def phase_train_dp(torch, tree: str, runs):
    """Data-parallel training (`Trainer(mesh=...)`), base phase 3: (a)
    two 'data' shards on the one card, batch 16 of 256x256 crops, bf16
    and f32: a step against one device from the same weights on the
    same batch, taken whole and as two micro-steps of the shards' rows,
    on each of DP_BATCHES batches (DP_BANDS; every kernel call of the
    first mesh step against its plain version), then `train_run` (2
    warm-up, 5 timed steps: every wrapper's launches exactly twice the
    one-device phase 3 run's), every replica bit-equal to the home one
    after, the
    step time and peak memory beside the one-device run's, and the
    synchronising CUDA calls of one more step by line (`host_syncs`):
    none from the code the shard loop runs (FORWARD_CODE). (b) a card
    shard and a CPU shard (f32, batch 2, 128x128): the shards' gradients
    meet on the card, the CPU replica copies the card's weights; against
    the one-device card trainer. (c) (a) on two distinct cards where
    there are two; else one line says it did not run."""
    import copy
    import dataclasses

    from atmvfi_tpu_torch.parallel import make_mesh
    from atmvfi_tpu_torch.train import Trainer, TrainerConfig, get_phase

    phase = get_phase("3")
    ref = {r["run"]: r for r in runs}
    bad = []

    def config(dtype, devices, steps_per_epoch):
        return TrainerConfig(phase, variant="base", dtype=dtype,
                             steps_per_epoch=steps_per_epoch,
                             device=devices[0], seed=5)

    cases = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() >= 2:
        cases.append(["cuda:0", "cuda:1"])
    else:
        emit(dict(phase="train_dp", run="two distinct cards", ran=False,
                  reason=f"{torch.cuda.device_count()} card visible; (c) "
                  "needs 2"))
    for devices in cases:
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[-1]
            one_dev = ref[f"phase3 {dname} batch {phase.batch_size}"]
            loader = train_loader(tree, phase.batch_size, 3, False)
            it = iter(loader)
            batches = [next(it) for _ in range(DP_BATCHES)]
            it.close()
            cfg = config(dt, devices, len(loader))
            one = Trainer(cfg)
            accum = Trainer(dataclasses.replace(cfg, grad_accum=2))
            two = Trainer(cfg, mesh=make_mesh((2, 1), devices))
            start = copy.deepcopy(one.state_dict())
            name = f"phase3 {dname} batch {phase.batch_size}, 2 shards " \
                   f"on {'+'.join(devices)}"
            per_batch = []
            for i, batch in enumerate(batches):
                if i:  # the same weights and a fresh optimizer again
                    for t in (one, accum, two):
                        t.load_state_dict(start)
                per_batch.append(dp_step_agreement(torch, name, one, two,
                                                   batch, i == 0, accum))
            rec = dict(per_batch[0], batches=[
                {k: v for k, v in r.items()
                 if not k.startswith(("launches", "metrics"))}
                for r in per_batch])
            for k in ("metric", "full", "full_median", "accum_metric",
                      "accum", "accum_median"):
                rec[k] = max(r[k] for r in per_batch)
            del one, accum, start
            torch.cuda.empty_cache()
            run = train_run(torch, name, two, loader, TRAIN_TIMED,
                            per_forward={k: 2 * v for k, v in
                                         one_dev["launches_per_step"].items()})
            band = DP_BANDS[dname]
            rec.update(
                phase="train_dp", run=name, devices=devices, dtype=dname,
                host_syncs_per_step=host_syncs(
                    torch, lambda: two.train_step(*batch)),
                bands=band, updates=two.updates,
                replicas_bit_equal=replicas_bit_equal(torch, two),
                ms_per_step_median=run["ms_per_step_median"],
                one_device_ms_per_step_median=one_dev["ms_per_step_median"],
                peak_memory_gb=run["peak_memory_gb"],
                one_device_peak_memory_gb=one_dev["peak_memory_gb"],
                gpu=nvidia_smi_line())
            emit(rec)
            twice = {k: 2 * v for k, v in rec["launches_one_device"].items()}
            # the forward and the criterion run in the shard loop: a sync
            # there would run distinct cards' shards one after another
            in_loop = [k for k in rec["host_syncs_per_step"]
                       if k.startswith(FORWARD_CODE)]
            if not (not in_loop
                    and all(rec[k] <= band[k] for k in band)
                    and rec["replicas_bit_equal"] and two.updates >= 2
                    and rec["launches_mesh"] == twice):
                bad.append(name)
            del two, loader
            torch.cuda.empty_cache()

    # (b) a card shard beside a CPU shard
    cfg = config(torch.float32, ["cuda:0", "cpu"], 10)
    one, two = Trainer(cfg), Trainer(cfg, mesh=make_mesh((2, 1),
                                                        ["cuda:0", "cpu"]))
    pairs = smooth_frames(torch, 2, 128, 128, seed=41)
    im0, im1 = (torch.stack([torch.from_numpy(p[i]) for p in pairs]).float()
                / 255.0 for i in (0, 1))
    name = "phase3 float32 batch 2 128x128, shards on cuda:0+cpu"
    rec = dp_step_agreement(torch, name, one, two,
                            (im0, 0.5 * (im0 + im1), im1), False)
    band = DP_BANDS["cuda+cpu"]
    rec.update(phase="train_dp", run=name, devices=["cuda:0", "cpu"],
               dtype="float32", bands=band,
               replica_devices=[str(next(r.parameters()).device)
                                for r in two.replicas],
               replicas_bit_equal=replicas_bit_equal(torch, two),
               gpu=nvidia_smi_line())
    emit(rec)
    # the card shard launches one forward's kernels, the CPU shard none
    if not (all(rec[k] <= band[k] for k in band)
            and rec["replicas_bit_equal"]
            and rec["replica_devices"] == ["cuda:0", "cpu"]
            and rec["launches_mesh"] == rec["launches_one_device"]):
        bad.append(name)
    del one, two
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"train_dp: outside the bands or the counts: "
                             f"{bad}")


def phase_train(torch):
    """Phase 13: training on the card (see the module docstring)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="atmvfi_train_")
    try:
        tree = vimeo_train_tree(root, repeat=30)  # 300 items: 18 x 16
        vgg = random_vgg_npz(os.path.join(root, "vgg_random.npz"))
        phase_train_agreement(torch, vgg)
        phase_train_packs(torch, tree)
        phase_train_cli(torch, tree)
        runs = phase_train_steps(torch, tree, vgg)
        phase_train_dp(torch, tree, runs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs


# ---- phase 14: the counted roofline -------------------------------------
ROOFLINE_SIZES = ((1088, 1920), (2176, 3840))
SIM_REPEATS = 7  # timed runs of each deep-shard program (median)


def grid_probe(torch, seed: int = 0):
    """Row P's check of the counter through a kernel grid: the gridded
    matmul [128, 64] @ [64, 64] (its CUDA kernel) against the f64
    product of the same operands, and its count on those card tensors,
    which walks the kernel's grid: 2 * 2 * 64**3 tc FLOPs."""
    from atmvfi_tpu_torch.ops import probe_cuda
    from atmvfi_tpu_torch.utils import roofline

    g = torch.Generator().manual_seed(seed)
    a = torch.randn(128, 64, generator=g)
    b = torch.randn(64, 64, generator=g)
    want = (a.double() @ b.double()).float()
    a, b = a.cuda(), b.cuda()
    with torch.no_grad():
        out = probe_cuda.grid_matmul(a, b).cpu()
    return {"tc_flops": roofline.count_flops(probe_cuda.grid_matmul, a,
                                             b)["tc_flops"],
            "f64_max_abs_err": (out - want).abs().max().item(),
            "scale": want.abs().max().item()}


def phase_roofline(torch):
    """(a) row P's gridded matmul through `grid_probe` (every count
    set to 0 just before, read just after: one grid_matmul launch), its
    count on card tensors, timings and bound; (b) the counted roofline
    beside the hand counts of phases 3, 4 and 7; (c) `model_roofline` of
    base and lite at 1088x1920 and 2176x3840 beside phase 5's ms/frame;
    (d) `profiling.capture` / `summarize` over 3 base 1080p frames; (e)
    the deep-shard simulation at n = 2 and 4. Returns the grid_matmul
    record and its launches."""
    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.ops import probe_cuda
    from atmvfi_tpu_torch.parallel import (
        deep_shard_projection,
        make_deep_shard_sim,
    )
    from atmvfi_tpu_torch.utils import profiling, roofline

    # (a) the probe: the kernel, its count on card tensors
    counters = wrapper_counters()
    reset_counts(counters)
    probe = grid_probe(torch)
    launches = read_counts(counters)
    check_launches("roofline probe", launches, {"grid_matmul": 1}, 1)
    rel = probe["f64_max_abs_err"] / probe["scale"]
    if probe["tc_flops"] != 2 * 2 * 64 * 64 * 64:
        raise AssertionError(f"grid_matmul counted {probe['tc_flops']} tc "
                             "FLOPs on card tensors, not 1048576")
    if not rel <= 1e-5:
        raise AssertionError(f"grid_matmul: max |d| from f64 "
                             f"{probe['f64_max_abs_err']} "
                             f"> 1e-5 x {probe['scale']}")
    g = torch.Generator(device="cuda").manual_seed(11)
    a = torch.randn(128, 64, generator=g, device="cuda")
    b = torch.randn(64, 64, generator=g, device="cuda")
    with torch.no_grad():
        err = (probe_cuda.grid_matmul(a, b)
               - probe_cuda.grid_matmul_plain(a, b)).abs().max().item()
    ms = cuda_ms(lambda: probe_cuda.grid_matmul(a, b), 200)
    plain_ms = cuda_ms(lambda: probe_cuda.grid_matmul_plain(a, b), 200)
    lib_ms = cuda_ms(lambda: torch.matmul(a, b), 200)
    # device time alone (CUDA graph): the host's call time is most of ms
    dev = {"kernel": graph_ms(lambda: probe_cuda.grid_matmul(a, b)),
           "plain": graph_ms(lambda: probe_cuda.grid_matmul_plain(a, b)),
           "library": graph_ms(lambda: torch.matmul(a, b))}
    b_ms, b_by, nbytes, flops = counted_bound(
        "grid_matmul", "[128, 64] @ [64, 64] f32",
        lambda: probe_cuda.grid_matmul(a, b), (2 * 128 * 64 + 64 * 64) * 4,
        2 * 128 * 64 * 64, "f32")
    rec = dict(phase="roofline", part="a", kernel="grid_matmul",
               shape=[[128, 64], [64, 64]], dtype="f32", grid=[2],
               count_on_card_tensors=probe["tc_flops"],
               f64_max_abs_err=probe["f64_max_abs_err"],
               f64_scale=probe["scale"], f64_rel_err=rel, max_abs_err=err,
               ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, library="torch.matmul (f32, TF32 off)",
               graph_ms=dev, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
               per_forward=1, launches=launches["grid_matmul"],
               gpu=nvidia_smi_line())
    emit(rec)
    if not err <= 1e-5 * probe["scale"]:
        raise AssertionError(f"grid_matmul vs plain: max |d| {err}")

    # (b) the tool's count beside the hand counts
    by_kernel = {}
    for row in COUNT_ROWS:
        by_kernel.setdefault(row["kernel"], []).append(row)
    far = lambda r, k: r[k] is not None and abs(r[k] - 1) > 0.1  # noqa
    for k, rows in by_kernel.items():
        emit(dict(
            phase="roofline", part="b", kernel=k, cases=len(rows),
            used=rows[0]["used"],
            bytes_ratio=[min(r["bytes_ratio"] for r in rows),
                         max(r["bytes_ratio"] for r in rows)],
            flops_ratio=[min(r["flops_ratio"] for r in rows),
                         max(r["flops_ratio"] for r in rows)],
            bound_ratio=[min(r["bound_ratio"] for r in rows),
                         max(r["bound_ratio"] for r in rows)],
            over_10pct=[{key: r[key] for key in (
                "case", "tool_bytes", "hand_bytes", "tool_flops",
                "tool_tc_bf16_flops", "tool_tc_f32_flops",
                "tool_simt_flops", "hand_flops", "tool_bound_ms",
                "hand_bound_ms")} for r in rows
                if far(r, "bytes_ratio") or far(r, "flops_ratio")]))
    if not COUNT_ROWS:
        emit(dict(phase="roofline", part="b", note="phases 3, 4 and 7 did "
                  "not run: no hand count to compare"))

    # (c) the model's speed of light beside phase 5's frame time
    measured = MEASURED.get("default")
    for variant in ("base", "lite"):
        for H, W in ROOFLINE_SIZES:
            t0 = time.perf_counter()
            r = roofline.model_roofline(variant, H, W)
            on_path = variant == "base" and (H, W) == (1088, 1920)
            emit(dict(phase="roofline", part="c", model=variant,
                      dtype="bf16", size=[H, W],
                      count_seconds=time.perf_counter() - t0,
                      tc_tflop=r["tc_tflop"], tc_bf16_flops=r["tc_bf16_flops"],
                      tc_f32_flops=r["tc_f32_flops"],
                      simt_tflop=r["simt_tflop"], hbm_gb_min=r["hbm_gb_min"],
                      hbm_gb_io=r["hbm_gb_io"], families=r["families"],
                      wall_tc_ms=r["wall_tc_ms"],
                      wall_simt_ms=r["wall_simt_ms"],
                      wall_hbm_ms=r["wall_hbm_ms"], sol_ms=r["sol_ms"],
                      sol_fps=r["sol_fps"], sol_fps_io=r["sol_fps_io"],
                      bound=r["bound"],
                      measured_ms_per_frame=measured if on_path else None,
                      share_of_sol=(r["sol_ms"] / measured
                                    if on_path and measured else None)))
            if on_path and abs(r["tc_tflop"] - 5.9166) > 1e-3:
                raise AssertionError(f"base 1080p tc {r['tc_tflop']} TFLOP")

    # (d) a device profile of 3 base 1080p frames
    pipe = InterpolationPipeline(None, "base", torch.bfloat16,
                                 global_motion=True, device="cuda")
    x0 = torch.rand(1, 1088, 1920, 3, generator=g, device="cuda")
    x1 = torch.roll(x0, (3, -5), (1, 2))
    for _ in range(2):
        pipe.interpolate_device(x0, x1)
    torch.cuda.synchronize()

    def frames3():  # host clock of the frames, not of the export
        t0 = time.perf_counter()
        for _ in range(3):
            pipe.interpolate_device(x0, x1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 3

    with tempfile.TemporaryDirectory() as trace_dir:
        wall, _ = profiling.capture(frames3, trace_dir=trace_dir)
        summ = profiling.summarize(trace_dir, top=8)
    per = lambda d: {k: v / 3 for k, v in d.items()}  # noqa: E731
    emit(dict(phase="roofline", part="d", model="base", dtype="bf16",
              size=[1088, 1920], frames=3, profiled_wall_ms_per_frame=wall,
              device_busy_ms_per_frame=summ["total_ms"] / 3,
              idle_share=summ["idle_share"],
              families_ms=per(summ["by_category_ms"]),
              stages_ms=per(summ["by_source_ms"]),
              top_kernels=[[k[:120], v["ms"] / 3, v["calls"] / 3]
                           for k, v in summ["by_kernel"].items()],
              gpu=nvidia_smi_line()))
    if not summ["total_ms"] > 0:
        raise AssertionError("the profile holds no device time")

    # (e) one interior shard's deep program at 1080p, n = 2 and 4
    for n in (2, 4):
        sim = make_deep_shard_sim(pipe.net, 1088, 1920, n)
        with torch.inference_mode():
            for _ in range(2):
                out = sim(x0, x1)
            torch.cuda.synchronize()
            times = []
            for _ in range(SIM_REPEATS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = sim(x0, x1)
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
        if (tuple(out.shape) != (1, 1088 // n, 1920, 3)
                or not bool(torch.isfinite(out).all())):
            raise AssertionError(f"deep-shard sim n={n}: bad output "
                                 f"{tuple(out.shape)}")
        proj = deep_shard_projection(statistics.median(times), 1088, 1920, n,
                                     pipe.cfg)
        emit(dict(phase="roofline", part="e", model="base", dtype="bf16",
                  size=[1088, 1920], shards=n, repeats=SIM_REPEATS,
                  shard_ms_median=proj["shard_ms"], shard_ms=times,
                  ici_bytes=proj["ici_bytes"], link_ms=proj["link_ms"],
                  link="NVLink 4, 450 GB/s each way (H100 SXM data sheet)",
                  projected_ms=proj["projected_ms"],
                  projected_fps=proj["projected_fps"],
                  gpu=nvidia_smi_line()))
    del pipe, sim, out
    torch.cuda.empty_cache()
    return {"grid_matmul": [rec]}, launches["grid_matmul"]


def kernel_line(results, launches):
    """One entry per kernel wrapper; times are per launch, averaged over
    the cases of one forward weighted by their launches per forward.
    `launches` holds each wrapper's count from the run of the path it is
    on, and "k11" the K2 launches of the fast profile's run."""
    meta = {
        "atm_block": ("K1 fused ATM block (bf16 LayerNorm + q/kv and "
                      "projection GEMMs on wgmma + TMA, attention on "
                      "mma.sync)", "atmvfi_tpu_torch/csrc/atm_block.cu",
                      "atmvfi_tpu/ops/attention_pallas.py:435"),
        "flow_warp_pair": ("K2 backward warp, pair form",
                           "atmvfi_tpu_torch/csrc/warp.cu",
                           "atmvfi_tpu/ops/warp_pallas.py:291"),
        "flow_warp": ("K2 backward warp, single form",
                      "atmvfi_tpu_torch/csrc/warp.cu",
                      "atmvfi_tpu/ops/warp_pallas.py:291"),
        "conv3x3": ("K3 conv3x3 + bias + PReLU, mma.sync implicit GEMM "
                    "(f32, and bf16 below 32 input channels)",
                    "atmvfi_tpu_torch/csrc/conv3x3.cu",
                    "atmvfi_tpu/ops/conv_pallas.py:148"),
        "conv3x3_wgmma": ("K3 conv3x3 + bias + PReLU, bf16 from 32 input "
                          "channels: TMA halo tiles, wgmma with A from "
                          "registers, warp-specialised",
                          "atmvfi_tpu_torch/csrc/conv3x3_wgmma.cu",
                          "atmvfi_tpu/ops/conv_pallas.py:148"),
        "conv3x3_s2_wgmma": ("K4 stride-2 conv3x3 + bias + PReLU, bf16 from "
                             "32 input channels: K3's wgmma kernel, 17 x "
                             "33 TMA halo",
                             "atmvfi_tpu_torch/csrc/conv3x3_wgmma.cu",
                             "atmvfi_tpu/ops/conv_pallas.py:792"),
        "conv3x3_s2": ("K4 stride-2 conv3x3 + bias + PReLU, mma.sync "
                       "implicit GEMM (f32, and bf16 below 32 input "
                       "channels)", "atmvfi_tpu_torch/csrc/conv3x3.cu",
                       "atmvfi_tpu/ops/conv_pallas.py:792"),
        "conv3x3_multi": ("K5 multi-source conv3x3 + bias + PReLU, mma.sync "
                          "implicit GEMM (f32, and sources no TMA map "
                          "takes)", "atmvfi_tpu_torch/csrc/conv3x3.cu",
                          "atmvfi_tpu/ops/conv_pallas.py:363"),
        "conv3x3_multi_wgmma": ("K5 multi-source conv3x3 + bias + PReLU, "
                                "bf16: K3's wgmma kernel with one TMA map "
                                "per source (f32 images rounded into one "
                                "k16 slice a tap), or its folded body "
                                "for one image (K = 27 taps x channels)",
                                "atmvfi_tpu_torch/csrc/conv3x3_wgmma.cu",
                                "atmvfi_tpu/ops/conv_pallas.py:363"),
        "deconv2x": ("K6 deconv2x + bias + PReLU, mma.sync implicit GEMM "
                     "(f32, and maps no TMA map takes)",
                     "atmvfi_tpu_torch/csrc/deconv2x.cu",
                     "atmvfi_tpu/ops/deconv_pallas.py:102"),
        "deconv2x_wgmma": ("K6 deconv2x + bias + PReLU, bf16: one GEMM on "
                           "wgmma + TMA, columns (dy, dx, o), stmatrix-"
                           "staged 16-byte stores at the output pixels",
                           "atmvfi_tpu_torch/csrc/deconv2x_wgmma.cu",
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
        "attention_tiled": ("K1 launch 2 / K7 / K8 window attention + "
                            "motion over windows above 12 (N > 160): "
                            "key-tiled forms with an online softmax, "
                            "compact mask (token labels) and rel (key "
                            "coordinates) from shared memory (bf16: "
                            "attn_wg_tiled_kernel on wgmma at head dims "
                            "up to 64, attn_mma_tiled_kernel on mma.sync "
                            "above and for the general form, 128 rows a "
                            "block, 3-stage cp.async ring; f32 "
                            "attn_tiled_kernel: register-tiled 4 x 4 "
                            "blocks on the CUDA cores)",
                            "atmvfi_tpu_torch/csrc/atm_block.cu",
                            "atmvfi_tpu/ops/attention_pallas.py:233"),
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
        "grid_matmul": ("row P gridded matmul [128, 64] @ [64, 64], f32, "
                        "one block per 64-row tile (the counted "
                        "roofline's kernel check)",
                        "atmvfi_tpu_torch/csrc/grid_matmul.cu",
                        "tests/test_roofline.py:56"),
    }
    # K3-K6 sites split by the route they take (K3 / K4: the channel
    # floor; K5 / K6: the sources' layout)
    splits = ("conv3x3", "conv3x3_s2", "conv3x3_multi", "deconv2x")
    results = dict(results, k11=results["flow_warp_pair"]
                   + results["flow_warp"])
    launches = dict(launches)
    for k in splits:
        recs = results[k]
        results[k] = [r for r in recs if r["route"] == "igemm"]
        results[k + "_wgmma"] = [r for r in recs if r["route"] == "wgmma"]
        launches[k] = launches[k] - launches[k + "_wgmma"]
    route_splits = splits + tuple(k + "_wgmma" for k in splits)
    out = []
    for k, (name, src, rep) in meta.items():
        recs = results[k]
        if k in route_splits and not any(r["per_forward"] for r in recs):
            continue  # a conv kernel's route that no main-path site takes
        if not any(r.get("per_forward", 1) for r in recs):
            raise AssertionError(f"{k}: no record of a launch on the path")
        base = [r for r in recs if r.get("dtype") == "bf16"
                and not r.get("case", "").startswith("lite")]
        if k in ("atm_block", "window_attention"):
            # the main paths run base bf16, 2 calls per window shape
            used = [(r, 2) for r in base]
        elif k == "window_attention_heads":  # on no main path
            used = [(r, 1) for r in base]
        elif k == "attention_tiled":  # the windows phase's (16, 24) path
            used = [(r, 2) for r in base if r["kernel"] == "K7" and (
                r["case"], r["window"]) in (("local", 16), ("global", 24))]
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
        if k in ("window_attention", "window_attention_heads",
                 "attention_tiled"):
            entry["bf16_max_abs_err"] = max(r["max_abs_err"] for r in recs
                                            if r["dtype"] == "bf16")
        if k == "conv3x3_pair":
            entry["bf16_max_abs_err"] = max(r["bf16_max_abs_err"]
                                            for r in recs)
            entry["ms_over_two_k3"] = entry["ms"] / avg("two_k3_ms")
        if k in ("window_attention", "window_attention_heads",
                 "attention_tiled", "conv3x3_pair"):
            entry["ms_over_library"] = entry["ms"] / lib
        if k == "attention_tiled":
            entry["windows"] = sorted({r["window"] for r in recs})
            entry["f32_max_abs_err"] = max(r["max_abs_err"] for r in recs
                                           if r["dtype"] == "f32")
        if k.endswith("_wgmma"):
            entry["igemm_ms"] = avg("igemm_ms")
            entry["ms_over_igemm"] = entry["ms"] / entry["igemm_ms"]
            entry.update(wgmma_resources() if k != "deconv2x_wgmma" else
                         {"registers_by_bnw": ptxas_registers(
                             r"deconv2x_wgmma_kernelILi(\d+)E", "BNW {}")})
        if k == "atm_block":  # the three launches apart, base bf16
            entry["launch_ms"] = [
                sum(r["launches"][i]["ms"] * w for r, w in used) / n
                for i in range(3)]
            entry["launch_bound_ms"] = [
                sum(r["launches"][i]["bound_ms"] * w for r, w in used) / n
                for i in range(3)]
            entry["launch_library_ms"] = [
                sum(r["launches"][i]["library_ms"] * w for r, w in used) / n
                for i in range(3)]
            entry["gemm_registers"] = ptxas_registers(
                r"gemm_kernelILi(\d+)ELb(\d)E", "gemm_kernel BNW {} RESID {}")
        out.append(entry)
    return {"kernels": out}


def wgmma_resources() -> dict:
    """Registers (ptxas) and dynamic shared memory of each (column tile,
    stride) instantiation of the K3 / K4 wgmma kernel."""
    from atmvfi_tpu_torch.ops import _build

    lib = _build.load_library()
    return {"registers_by_bn": ptxas_registers(
                r"conv3x3_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                "BN {} stride {} mode {}"),
            "fold_registers_by_bn": ptxas_registers(
                r"conv3x3_fold_kernelILi(\d+)E", "BN {}"),
            "smem_bytes_by_bn": {f"BN {b} stride {st}":
                                 lib.conv3x3_wgmma_smem_bytes(b, st)
                                 for b in (16, 64, 104, 128, 200, 256)
                                 for st in (1, 2)
                                 if lib.conv3x3_wgmma_smem_bytes(b, st)}}


def ptxas_registers(pattern: str, key: str) -> dict:
    """Registers (ptxas) of each instantiation of a kernel: the entry
    names matching `pattern`, keyed by `key` formatted with its groups."""
    import re

    from atmvfi_tpu_torch.ops import _build

    regs, name = {}, None
    for ln in _build.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + pattern, ln)
        if m:
            name = key.format(*m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            regs[name] = int(m.group(1))
            name = None
    return regs


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
    if sys.argv[1:] == ["--k1-launches"]:
        phase_kernels(torch, k1_only=True)
        emit(dict(k1_launches="done", gpu=nvidia_smi_line()))
        return 0
    if sys.argv[1:] == ["--gradients"]:
        phase_gradients(torch)
        emit(dict(gradients="done", gpu=nvidia_smi_line()))
        return 0
    if sys.argv[1:] and set(sys.argv[1:]) <= {"--windows", "--eval"}:
        for flag in sys.argv[1:]:  # one build for both
            (phase_windows if flag == "--windows" else phase_eval)(torch)
            emit({flag[2:]: "done", "gpu": nvidia_smi_line()})
        return 0
    if sys.argv[1:] == ["--windows-split"]:
        windows_split(torch)
        return 0
    if sys.argv[1:] == ["--train"]:
        phase_train(torch)
        emit(dict(train="done", gpu=nvidia_smi_line()))
        return 0
    if sys.argv[1:] == ["--roofline"]:
        phase_spread_gather(torch)
        phase_main_path(torch, "default", {}, False, PER_FORWARD, 3)
        phase_roofline(torch)
        emit(dict(roofline="done", gpu=nvidia_smi_line()))
        return 0
    if sys.argv[1:] == ["--stream"]:
        phase_stream(torch)
        emit(dict(stream="done", gpu=nvidia_smi_line()))
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
    phase_stream(torch)
    phase_agreement(torch)
    results.update(phase_row_warps(torch))
    # after the phases whose counts (b) compares, before the training
    # phase (its loader threads may still hold the GIL after it)
    grid, launches["grid_matmul"] = phase_roofline(torch)
    results.update(grid)
    spatial = [phase_spatial_main_path(torch, n) for n in (2, 4)]
    for k in ("warp_pair_srcfull", "flow_warp_rows"):  # this path's own
        launches[k] = sum(run[k] for run in spatial)
    phase_spatial_agreement(torch)
    phase_gradients(torch)
    windows, win_launches = phase_windows(torch)
    results["attention_tiled"] = [r for r in windows if r.get("tiled")]
    launches["attention_tiled"] = win_launches["atm_block_tiled"]
    phase_eval(torch)
    phase_train(torch)
    emit(kernel_line(results, launches))
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
