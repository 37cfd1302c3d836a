"""ATM-VFI network, two-frame forward (base and lite presets).

Counterpart of `atmvfi_tpu/models/network.py::Network.__call__` with its
route fields (`models.config`). Every layer that the JAX package runs
through a conv kernel runs the port's kernel -- each ConvPReLU as K3
(stride 1) or K4 (stride 2), the decoder's plain 3x3 convs as K3, every
Deconv2x as K6, and the two convs that read the f32 images as K5 (the
encoder's first conv on the stacked frames, as the JAX planes route
does, and the refinement proj on [decoder feature || five images]) --
with bias and PReLU fused. With `hcw_fuse_pairs` each decoder conv pair
and the refine head run as one K12 call instead of two K3 calls. The
layers that the JAX package leaves to XLA stay cuDNN (`F.conv2d`): the
strided and dilated fusion convs and their 1x1 projection, the 1x1
motion-head outputs and the depthwise MLP convs. The six transformer
blocks run kernel K1, or K7 between cuBLAS projections on the packed
attention route; every backward warp runs kernel K2 (`ops.warp_cuda`),
and on the `tiled_blend` route I_t of each blend site comes from K9 (the
warped pair from one K2 pair launch beside it). On the CPU each kernel
wrapper runs its plain PyTorch version.

The `serving_*` methods cut the same forward for the row-sharded
serving schedule (`parallel.spatial`): a conv front per slab of rows, an
attention middle on the gathered token maps, and a tail per slab whose
scale-0 warps read the full frames through kernel K10
(`warp_cuda.warp_pair_srcfull`) and whose token and decoder-input warps
run as row warps (`warp_cuda.flow_warp_rows`). The multiscale
global-motion ensemble (`multiscale_global_motion_ensemble`) runs no
kernel of its own: the encoder and global branch at three scales, and K2.

Frames are stacked on the batch axis so the shared towers run once on
[2B, ...]. Mixed precision as in the JAX package: images, flows,
occlusion, warps and blends stay f32; the towers run in `cfg.dtype`;
flows leave the motion heads in f32.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from atmvfi_tpu_torch import ops
from atmvfi_tpu_torch.models.config import ATMVFIConfig
from atmvfi_tpu_torch.models.fusion import CrossScaleFeatureFusion
from atmvfi_tpu_torch.models.layers import (
    ATMFormer,
    Conv2d,
    ConvPReLU,
    Deconv2x,
    PlainConv3x3,
    PReLU,
    RefineBottleneck,
    reset_parameters,
)
from atmvfi_tpu_torch.ops.conv_cuda import cat_nhwc, conv3x3_pair
from atmvfi_tpu_torch.ops.warp_cuda import (
    flow_warp,
    flow_warp_blend,
    flow_warp_pair,
    flow_warp_rows,
    warp_pair_srcfull,
)

# named ranges of the forward in torch.profiler traces (stage breakdown
# of `atmvfi_tpu_torch.tools.profile_main_path`); a no-op otherwise
span = torch.profiler.record_function


def _split_head(out: torch.Tensor):
    """Motion-head output [..., 5] -> f32 (flow0, flow1, occlusion)."""
    out_f = out.float()
    return (out_f[..., 0:2].contiguous(), out_f[..., 2:4].contiguous(),
            torch.sigmoid(out_f[..., 4:5]))


class Network(nn.Module):
    """forward(im0, im1) -> output dict; im* [B, H, W, 3] in [0, 1] with
    H, W divisible by 16 (`infer.InputPadder` pads other sizes).

    `generator` seeds the random initialisation (a fixed seed of 0 when
    None); load real weights with `load_state_dict`.
    """

    def __init__(self, cfg: ATMVFIConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = c = cfg
        dt = c.dtype
        d = c.hidden_dims
        mo = c.motion_out_dim

        cins = (3,) + tuple(d[:-1])
        self.feat_extracts = nn.ModuleList([
            nn.Sequential(ConvPReLU(cins[i], d[i], 1 if i == 0 else 2, dt),
                          ConvPReLU(d[i], d[i], 1, dt))
            for i in range(c.pyramid_level)
        ])

        fused = c.fused_dim
        self.cross_scale_feature_fusion = CrossScaleFeatureFusion(
            tuple(d[1:]), fused, dt)
        self.feat_enhance_transformer = nn.ModuleList([
            RefineBottleneck(fused, c.enhance_window, s, c.num_heads,
                             c.mlp_ratio, dt, c.packed_attention)
            for s in (0, c.enhance_window // 2)
        ])
        self.local_motion_atmformer = nn.ModuleList([
            ATMFormer(fused, c.local_window, s, c.num_heads, c.mlp_ratio, dt,
                      c.packed_attention)
            for s in (0, c.local_window // 2)
        ])
        n_motion = 4 * 2  # 2 blocks x (dx, dy) x 2 frames
        lm_hidden = int(2 * fused * c.local_mlp_hidden_ratio)
        self.local_motion_mlp = nn.Sequential(
            ConvPReLU(2 * fused + n_motion, lm_hidden, 1, dt),
            ConvPReLU(lm_hidden, lm_hidden, 1, dt),
            Conv2d(lm_hidden, mo, 1, dtype=dt),
        )

        lfd = c.last_feat_dim
        self.last_feat_extract = nn.Sequential(
            ConvPReLU(d[-1], lfd, 2, dt), ConvPReLU(lfd, lfd, 1, dt))
        gdim = c.global_dim
        self.global_feature_fusion = CrossScaleFeatureFusion(
            (d[-2], d[-1], lfd), gdim, dt)
        self.global_motion_atmformer = nn.ModuleList([
            ATMFormer(gdim, c.global_window, s, c.num_heads, c.mlp_ratio, dt,
                      c.packed_attention)
            for s in (0, c.global_window // 2)
        ])
        self.global_motion_mlp = nn.Sequential(
            ConvPReLU(2 * gdim + n_motion, c.global_mlp_hidden, 1, dt),
            ConvPReLU(c.global_mlp_hidden, c.global_mlp_hidden, 1, dt),
            Conv2d(c.global_mlp_hidden, mo, 1, dtype=dt),
        )

        fd1, fd2, fd3 = c.decoder_dims
        self.upsample_pyramid = nn.ModuleList([
            nn.Sequential(Deconv2x(2 * fd1 + mo, fd1 + mo, dt),
                          ConvPReLU(fd1 + mo, fd1 + mo, 1, dt),
                          PlainConv3x3(fd1 + mo, fd1 + mo, dt)),
            nn.Sequential(PReLU(fd1 + mo), Deconv2x(fd1 + mo, fd2 + mo, dt),
                          ConvPReLU(fd2 + mo, fd2 + mo, 1, dt),
                          PlainConv3x3(fd2 + mo, fd2 + mo, dt)),
            nn.Sequential(PReLU(fd2 + mo), Deconv2x(fd2 + mo, fd3 + mo, dt),
                          ConvPReLU(fd3 + mo, fd3 + mo, 1, dt),
                          PlainConv3x3(fd3 + mo, fd3 + mo, dt)),
        ])

        hid = c.refine_hidden
        self.proj = ConvPReLU(fd3 + mo + 15, hid, 1, dt)  # feat + 5 images
        self.down1 = nn.Sequential(ConvPReLU(hid, hid, 2, dt))
        self.down2 = nn.Sequential(ConvPReLU(hid + fd2, 2 * hid, 2, dt),
                                   ConvPReLU(2 * hid, 2 * hid, 1, dt))
        self.down3 = nn.Sequential(ConvPReLU(2 * hid + fd1, 4 * hid, 2, dt),
                                   ConvPReLU(4 * hid, 4 * hid, 1, dt),
                                   ConvPReLU(4 * hid, 4 * hid, 1, dt))
        self.up1 = nn.Sequential(Deconv2x(4 * hid, 2 * hid, dt),
                                 ConvPReLU(2 * hid, 2 * hid, 1, dt))
        self.up2 = nn.Sequential(Deconv2x(4 * hid, 2 * hid, dt),
                                 ConvPReLU(2 * hid, hid, 1, dt))
        self.up3 = nn.Sequential(Deconv2x(2 * hid, hid, dt))
        self.refine_head = nn.Sequential(ConvPReLU(2 * hid, hid, 1, dt),
                                         ConvPReLU(hid, 3, 1, dt))

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    # ------------------------------------------------------------------
    def _warp_blend(self, im0, im1, flow0, flow1, occ):
        """(I_t, I_t_0, I_t_1): one pair warp, then the occlusion blend;
        on the fused route I_t comes from K9 beside the pair warp."""
        w0, w1 = flow_warp_pair(im0, im1, flow0, flow1)
        if self.cfg.fused_blend:
            return flow_warp_blend(im0, im1, flow0, flow1, occ), w0, w1
        return occ * w0 + (1 - occ) * w1, w0, w1

    def _conv_pair(self, conv_a: ConvPReLU, conv_b, x):
        """Two stride-1 3x3 convs (ConvPReLU, then ConvPReLU or
        PlainConv3x3): one K12 call under `hcw_fuse_pairs`, else two K3."""
        if not self.cfg.hcw_fuse_pairs:
            return conv_b(conv_a(x))
        if isinstance(conv_b, ConvPReLU):
            wb, bb, sb = conv_b[0].weight, conv_b[0].bias, conv_b[1].weight
        else:
            wb, bb, sb = conv_b.weight, conv_b.bias, None
        return conv3x3_pair(x.to(conv_a[0].dtype), conv_a[0].weight,
                            conv_a[0].bias, conv_a[1].weight, wb, bb, sb)

    def shared_feat_extraction(self, x):
        """[2B, H, W, 3] f32 frames -> coarsest feature + [1/2, 1/4, 1/8]
        features. The first conv (K5) reads the f32 frames and rounds
        them to the working type as it loads them."""
        feats = []
        for i, stage in enumerate(self.feat_extracts):
            if i == 0:
                x = stage[1](stage[0].forward_sources([x]))
            else:
                x = stage(x)
                feats.append(x)
        return x, feats

    def shared_feat_enhancement(self, x):
        for blk in self.feat_enhance_transformer:
            x = blk(x)
        return x

    def _motion(self, blocks, head, feat):
        """Two ATMFormers + a motion head on [2B, h, w, C] tokens."""
        B = feat.shape[0] // 2
        chunks = []
        for blk in blocks:
            feat, m = blk(feat)
            chunks.append(torch.cat([m[:B], m[B:]], -1))
        feat_cat = torch.cat([feat[:B], feat[B:]], -1)
        out = head(torch.cat(chunks + [feat_cat], -1))
        return out, feat

    def estimate_local_motion(self, feat):
        """Fused 1/8 tokens -> (flow0, flow1, occ, tokens, head output)."""
        out, feat = self._motion(self.local_motion_atmformer,
                                 self.local_motion_mlp, feat)
        return (*_split_head(out), feat, out)

    def _global_tokens(self, x, feat_scale_level):
        """Coarsest encoder feature -> fused 1/16 global tokens."""
        feat_ = self.last_feat_extract(x)
        return self.global_feature_fusion(
            [feat_scale_level[1], feat_scale_level[2], feat_])

    def _global_motion_from_tokens(self, feat_):
        """Attention half of the global branch: 1/16 tokens -> flows and
        occlusion."""
        out, _ = self._motion(self.global_motion_atmformer,
                              self.global_motion_mlp, feat_)
        return _split_head(out)

    def estimate_global_motion(self, x, feat_scale_level):
        """Coarsest encoder feature -> 1/16 flows and occlusion."""
        return self._global_motion_from_tokens(
            self._global_tokens(x, feat_scale_level))

    def _decoder_stage(self, stage, feat):
        """[PReLU,] Deconv2x, then the conv pair."""
        return self._conv_pair(*stage[-2:], stage[:-2](feat))

    def _decoder_input(self, enh, out, warp):
        """[warp(frame-0 features, flow0) || warp(frame-1 features, flow1)
        || head output]: the decoder input, with `warp(feature, flow)`
        the full-frame or the row warp. Built in a map whose pixel stride
        is a multiple of 8 (773 channels at 776), which the first deconv
        (K6) reads by TMA; the same bytes as torch.cat."""
        fd1 = self.cfg.decoder_dims[0]
        out_f = out.float()
        return cat_nhwc([warp(enh[..., :fd1], out_f[..., 0:2].contiguous()),
                         warp(enh[..., fd1:2 * fd1],
                              out_f[..., 2:4].contiguous()), out])

    # ---- the multiscale global-motion ensemble -------------------------
    def _global_alignmentness(self, flow0, flow1, im0, im1):
        """Mean |warp(im0) - warp(im1)| per pair under 1/16 flows
        upsampled to the frames' size: [B]."""
        factor = im0.shape[1] // flow0.shape[1]
        w0, w1 = flow_warp_pair(im0, im1, ops.upsample_flow(flow0, factor),
                                ops.upsample_flow(flow1, factor))
        return (w0 - w1).abs().mean(dim=(1, 2, 3))

    def multiscale_global_motion_ensemble(self, im0, im1, level0=None):
        """Global flows estimated on the frames at full, 1/2 and 1/4 size;
        per pair, the flows that align the frames best (the first on a
        tie). `level0`: the encoder's (coarsest feature, scale features)
        on the full frames, when the caller has them."""
        im = torch.cat([im0, im1], 0)
        f0s, f1s, losses = [], [], []
        for level in range(3):
            if level > 0:
                im = ops.downsample_2x(im)
            if level > 0 or level0 is None:
                x, levels = self.shared_feat_extraction(im)
            else:
                x, levels = level0
            f0, f1, _ = self.estimate_global_motion(x, levels)
            losses.append(self._global_alignmentness(f0, f1, im0, im1))
            if level > 0:
                f0 = ops.upsample_flow(f0, 2 ** level)
                f1 = ops.upsample_flow(f1, 2 ** level)
            f0s.append(f0)
            f1s.append(f1)
        best = torch.stack(losses, 0).argmin(0)  # [B]
        pick = torch.arange(im0.shape[0], device=best.device)
        return torch.stack(f0s, 0)[best, pick], torch.stack(f1s, 0)[best, pick]

    def residual_refinement(self, feat, im0, I_t_0, im1, I_t_1, I_t, skips):
        # K5 over [decoder feature || five f32 images]: no concat is built
        feat0 = self.proj.forward_sources([feat, im0, I_t_0, im1, I_t_1, I_t])
        feat1 = self.down1(feat0)
        feat2 = self.down2(torch.cat([feat1, skips[1]], -1))
        feat3 = self.down3(torch.cat([feat2, skips[0]], -1))
        cat2 = torch.cat([self.up1(feat3), feat2], -1)
        cat1 = torch.cat([self.up2(cat2), feat1], -1)
        cat_h = torch.cat([self.up3(cat1), feat0], -1)
        head = self._conv_pair(*self.refine_head, cat_h)
        return 2 * torch.sigmoid(head) - 1

    # ------------------------------------------------------------------
    def forward(self, im0, im1, global_motion: bool = True,
                ensemble_global_motion: bool = False):
        c = self.cfg
        im0 = im0.float().contiguous()
        im1 = im1.float().contiguous()
        B = im0.shape[0]
        im0_list: List[torch.Tensor] = [im0]
        im1_list: List[torch.Tensor] = [im1]
        im_t_list: List[torch.Tensor] = []
        im0_warped_list: List[torch.Tensor] = []
        im1_warped_list: List[torch.Tensor] = []
        compose_full = global_motion and c.compose_full_res_warps
        with span("encoder"):
            for _ in range(c.pyramid_level - 1):
                im0_list.append(ops.downsample_2x(im0_list[-1]))
                im1_list.append(ops.downsample_2x(im1_list[-1]))
            x, feat_scale_level = self.shared_feat_extraction(
                torch.cat([im0, im1], 0))
            feat = self.cross_scale_feature_fusion(feat_scale_level)

        if global_motion:
            with span("global_motion"):
                if ensemble_global_motion:
                    gf0, gf1 = self.multiscale_global_motion_ensemble(
                        im0, im1, (x, feat_scale_level))
                else:
                    gf0, gf1, gocc1 = self.estimate_global_motion(
                        x, feat_scale_level)
                    I_t, I_t_0, I_t_1 = self._warp_blend(
                        ops.downsample_2x(im0_list[-1]),
                        ops.downsample_2x(im1_list[-1]), gf0, gf1, gocc1)
                    im0_warped_list.insert(0, I_t_0)
                    im1_warped_list.insert(0, I_t_1)
                    im_t_list.insert(0, I_t)
            with span("prealign"):
                gf0 = ops.upsample_flow(gf0, 2)
                gf1 = ops.upsample_flow(gf1, 2)
                # pre-align the fused tokens and the whole image pyramid
                feat = torch.cat([flow_warp(feat[:B], gf0),
                                  flow_warp(feat[B:], gf1)], 0)
                for i in reversed(range(c.pyramid_level)):
                    if i == 0 and compose_full:
                        # serving profile: leave the full-size frames
                        # unwarped; the global flow is added to the
                        # scale-0 flows instead (one resampling, not two)
                        gf_full = gf0, gf1
                        continue
                    im0_list[i], im1_list[i] = flow_warp_pair(
                        im0_list[i], im1_list[i], gf0, gf1)
                    if i != 0:
                        gf0 = ops.upsample_flow(gf0, 2)
                        gf1 = ops.upsample_flow(gf1, 2)

        with span("local_motion"):
            flow0, flow1, occ1, feat, out = self.estimate_local_motion(feat)
        with span("enhance"):
            feat = self.shared_feat_enhancement(feat)
            feat = torch.cat([feat[:B], feat[B:]], -1)  # [B, h, w, 2C]

        with span("decoder"):
            I_t, I_t_0, I_t_1 = self._warp_blend(
                im0_list[-1], im1_list[-1], flow0, flow1, occ1)
            im0_warped_list.insert(0, I_t_0)
            im1_warped_list.insert(0, I_t_1)
            im_t_list.insert(0, I_t)
            feat = self._decoder_input(feat, out, flow_warp)
            skips = []
            mo = c.motion_out_dim
            for stage, scale in zip(self.upsample_pyramid, (2, 1, 0)):
                feat = self._decoder_stage(stage, feat)
                flow0, flow1, occ1 = _split_head(feat[..., -mo:])
                if scale != 0:
                    skips.append(feat[..., :-mo])
                if scale == 0 and compose_full:
                    flow0 = flow0 + gf_full[0]
                    flow1 = flow1 + gf_full[1]
                I_t, I_t_0, I_t_1 = self._warp_blend(
                    im0_list[scale], im1_list[scale], flow0, flow1, occ1)
                im0_warped_list.insert(0, I_t_0)
                im1_warped_list.insert(0, I_t_1)
                im_t_list.insert(0, I_t)

        with span("refine"):
            residual = self.residual_refinement(feat, im0, I_t_0, im1,
                                                I_t_1, I_t, skips)
            I_t = torch.clamp(I_t + residual.float(), 0.0, 1.0)
        return {
            "I_t": I_t,
            "im_t_list": im_t_list,  # fine -> coarse
            "im0_warped_list": im0_warped_list,
            "im1_warped_list": im1_warped_list,
            "opt_flow_0": flow0,
            "opt_flow_1": flow1,
            "I_t_0": I_t_0,
            "I_t_1": I_t_1,
            "occ_mask1": occ1,
            "occ_mask2": 1 - occ1,
        }

    # ------------------------------------------------------------------
    # row-sharded serving (parallel.spatial; JAX network.py:891-1282).
    # Deep cut: a conv FRONT per full-resolution slab of rows (encoder,
    # both fusions), an attention MIDDLE on the gathered 1/8 and 1/16
    # token maps (the global branch replicated; the local blocks and the
    # enhancement per 1/8 slab with a halo; the token and decoder-input
    # warps per shard as row warps), and a TAIL per slab (three decoder
    # stages, scale-0 warps and blend, refinement). Shallow cut (the
    # ensemble): a replicated HEAD through decoder stage 1 and the tail
    # from scale 0. The scale-0 warps read full frames (K10), as flows
    # are unbounded; the tail is split at the gather of the pre-aligned
    # frames (`serving_tail_sources`, then `serving_tail`). Serving
    # only: B == 1, I_t alone.
    # ------------------------------------------------------------------
    def serving_front(self, im0_slab, im1_slab, global_motion: bool = True):
        """Frame slabs [1, Hs, W, 3] x2 -> (fused 1/8 tokens [2, Hs/8,
        W/8, fused_dim], global 1/16 tokens [2, Hs/16, W/16, global_dim]
        or None)."""
        x, fsl = self.shared_feat_extraction(
            torch.cat([im0_slab.float(), im1_slab.float()], 0))
        feat = self.cross_scale_feature_fusion(fsl)
        gtok = self._global_tokens(x, fsl) if global_motion else None
        return feat, gtok

    def serving_middle(self, feat, gtok, global_motion: bool = True):
        """The whole middle on the gathered token maps: (decoder input
        [1, H/8, W/8, 2 * fused + 5], full-resolution global flows or
        None)."""
        feat, gf0_full, gf1_full = self.serving_middle_global(
            feat, gtok, global_motion)
        enh, out = self.serving_middle_attn(feat)
        return self.serving_middle_decin(enh, out), gf0_full, gf1_full

    def serving_middle_global(self, feat, gtok, global_motion: bool = True):
        """Global flows and the token pre-align: (aligned tokens, gf0_full,
        gf1_full); the tokens unchanged and None without global motion."""
        if not global_motion:
            return feat, None, None
        B = feat.shape[0] // 2
        gf0, gf1, g0, g1 = self.serving_middle_flows(gtok)
        feat = torch.cat([flow_warp(feat[:B], gf0),
                          flow_warp(feat[B:], gf1)], 0)
        return feat, g0, g1

    def serving_middle_flows(self, gtok, full_res: bool = True):
        """Global 1/16 tokens -> (1/8 flows gf8_0, gf8_1, full-resolution
        flows g0, g1); g0, g1 are None unless `full_res`."""
        gf0, gf1, _ = self._global_motion_from_tokens(gtok)
        gf0 = ops.upsample_flow(gf0, 2)
        gf1 = ops.upsample_flow(gf1, 2)
        g0 = g1 = None
        if full_res:
            g0, g1 = gf0, gf1
            for _ in range(self.cfg.pyramid_level - 1):
                g0 = ops.upsample_flow(g0, 2)
                g1 = ops.upsample_flow(g1, 2)
        return gf0, gf1, g0, g1

    def serving_middle_align_rows(self, feat, gf8_0_rows, gf8_1_rows,
                                  row0: int):
        """Token pre-align onto rows [row0, row0 + h) of the full fused
        tokens [2, H/8, W/8, C], by the 1/8 global flows of those rows;
        row for row equal to the full-map warp."""
        B = feat.shape[0] // 2
        return torch.cat([flow_warp_rows(feat[:B], gf8_0_rows, row0),
                          flow_warp_rows(feat[B:], gf8_1_rows, row0)], 0)

    def serving_middle_attn(self, feat_slab):
        """Pre-aligned token slab [2, h, W/8, C] -> (enhanced features [1,
        h, W/8, 2C], local motion head output [1, h, W/8, 5])."""
        B = feat_slab.shape[0] // 2
        _, _, _, feat, out = self.estimate_local_motion(feat_slab)
        feat = self.shared_feat_enhancement(feat)
        return torch.cat([feat[:B], feat[B:]], -1), out

    def serving_middle_decin(self, enh, out):
        """Decoder input from the full enhanced features and head output."""
        return self._decoder_input(enh, out, flow_warp)

    def serving_middle_decin_rows(self, enh, out_rows, row0: int):
        """Decoder input on rows [row0, row0 + h): the full enhanced
        features (warp sources) and the head output of those rows."""
        return self._decoder_input(
            enh, out_rows, lambda f, fl: flow_warp_rows(f, fl, row0))

    def serving_head(self, im0, im1, global_motion: bool = True,
                     ensemble_global_motion: bool = False):
        """Shallow cut, replicated: full frames -> (scale-1 decoder output
        [1, H/2, W/2, fd2 + 5], refinement skips [1/4, 1/2], gf0_full,
        gf1_full or None). The forward without the scale-0 stage and
        the outputs only training reads (pyramid warps, coarse blends)."""
        im0 = im0.float().contiguous()
        im1 = im1.float().contiguous()
        B = im0.shape[0]
        x, fsl = self.shared_feat_extraction(torch.cat([im0, im1], 0))
        feat = self.cross_scale_feature_fusion(fsl)
        gf0_full = gf1_full = None
        if global_motion:
            if ensemble_global_motion:
                gf0, gf1 = self.multiscale_global_motion_ensemble(
                    im0, im1, (x, fsl))
            else:
                gf0, gf1, _ = self.estimate_global_motion(x, fsl)
            gf0 = ops.upsample_flow(gf0, 2)
            gf1 = ops.upsample_flow(gf1, 2)
            feat = torch.cat([flow_warp(feat[:B], gf0),
                              flow_warp(feat[B:], gf1)], 0)
            for _ in range(self.cfg.pyramid_level - 1):
                gf0 = ops.upsample_flow(gf0, 2)
                gf1 = ops.upsample_flow(gf1, 2)
            gf0_full, gf1_full = gf0, gf1
        _, _, _, feat, out = self.estimate_local_motion(feat)
        feat = self.shared_feat_enhancement(feat)
        feat = self._decoder_input(torch.cat([feat[:B], feat[B:]], -1), out,
                                   flow_warp)
        skips = []
        for stage in self.upsample_pyramid[:2]:
            feat = self._decoder_stage(stage, feat)
            skips.append(feat[..., :-self.cfg.motion_out_dim])
        return feat, skips, gf0_full, gf1_full

    def serving_tail_sources(self, im0_full, im1_full, gf0_slab, gf1_slab,
                             slab_row0: int, h_slab: int,
                             global_motion: bool = True):
        """The scale-0 warp sources on the slab rows [slab_row0,
        slab_row0 + h_slab): the frames pre-aligned by the global flows
        of those rows (K10 on the full frames [1, H, W, 3]), or the
        frames' rows themselves without global motion and in compose
        mode. The caller gathers the shards' rows of these into full
        frames for `serving_tail`."""
        if global_motion and not self.cfg.compose_full_res_warps:
            return warp_pair_srcfull(im0_full, im1_full, gf0_slab, gf1_slab,
                                     slab_row0)
        rows = slice(slab_row0, slab_row0 + h_slab)
        return im0_full[:, rows], im1_full[:, rows]

    def serving_tail(self, feat_slab, skips_slab, p0_full, p1_full,
                     im0_full, im1_full, gf0_slab, gf1_slab, slab_row0: int,
                     crop_off: int, h_loc: int, global_motion: bool = True):
        """Scale-0 tail on a slab: the scale-1 output of the slab rows
        [1, Hs/2, W/2, fd2 + 5] and its skips, the gathered full warp
        sources p*_full and frames im*_full [1, H, W, 3], the global
        flows of the slab rows (None without global motion) -> the
        shard's I_t rows [1, h_loc, W, 3] (slab rows crop_off onwards).
        Both scale-0 warps run as one K10 launch on the full sources."""
        c = self.cfg
        feat = self._decoder_stage(self.upsample_pyramid[2], feat_slab)
        flow0, flow1, occ1 = _split_head(feat[..., -c.motion_out_dim:])
        if global_motion and c.compose_full_res_warps:
            flow0 = flow0 + gf0_slab
            flow1 = flow1 + gf1_slab
        w0, w1 = warp_pair_srcfull(p0_full, p1_full, flow0, flow1, slab_row0)
        I_t = occ1 * w0 + (1 - occ1) * w1
        rows = slice(slab_row0, slab_row0 + feat.shape[1])
        residual = self.residual_refinement(feat, im0_full[:, rows], w0,
                                            im1_full[:, rows], w1, I_t,
                                            skips_slab)
        I_t = torch.clamp(I_t + residual.float(), 0.0, 1.0)
        return I_t[:, crop_off:crop_off + h_loc]

    def serving_tail_deep(self, dec_in_slab, p0_full, p1_full, im0_full,
                          im1_full, gf0_slab, gf1_slab, slab_row0: int,
                          crop_off: int, h_loc: int,
                          global_motion: bool = True):
        """Deep tail: the decoder input of the slab rows [1, Hs/8, W/8,
        2 * fused + 5] -> decoder stages 2 and 1 on the slab, then
        `serving_tail`."""
        feat = dec_in_slab
        skips = []
        for stage in self.upsample_pyramid[:2]:
            feat = self._decoder_stage(stage, feat)
            skips.append(feat[..., :-self.cfg.motion_out_dim])
        return self.serving_tail(feat, skips, p0_full, p1_full, im0_full,
                                 im1_full, gf0_slab, gf1_slab, slab_row0,
                                 crop_off, h_loc, global_motion)
