"""The conv wrappers (`ops.conv_cuda`, `ops.deconv_cuda`) on the CPU:
odd shapes against F.conv2d / F.conv_transpose2d composed in f32, the
source layouts they take, and the routing of the forward through the
four wrappers. (The plain versions against the Pallas ops:
test_torch_conv_plain.py.)"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from atmvfi_tpu_torch.models import Network, get_config
from atmvfi_tpu_torch.ops import conv_cuda, deconv_cuda

torch.set_num_threads(2)  # the test workers share the CPU

WRAPPERS = (conv_cuda.conv3x3, conv_cuda.conv3x3_s2, conv_cuda.conv3x3_multi,
            deconv_cuda.deconv2x)


# ---- odd shapes through the wrappers, against F.conv* in f32 ----------
def _prelu(y, a):
    return y if a is None else torch.where(y >= 0, y, a.view(1, -1, 1, 1) * y)


def _rand(gen, *shape):
    return torch.rand(*shape, generator=gen) * 2 - 1


@pytest.mark.parametrize("stride,B,H,W,cin,cout,prelu", [
    (1, 2, 9, 13, 5, 13, True),     # odd sizes, ragged channels
    (1, 1, 7, 31, 101, 5, False),   # a decoder-like width, no PReLU
    (2, 2, 9, 13, 13, 5, True),     # stride 2 on odd H and W
    (2, 1, 16, 15, 101, 8, True),
])
def test_conv_wrappers_match_f_conv2d(stride, B, H, W, cin, cout, prelu):
    """f32, max |d| <= 1e-5; output ceil(H/stride) x ceil(W/stride)."""
    g = torch.Generator().manual_seed(B * 1000 + H * W + cin)
    x = _rand(g, B, H, W, cin)
    w = _rand(g, cout, cin, 3, 3) / (9 * cin) ** 0.5
    b = _rand(g, cout) * 0.1
    a = _rand(g, cout) * 0.3 if prelu else None
    fn = conv_cuda.conv3x3 if stride == 1 else conv_cuda.conv3x3_s2
    got = fn(x, w, b, a)
    want = _prelu(F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, 1), a)
    assert got.shape == (B, -(-H // stride), -(-W // stride), cout)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0,
                               atol=1e-5)


def test_multi_source_wrapper_reads_channel_slices():
    """K5 over [channel slice (pixel stride > C) || f32 image || another
    slice]: equal to F.conv2d on the built concat."""
    g = torch.Generator().manual_seed(11)
    big = _rand(g, 2, 9, 11, 16)
    srcs = [big[..., 2:7], _rand(g, 2, 9, 11, 3), big[..., 10:]]
    assert srcs[0].stride(2) == 16
    cin = sum(s.shape[-1] for s in srcs)
    w = _rand(g, 7, cin, 3, 3) / (9 * cin) ** 0.5
    b, a = _rand(g, 7) * 0.1, _rand(g, 7) * 0.3
    got = conv_cuda.conv3x3_multi(srcs, w, b, a)
    cat = torch.cat(srcs, -1).permute(0, 3, 1, 2)
    want = _prelu(F.conv2d(cat, w, b, 1, 1), a).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,H,W,cin,cout,sliced", [
    (2, 5, 7, 13, 5, False),
    (1, 3, 4, 101, 6, True),
])
def test_deconv_wrapper_matches_f_conv_transpose2d(B, H, W, cin, cout,
                                                   sliced):
    g = torch.Generator().manual_seed(H * W + cin)
    x = _rand(g, B, H, W, cin + 3)[..., 3:] if sliced else _rand(g, B, H, W,
                                                                  cin)
    w = _rand(g, cin, cout, 2, 2) / (4 * cin) ** 0.5
    b, a = _rand(g, cout) * 0.1, _rand(g, cout) * 0.3
    got = deconv_cuda.deconv2x(x, w, b, a)
    want = _prelu(F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, 2), a)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0,
                               atol=1e-5)


def test_pixel_stride_takes_slices_and_refuses_other_layouts():
    x = torch.zeros(2, 4, 5, 16)
    assert conv_cuda.pixel_stride(x) == 16
    assert conv_cuda.pixel_stride(x[..., 3:9]) == 16
    assert conv_cuda.pixel_stride(x[:1]) == 16
    with pytest.raises(ValueError):  # NCHW memory behind an NHWC view
        conv_cuda.pixel_stride(torch.zeros(2, 16, 4, 5).permute(0, 2, 3, 1))
    with pytest.raises(ValueError):  # every other pixel
        conv_cuda.pixel_stride(x[:, :, ::2])


def test_padded_outputs_are_vector_readable():
    """On the card a kernel output with C % 8 != 0 is a channel view at a
    pixel stride rounded up to 8, which the next kernel reads as 16-byte
    vectors; other layouts take the gathering loaders."""
    out = conv_cuda.empty_nhwc(2, 3, 5, 389, torch.bfloat16, "cpu")
    assert out.shape == (2, 3, 5, 389) and out.stride(2) == 392
    assert conv_cuda.vec_readable(out, conv_cuda.pixel_stride(out))
    dense = torch.zeros(2, 3, 5, 389, dtype=torch.bfloat16)
    assert not conv_cuda.vec_readable(dense, 389)            # stride 389
    assert not conv_cuda.vec_readable(out.float(), 392)      # f32
    wide = torch.zeros(1, 2, 2, 24, dtype=torch.bfloat16)
    assert conv_cuda.vec_readable(wide[..., 8:13], 24)       # in the pixel
    assert not conv_cuda.vec_readable(wide[..., 9:14], 24)   # unaligned
    # the last pixel's 8-channel read would leave the storage
    assert not conv_cuda.vec_readable(wide[..., 19:24][..., 1:], 24)


@pytest.mark.parametrize("stride", [1, 2])
def test_wgmma_route_takes_wide_aligned_bf16_maps(stride):
    """K3 (stride 1) and K4 (stride 2) send a bf16 map of at least
    WGMMA_MIN_CHANNELS channels at a pixel stride that is a multiple of 8
    and a 16-byte aligned pointer to the wgmma kernel; f32, narrower maps
    and other layouts take the implicit GEMM. On the CPU the wrapper
    counts the call and runs the plain version: no launch, no wgmma
    launch."""
    bf16 = torch.bfloat16
    # the encoder's 24-channel maps stay on igemm
    assert conv_cuda.WGMMA_MIN_CHANNELS == 32
    eligible = conv_cuda._wgmma_eligible
    wide = torch.zeros(1, 5, 7, 48, dtype=bf16)
    assert eligible(wide) and eligible(wide[..., :40])     # slice, stride 48
    assert not eligible(wide[..., 8:32])                   # 24 channels
    assert not eligible(wide.float())                      # f32: parity mode
    assert not eligible(wide[..., 4:44])                   # 8-byte aligned
    assert not eligible(torch.zeros(1, 5, 7, 36, dtype=bf16))  # stride 36
    fn = conv_cuda.conv3x3 if stride == 1 else conv_cuda.conv3x3_s2
    g = torch.Generator().manual_seed(7)
    x = _rand(g, 1, 9, 13, 40).to(bf16)
    w, b = _rand(g, 16, 40, 3, 3) / 19.0, _rand(g, 16) * 0.1
    counts = (fn.calls, fn.launches, fn.wgmma_launches)
    got = fn(x, w, b)
    assert (fn.calls, fn.launches, fn.wgmma_launches) == (
        counts[0] + 1, counts[1], counts[2])
    want = conv_cuda.conv3x3_plain([x], w, b, None, stride, bf16)
    assert got.shape == (1, -(-9 // stride), -(-13 // stride), 16)
    assert torch.equal(got, want)


# ---- routing: every conv-kernel layer of the forward goes through its
# wrapper (on the card the same calls are launches)
NARROW = dict(hidden_dims=(8, 16, 16, 32), last_feat_extra=16,
              global_mlp_hidden=64, refine_hidden=16)


@pytest.mark.parametrize("global_motion,counts", [
    # K3 (encoder 4, local head 2, last_feat 1, global head 2, decoder
    # 3 + 3, refine 7), K4 (encoder 3, last_feat 1, refine 3), K5
    # (encoder first conv, refine proj), K6 (decoder 3, refine 3)
    (True, (22, 7, 2, 6)),
    (False, (19, 6, 2, 6)),
])
def test_forward_runs_every_conv_layer_through_the_kernels(global_motion,
                                                           counts):
    net = Network(dataclasses.replace(get_config("lite"), **NARROW)).eval()
    g = torch.Generator().manual_seed(1)
    ims = [torch.rand(1, 64, 96, 3, generator=g) for _ in range(2)]
    before = [(f.calls, f.launches) for f in WRAPPERS]
    with torch.no_grad():
        out = net(*ims, global_motion=global_motion)
    assert out["I_t"].shape == (1, 64, 96, 3)
    calls = tuple(f.calls - c for f, (c, _) in zip(WRAPPERS, before))
    assert calls == counts
    # on the CPU every call ran the plain version
    assert all(f.launches == n for f, (_, n) in zip(WRAPPERS, before))
