"""The layouts K5 (`conv3x3_multi`) and K6 (`deconv2x`) take on their
wgmma + TMA kernels, on the CPU: the routing predicates, the kernels'
weight packs against the plain versions, the layout helpers, and the
pixel strides the forward hands to both wrappers (default and
row-sharded paths). The kernels themselves run on the card only
(`chip_smoke.py` phase 3); the forward's agreement with JAX is
test_torch_model.py's and test_torch_spatial_schedule.py's."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from atmvfi_tpu_torch.models import Network, get_config, layers
from atmvfi_tpu_torch.ops import conv as plain
from atmvfi_tpu_torch.ops import conv_cuda, deconv_cuda
from atmvfi_tpu_torch.parallel import make_mesh, make_spatial_forward

torch.set_num_threads(2)  # the test workers share the CPU

bf16 = torch.bfloat16


def _rand(gen, *shape):
    return torch.rand(*shape, generator=gen) * 2 - 1


def test_deconv_wgmma_pack_is_the_plain_deconv():
    """The (dy, dx, o)-ordered, Cout8-padded pack [4 Cout8, Kp] as one
    GEMM over the input pixels, each 8-column piece scattered to its
    output pixel, equals ops.conv.deconv2x (f32, max |d| <= 1e-6); the
    pad rows and columns are zeros."""
    g = torch.Generator().manual_seed(5)
    B, H, W, cin, cout = 2, 3, 5, 21, 13
    x = _rand(g, B, H, W, cin)
    w = _rand(g, cin, cout, 2, 2) / (4 * cin) ** 0.5
    b, a = _rand(g, cout) * 0.1, _rand(g, cout) * 0.3
    pack, kp = deconv_cuda.wgmma_pack(w, torch.float32)
    cout8 = 16
    assert pack.shape == (4 * cout8, kp) and kp == 24
    p4 = pack.reshape(2, 2, cout8, kp)
    assert not p4[:, :, cout:].any() and not p4[..., cin:].any()
    cols = torch.einsum("bhwi,ni->bhwn", x, pack[:, :cin])  # [.., 4 Cout8]
    y = cols.reshape(B, H, W, 2, 2, cout8)[..., :cout]      # (dy, dx, o)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, cout)
    got = plain._epilogue(y, b, a, torch.float32)
    want = plain.deconv2x(x, w, b, a)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("fold", [False, True])
def test_multi_wgmma_pack_is_the_plain_conv(fold):
    """K5's wgmma pack: the bf16 sources' channels each from a multiple
    of 8, then the images' channels together ([9, Cout, Kp]); or one
    image folded into 27 columns ([1, Cout, 64]). Undoing either layout
    on the CPU gives the plain conv (f32, max |d| <= 1e-5)."""
    g = torch.Generator().manual_seed(6)
    B, H, W, cout = 1, 6, 8, 10
    if fold:
        srcs = [_rand(g, B, H, W, 3)]
        layout = [(3, True)]
    else:  # an image first: the kernel's order differs from the concat's
        srcs = [_rand(g, B, H, W, 3), _rand(g, B, H, W, 13),
                _rand(g, B, H, W, 3), _rand(g, B, H, W, 35)]
        layout = [(3, True), (13, False), (3, True), (35, False)]
    cin = sum(c for c, _ in layout)
    w = _rand(g, cout, cin, 3, 3) / (9 * cin) ** 0.5
    b = _rand(g, cout) * 0.1
    pack, kp = conv_cuda.multi_pack(w, layout, fold, torch.float32)
    xp = F.pad(torch.cat(srcs, -1), (0, 0, 1, 1, 1, 1))  # [B, H+2, W+2, C]
    taps = [xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    if fold:
        assert pack.shape == (1, cout, 64) and kp == 64
        assert not pack[..., 27:].any()
        cols = torch.cat(taps, -1)  # column 3 tap + c
        y = cols @ pack[0, :, :27].t()
    else:
        # kernel order: the bf16 sources (13 at 0, 35 at 16), then the
        # images (at 56 and 59); Kp = 64
        assert pack.shape == (9, cout, 64) and kp == 64
        order = [1, 3, 0, 2]
        at = [56, 0, 59, 16]
        offs = [0, 3, 16, 19]
        y = 0
        for t, xt in enumerate(taps):
            for i in order:
                c = layout[i][0]
                y = y + xt[..., offs[i]:offs[i] + c] @ pack[t, :, at[i]:
                                                            at[i] + c].t()
        assert not pack[:, :, 13:16].any() and not pack[:, :, 51:56].any()
        assert not pack[:, :, 62:].any()
    want = plain.conv3x3(srcs, w, b, None)
    assert (y + b - want).abs().max().item() <= 1e-5


def test_routing_predicates_and_cpu_counts():
    """K6 and K5 send bf16 maps a TMA map can read to the wgmma kernels:
    bf16 of >= 32 channels at a pixel stride that is a multiple of 8,
    16-byte aligned (K3's rule), and for K5 f32 3-channel images at
    pixel stride 3 whose rows of 3 W floats are 16-byte multiples; f32
    convs and other layouts stay on the implicit GEMM. On the CPU a call
    counts in `calls` and runs the plain version: no launch, no wgmma
    launch."""
    elig = conv_cuda._multi_wgmma_eligible
    feat = conv_cuda.empty_nhwc(1, 4, 8, 101, bf16, "cpu")   # stride 104
    img = torch.zeros(1, 4, 8, 3)
    assert elig([feat] + [img] * 5, bf16)                   # refine proj
    assert elig([img], bf16)                                # encoder
    assert not elig([feat] + [img] * 6, bf16)               # 6 images
    assert not elig([feat, img], torch.float32)             # f32 conv
    dense = torch.zeros(1, 4, 8, 101, dtype=bf16)           # stride 101
    assert not elig([dense, img], bf16)
    assert not elig([feat, torch.zeros(1, 4, 6, 3)], bf16)  # 72-byte rows
    assert not elig([feat, torch.zeros(1, 4, 8, 4)[..., :3]], bf16)
    assert not elig([feat, img.to(bf16)], bf16)             # bf16 image
    assert not elig([feat[..., :24], img], bf16)            # 24 channels
    # K6: K3's rule
    dec = conv_cuda.empty_nhwc(1, 4, 8, 773, bf16, "cpu")
    assert conv_cuda._wgmma_eligible(dec)
    assert not conv_cuda._wgmma_eligible(dec.contiguous())  # stride 773
    assert not conv_cuda._wgmma_eligible(dec.float())
    g = torch.Generator().manual_seed(8)
    x = _rand(g, 1, 4, 8, 40).to(bf16)
    fns = (deconv_cuda.deconv2x, conv_cuda.conv3x3_multi)
    before = [(f.calls, f.launches, f.wgmma_launches) for f in fns]
    deconv_cuda.deconv2x(x, _rand(g, 40, 12, 2, 2), _rand(g, 12))
    conv_cuda.conv3x3_multi([x, img], _rand(g, 16, 43, 3, 3), _rand(g, 16))
    after = [(f.calls, f.launches, f.wgmma_launches) for f in fns]
    assert [tuple(a - b for a, b in zip(x1, x0))
            for x0, x1 in zip(before, after)] == [(1, 0, 0), (1, 0, 0)]


def test_layout_helpers_keep_values_and_pad_strides():
    """`cat_nhwc` is torch.cat at a pixel stride rounded up to 8; PReLU
    on a channel view of such a map keeps the stride and gives F.prelu's
    values bit for bit; `card_layout` outputs of the CPU wrappers have
    the card's strides."""
    g = torch.Generator().manual_seed(9)
    parts = [_rand(g, 1, 3, 4, c).to(bf16) for c in (384, 384, 5)]
    cat = conv_cuda.cat_nhwc(parts)
    assert cat.stride(2) == 776 and torch.equal(cat, torch.cat(parts, -1))
    act = layers.PReLU(389)
    act.weight.data = _rand(g, 389)
    x = conv_cuda.empty_nhwc(1, 3, 4, 389, bf16, "cpu")
    x.copy_(_rand(g, 1, 3, 4, 389))
    want = F.prelu(x.contiguous().permute(0, 3, 1, 2),
                   act.weight.to(bf16)).permute(0, 2, 3, 1)
    with torch.no_grad():
        y = act(x)
        assert y.stride(2) == 392 and torch.equal(y, want)
        assert act(x[:, 1:]).stride(2) == 392     # a row slice too
        assert act(x.contiguous()).stride(2) == 389
    y = act(x)  # under autograd: the plain pass, the same values
    assert torch.equal(y, want) and y.requires_grad
    out = deconv_cuda.deconv2x(x, _rand(g, 389, 197, 2, 2) / 40,
                               _rand(g, 197))
    assert out.shape == (1, 6, 8, 197) and out.stride(2) == 200


NARROW = dict(hidden_dims=(8, 16, 16, 32), last_feat_extra=16,
              global_mlp_hidden=64, refine_hidden=16)


@pytest.mark.parametrize("shards", [0, 2])
def test_forward_hands_k5_k6_tma_legal_layouts(monkeypatch, shards):
    """Through the forward of the narrow base at 64x96 (bf16; shards 0:
    the default path, 2: the row-sharded one), every deconv input has a
    pixel stride that is a multiple of 8 (the decoder input at 168 for
    165 channels, the PReLU outputs at 88 and 48), and every f32 source
    of K5 is a TMA-legal image."""
    seen = []

    def deconv(x, *args):
        seen.append(("K6", x.shape[3], conv_cuda.pixel_stride(x)))
        return deconv_cuda.deconv2x(x, *args)

    def multi(srcs, *args):
        seen.extend(("K5", s.shape[3], conv_cuda.pixel_stride(s))
                    for s in srcs if s.dtype == torch.float32)
        assert all(conv_cuda._image_eligible(s) for s in srcs
                   if s.dtype == torch.float32)
        return conv_cuda.conv3x3_multi(srcs, *args)

    monkeypatch.setattr(layers, "deconv2x", deconv)
    monkeypatch.setattr(layers, "conv3x3_multi", multi)
    cfg = dataclasses.replace(get_config("base", bf16), **NARROW)
    net = Network(cfg).eval()
    g = torch.Generator().manual_seed(1)
    ims = [torch.rand(1, 64, 96, 3, generator=g) for _ in range(2)]
    fwd = (make_spatial_forward(net, make_mesh((1, shards), ["cpu"] * shards))
           if shards else net)
    with torch.no_grad():
        fwd(*ims)
    k6 = [(c, ps) for k, c, ps in seen if k == "K6"]
    assert len(k6) == 6 * max(shards, 1)
    assert all(ps % 8 == 0 for _, ps in k6)
    assert set(k6[:3]) == {(165, 168), (85, 88), (45, 48)}
    assert all(ps == 3 for k, _, ps in seen if k == "K5")
