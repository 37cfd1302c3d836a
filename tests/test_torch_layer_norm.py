"""The LayerNorm kernel's wrapper (`ops/norm_cuda.py::layer_norm`).

On the CPU: the wrapper returns exactly the plain chain
`layer_norm_f32(x, g, b, eps).to(dtype)` in every type pairing and
layout, `LayerNorm` and `CrossScaleFeatureFusion` reach it (its call
count), the row description it hands the kernel (leading dims merged
where strides allow, the row-sliced view of the global blocks kept in
place), and the counted roofline counts it as a kernel at its operands'
bytes.

On a CUDA card (marker `card`; they skip without one): the kernel
against its plain version at the main path's channel counts, in bf16
and f32, on the global blocks' row-sliced view and on row counts no
block divides (bf16 out within one ulp of the reference plus the f32
band, differing on under 1 % of elements; f32 out max |d| <= 1e-5; the
generic form where 16-byte vectors cannot read the rows), and gradients
through `ops._autograd.launch` equal to the plain version's. This file
imports no JAX; run it on the card from the repo root with
`python -m pytest --noconftest -m card tests/test_torch_layer_norm.py`.
"""
import pytest
import torch

from atmvfi_tpu_torch.models.fusion import CrossScaleFeatureFusion
from atmvfi_tpu_torch.models.layers import LN_EPS, LayerNorm, reset_parameters
from atmvfi_tpu_torch.ops import norm_cuda
from atmvfi_tpu_torch.ops.attention import layer_norm_f32
from atmvfi_tpu_torch.utils import roofline

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32


def _operand(lead, C, dtype, layout="dense", device="cpu", seed=0):
    """Unit-scale rows with per-row offsets: "dense", "sliced" (rows 2..
    of a map 4 rows taller, lead (B, H, W)) or "view" (the first C
    channels of a map 4 channels wider)."""
    g = torch.Generator().manual_seed(seed)
    shape = list(lead)
    if layout == "sliced":
        shape[-2] += 4
    width = C + 4 if layout == "view" else C
    x = (torch.randn(*shape, width, generator=g)
         + torch.randn(*shape, 1, generator=g)).to(dtype).to(device)
    if layout == "sliced":
        x = x[:, 2:2 + lead[-2]]
    elif layout == "view":
        x = x[..., :C]
    gb = [1 + 0.1 * torch.randn(C, generator=g), 0.1 * torch.randn(C,
                                                                   generator=g)]
    return x, *(t.to(device) for t in gb)


@pytest.mark.parametrize("din,dout,layout", [
    (BF16, BF16, "dense"), (F32, F32, "dense"), (BF16, F32, "dense"),
    (F32, BF16, "dense"), (BF16, BF16, "sliced")])
def test_cpu_wrapper_is_the_plain_chain(din, dout, layout):
    x, g, b = _operand((2, 5, 7), 48, din, layout)
    calls = norm_cuda.layer_norm.calls
    got = norm_cuda.layer_norm(x, g, b, LN_EPS, dout)
    want = layer_norm_f32(x, g, b, LN_EPS).to(dout)
    assert got.dtype == dout and torch.equal(got, want)
    assert norm_cuda.layer_norm.calls == calls + 1


def _layer_norm_module():
    m = LayerNorm(48, BF16)
    # The module-level reset_parameters skips the module it is given.
    m.reset_parameters(torch.Generator().manual_seed(1))
    return m, lambda x: layer_norm_f32(x, m.weight, m.bias,
                                       LN_EPS).to(BF16)


def _fusion_module():
    m = CrossScaleFeatureFusion((8, 16), 24, BF16)
    reset_parameters(m, torch.Generator().manual_seed(1))
    xs = [torch.randn(1, 8, 8, 8), torch.randn(1, 4, 4, 16)]
    y = m.proj(torch.cat([m.layers[0](xs[0]), xs[1].to(BF16)], -1))
    return (lambda _: m(xs)), lambda _: layer_norm_f32(
        y, m.norm.weight, m.norm.bias, LN_EPS).to(BF16)


@pytest.mark.parametrize("make", [_layer_norm_module, _fusion_module],
                         ids=["LayerNorm", "CrossScaleFeatureFusion"])
def test_modules_go_through_the_wrapper(make):
    torch.manual_seed(0)
    with torch.no_grad():
        run, want = make()
        x = _operand((2, 3, 4), 48, BF16)[0]
        calls = norm_cuda.layer_norm.calls
        got = run(x)
        assert norm_cuda.layer_norm.calls == calls + 1
        assert torch.equal(got, want(x))


@pytest.mark.parametrize("layout,sizes,strides,copied", [
    ("contiguous", [1, 1, 2 * 5 * 7], [0, 0, 48], False),
    ("sliced", [1, 2, 5 * 7], [0, 9 * 7 * 48, 48], False),
    ("windows", [1, 1, 12 * 16], [0, 0, 48], False),
    ("four dims apart", [1, 1, 2 * 3 * 5 * 7], [0, 0, 48], True)])
def test_rows_the_kernel_is_handed(layout, sizes, strides, copied):
    """Leading dims merge where their strides allow; the global blocks'
    row-sliced view stays a view (its rows and pixels merge); more than
    three dims that no stride merges are copied first."""
    if layout == "four dims apart":
        x = torch.randn(2, 2, 3, 2, 5, 2, 7, 48)[:, 0, :, 0, :, 0]
    elif layout == "windows":
        x = torch.randn(12, 16, 48)
    else:
        x = _operand((2, 5, 7), 48, BF16,
                     "sliced" if layout == "sliced" else "dense")[0]
    y, got_sizes, got_strides = norm_cuda._rows(x)
    assert (got_sizes, got_strides) == (sizes, strides)
    assert (y.data_ptr() != x.data_ptr()) == copied


def test_counted_as_one_kernel_at_its_operands():
    """The counted roofline sees the call as the kernel `layer_norm`:
    its bytes are x, g, b and the output alone, not the chain's f32
    temporaries."""
    x, g, b = _operand((2, 6, 8), 64, BF16)
    c = roofline.count_flops(norm_cuda.layer_norm, x, g, b, LN_EPS, BF16)
    assert "layer_norm" in c["kernels"]
    assert c["bytes_io"] == 2 * x.numel() * 2 + 2 * 64 * 4


# -- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")


def _bf16_band(got, want):
    """(elements beyond one ulp of the reference plus the f32 band,
    share of elements that differ). Where the last add cancels (y near
    0), one f32 ulp of its terms is many bf16 ulps of y: the two sums'
    orders differ by that much, hence the f32 band beside the ulp."""
    d = (got.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp_min(1e-30))) - 7)
    return int((d > ulp + 1e-5).sum()), (d > 0).float().mean().item()


@pytest.mark.card
@pytest.mark.parametrize("lead,C,din,dout,layout", [
    ((2, 68, 120), 224, BF16, BF16, "dense"),
    ((2, 34, 60), 288, BF16, BF16, "dense"),
    ((2, 68, 120), 352, BF16, BF16, "sliced"),
    ((2, 136, 240), 384, BF16, BF16, "dense"),
    ((2, 68, 120), 672, BF16, BF16, "sliced"),
    ((3, 7, 11), 384, BF16, BF16, "dense"),
    ((2, 34, 60), 224, F32, F32, "dense"),
    ((2, 34, 60), 288, F32, F32, "dense"),
    ((2, 34, 60), 384, F32, F32, "sliced"),
    ((2, 17, 30), 672, F32, F32, "dense"),
    ((3, 7, 11), 672, F32, F32, "sliced"),
    ((2, 34, 60), 384, BF16, F32, "dense"),
    ((2, 17, 30), 100, BF16, BF16, "dense"),
    ((2, 17, 30), 384, BF16, BF16, "view"),
])
def test_card_kernel_matches_plain(lead, C, din, dout, layout):
    _card()
    x, g, b = _operand(lead, C, din, layout, "cuda", seed=C)
    generic = norm_cuda.layer_norm.generic_launches
    with torch.no_grad():
        got = norm_cuda.layer_norm(x, g, b, LN_EPS, dout)
        want = norm_cuda.layer_norm_plain(x, g, b, LN_EPS, dout)
    assert got.dtype == dout and got.shape == x.shape
    # 16-byte vectors read every row but an odd C's or a channel view's
    vector = C % (16 // x.element_size()) == 0 and layout != "view"
    assert norm_cuda.layer_norm.generic_launches - generic == int(not vector)
    if dout == BF16:
        beyond, share = _bf16_band(got, want)
        assert beyond == 0 and share < 0.01, (beyond, share)
    else:
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_card_gradient_is_the_plain_vjp(dtype):
    _card()
    x, g, b = _operand((2, 9, 13), 384, dtype, "sliced", "cuda")
    gy = torch.randn(2, 9, 13, 384, device="cuda")
    grads = []
    for fn in (norm_cuda.layer_norm, norm_cuda.layer_norm_plain):
        leaves = [t.detach().requires_grad_() for t in (x, g, b)]
        y = fn(*leaves, LN_EPS, dtype)
        grads.append(torch.autograd.grad((y.float() * gy).sum(), leaves))
    assert all(torch.equal(p, q) for p, q in zip(*grads))
