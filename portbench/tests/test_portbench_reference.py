"""The frozen reference against the program's CPU path in f32: the same
function, at tiny sizes. The program runs its kernels' plain versions on
the CPU."""
import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import network as R


def _frames(H, W, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.nn.functional.interpolate(
        torch.rand(1, 3, H // 8, W // 8, generator=g), size=(H + 16, W + 16),
        mode="bicubic").clamp(0, 1)
    f0 = img[0, :, :H, :W]
    f1 = img[0, :, 5:H + 5, 3:W + 3]
    return [(f * 255).round().byte().permute(1, 2, 0).contiguous()
            for f in (f0, f1)]


@pytest.mark.parametrize("name", ["atmvfi-base-bf16", "atmvfi-lite-bf16"])
def test_spec_is_the_program_state_dict(name):
    from atmvfi_tpu_torch.models import Network, get_config

    cfg = harness.load_config(name)
    sd = Network(get_config(cfg["variant"])).state_dict()
    spec = R.spec(R.Sizes.from_dict(cfg["model"]))
    assert [(n, tuple(s)) for n, s, _, _ in spec] == \
        [(n, tuple(t.shape)) for n, t in sd.items()]
    assert sum(int(np.prod(s)) for _, s, _, _ in spec) == cfg["parameters"]


@pytest.mark.parametrize("name", ["atmvfi-base-bf16", "atmvfi-lite-bf16"])
def test_reference_is_the_program_forward_in_f32(name):
    cfg = dict(harness.load_config(name), dtype="float32")
    sizes = R.Sizes.from_dict(cfg["model"])
    sd = weights.make_state_dict(sizes, 2 ** 31 + 3, "cpu")
    pipe = harness.build_program(cfg, sd, "cpu")
    f0, f1 = _frames(100, 120)
    l, r, t, b_ = R.pad_amounts(100, 120, 64)
    a, b = (torch.nn.functional.pad(
        (f.float() / 255.0).permute(2, 0, 1)[None], (l, r, t, b_),
        mode="replicate").permute(0, 2, 3, 1) for f in (f0, f1))
    got = pipe.interpolate_device(a, b)
    ref = R.forward(sd, sizes, a, b)
    assert (got - ref).abs().max().item() < 1e-4
    u_got = pipe.interpolate(f0.numpy(), f1.numpy()).astype(np.int16)
    u_ref = R.interpolate_uint8(sd, sizes, f0, f1, 64).numpy()
    # rounding ties alone: a level where the two f32 values straddle .5
    d = np.abs(u_got - u_ref)
    assert d.max() <= 1 and d.mean() < 1e-3
