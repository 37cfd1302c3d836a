"""Evaluation of the port against the JAX package on the CPU: the metrics,
the PNG codec and Pillow's BOX resize, the five benchmark runners on
small synthetic trees (narrow lite f32, the same weights on both sides)
and over tests/fixtures/mini_vimeo, and the Xiph frame extraction."""
import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from atmvfi_tpu.evalkit import harness as jharness
from atmvfi_tpu.evalkit import metrics as jmetrics
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.utils import video as jvideo
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.evalkit import harness, metrics
from atmvfi_tpu_torch.utils import images
from atmvfi_tpu_torch.utils import video as tvideo
from atmvfi_tpu_torch.utils.resample import pillow_resize
from test_torch_model import (
    NARROW,
    XLA_ROUTES,
    _jax_variables,
    _param_shapes,
    _random_params,
)
from test_torch_stream import _jax, _port

torch.set_num_threads(2)  # the test workers share the CPU

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_vimeo")


def _images(seed, shape=(2, 64, 96, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(shape).astype(np.float32),
                0, 1)
    return a, b


@pytest.mark.parametrize("name,scale", [
    ("ssim_matlab", 1.0), ("ssim", 1.0), ("msssim", 1.0), ("psnr", 1.0),
    ("ie", 1.0), ("ssim_matlab", 255.0)])
def test_metric_matches_jax(name, scale):
    """f32 NHWC images: SSIM / MS-SSIM within 1e-6, PSNR within 1e-4 dB,
    IE equal. scale 255 takes `_val_range`'s 255 branch."""
    a, b = (x * scale for x in _images(len(name) + int(scale)))
    want = float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0 and got.dtype == torch.float32
    tol = {"psnr": 1e-4, "ie": 0.0}.get(name, 1e-6)
    assert abs(float(got) - want) <= tol, (float(got), want)
    if scale == 255.0:
        assert float(metrics._val_range(torch.from_numpy(a), None)) == 255.0


def _filtered_png(path, img, types):
    """An RGB PNG whose row r carries filter types[r] (0 None, 1 Sub, 2
    Up, 3 Average, 4 Paeth), encoded here by the PNG specification."""
    x = img.astype(np.int32).reshape(img.shape[0], -1)
    h, n = x.shape
    rows = []
    for r in range(h):
        a = np.concatenate([np.zeros(3, np.int32), x[r, :-3]])
        b = x[r - 1] if r else np.zeros(n, np.int32)
        c = np.concatenate([np.zeros(3, np.int32), b[:-3]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][types[r]]
        rows.append(bytes([types[r]]) + ((x[r] - pred) & 255).astype(
            np.uint8).tobytes())
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(images._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", img.shape[1], h, 8, 2, 0, 0, 0)))
        fh.write(images._chunk(b"IDAT", zlib.compress(b"".join(rows))))
        fh.write(images._chunk(b"IEND", b""))


def test_png_codec_matches_pillow(tmp_path):
    """The reader gives Pillow's RGB pixels for the fixture's PNGs (Paeth,
    Sub and Up rows), for grey, RGB and RGBA files Pillow writes and for
    files with every row filter mixed (Average rows included) or Paeth
    alone; the writer's file reads back in Pillow byte-equal; the codec
    raises for a 16-bit PNG (which `read_image` then reads with Pillow:
    tests/test_torch_png.py)."""
    paths = sorted(
        os.path.join(r, f) for r, _, fs in os.walk(FIXTURE) for f in fs
        if f.endswith(".png"))[:6]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for mode in ("L", "LA", "RGB", "RGBA"):
        p = str(tmp_path / f"{mode}.png")
        Image.fromarray(img).convert(mode).save(p)
        paths.append(p)
    for name, types in (("mixed", rng.permutation(np.arange(37) % 5)),
                        ("paeth", np.full(37, 4))):
        p = str(tmp_path / f"{name}.png")
        _filtered_png(p, img, types)
        paths.append(p)
    for p in paths:
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
        got = images.read_image(p)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=p)
    out = str(tmp_path / "w.png")
    images.write_image(out, img)
    with Image.open(out) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(images.read_image(out), img)
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "d.png")
    with pytest.raises(ValueError, match="unsupported PNG"):
        images.read_png(str(tmp_path / "d.png"))


@pytest.mark.parametrize("src,dst", [((270, 512), (135, 256)),
                                     ((61, 97), (23, 40))])
def test_area_resize_matches_pillow_box(src, dst):
    """An integer factor (the Xiph 2k resize's 2x) and a non-integer one:
    equal to Pillow's BOX resize, value for value."""
    rng = np.random.default_rng(src[0])
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BOX))
    got = pillow_resize(img, dst[1], dst[0], "box")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jharness._area_resize(img, dst[1],
                                                             dst[0]))


@pytest.fixture(scope="module")
def weights():
    """(JAX config with the XLA routes, JAX variables, port state_dict)
    of one seeded narrow lite model."""
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **XLA_ROUTES)
    flat = _random_params(_param_shapes(jcfg), seed=5)
    return jcfg, _jax_variables(flat), params_from_jax(flat)


@pytest.fixture(scope="module")
def pipelines(weights):
    """{global_motion: (port pipeline, JAX pipeline)}."""
    jcfg, variables, sd = weights
    out = {}
    for gm in (False, True):
        jp = _jax(jcfg, variables)
        jp.global_motion = gm
        out[gm] = (_port(sd, global_motion=gm), jp)
    return out


def _png(path, seed, hw):
    """A smooth random image (so that the runners' PSNR means something)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((hw[0] // 8 + 2, hw[1] // 8 + 2, 3))
    img = np.kron(coarse, np.ones((8, 8, 1)))[:hw[0], :hw[1]]
    images.write_image(str(path), (img * 255).astype(np.uint8))


def _tree(tmp_path, kind):
    """The synthetic trees of tests/test_harness.py."""
    if kind == "vimeo90k":
        seq = tmp_path / "sequences" / "0001" / "0001"
        os.makedirs(seq)
        for i in (1, 2, 3):
            _png(seq / f"im{i}.png", i, (64, 112))
        (tmp_path / "tri_testlist.txt").write_text("0001/0001\n")
    elif kind == "ucf101":
        os.makedirs(tmp_path / "clip0")
        for i, n in enumerate(("frame_00", "frame_01_gt", "frame_02")):
            _png(tmp_path / "clip0" / f"{n}.png", i, (64, 64))
    elif kind == "snufilm":
        os.makedirs(tmp_path / "frames")
        for i in range(3):
            _png(tmp_path / "frames" / f"f{i}.png", i, (70, 100))  # pad 64
        (tmp_path / "test-easy.txt").write_text(
            " ".join(f"frames/f{i}.png" for i in range(3)) + "\n")
    elif kind == "xiph":
        os.makedirs(tmp_path / "BoxingPractice")
        for t in (1, 2, 3):
            _png(tmp_path / "BoxingPractice" / f"{t:03d}.png", t,
                 (2160 // 8, 4096 // 8))
    return str(tmp_path)


def _run(mod, kind, pipe, root):
    if kind == "vimeo90k":
        return mod.run_vimeo90k(pipe, root, progress=False)
    if kind == "ucf101":
        return mod.run_ucf101(pipe, root)
    if kind == "snufilm":
        return mod.run_snufilm(pipe, root, "", splits=("easy",))["easy"]
    return mod.run_xiph(pipe, root, categories=("resized-2k",),
                        frame_limit=1, clips=("BoxingPractice",),
                        resize_to=(128, 72))["resized-2k"]


@pytest.mark.parametrize("kind", ["vimeo90k", "ucf101", "snufilm", "xiph"])
def test_runner_matches_jax(tmp_path, pipelines, kind):
    """Global motion off for Vimeo / UCF, on for SNU / Xiph (the CLI's
    protocol): mean PSNR within 0.01 dB of the JAX runner's, SSIM within
    1e-4, the same item count."""
    root = _tree(tmp_path, kind)
    port, jp = pipelines[kind in ("snufilm", "xiph")]
    got = _run(harness, kind, port, root)
    with jax.default_matmul_precision("highest"):
        want = _run(jharness, kind, jp, root)
    assert got["n"] == want["n"] == 1
    assert abs(got["psnr"] - want["psnr"]) <= 0.01, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4, (got, want)
    assert got["seconds"] > 0 and got["steady_fps"] == 0.0  # one shape


def test_davis_4x_matches_jax(pipelines):
    """9 frames from 3: the sources in place, each output frame within one
    grey level of JAX's."""
    port, jp = pipelines[True]
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
              for _ in range(3)]
    got = harness.run_davis_4x(port, frames)
    with jax.default_matmul_precision("highest"):
        want = jharness.run_davis_4x(jp, frames)
    assert len(got) == len(want) == 2 * 4 + 1
    np.testing.assert_array_equal(got[0], frames[0])
    np.testing.assert_array_equal(got[4], frames[1])
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (64, 64, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_vimeo_fixture_matches_jax(pipelines):
    """The Vimeo protocol over tests/fixtures/mini_vimeo (448x256, first 3
    triplets, global motion off): mean PSNR within 0.01 dB of JAX's."""
    port, jp = pipelines[False]
    got = harness.run_vimeo90k(port, FIXTURE, limit=3, progress=False)
    with jax.default_matmul_precision("highest"):
        want = jharness.run_vimeo90k(jp, FIXTURE, limit=3, progress=False)
    assert got["n"] == want["n"] == 3
    assert abs(got["psnr"] - want["psnr"]) <= 0.01, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4, (got, want)
    assert got["steady_fps"] > 0


def test_extract_y4m_frames_matches_jax(tmp_path):
    """A 4-frame C420 clip: `max_frames` 3 writes 001-003.png, pixel for
    pixel the frames JAX's extraction writes (through Pillow), and
    `prepare_xiph` stages the same tree."""
    rng = np.random.default_rng(2)
    src = tmp_path / "y4m"
    os.makedirs(src)
    with tvideo.Y4MWriter(str(src / "Tango.y4m"), 40, 24,
                          colorspace="C420") as w:
        for _ in range(4):
            w.write(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
    n = tvideo.extract_y4m_frames(str(src / "Tango.y4m"),
                                  str(tmp_path / "port"), max_frames=3)
    assert n == jvideo.extract_y4m_frames(
        str(src / "Tango.y4m"), str(tmp_path / "jax"), max_frames=3) == 3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == ["001.png", "002.png", "003.png"]
    for f in ("001.png", "003.png"):
        with Image.open(tmp_path / "jax" / f) as im:
            np.testing.assert_array_equal(
                images.read_image(str(tmp_path / "port" / f)),
                np.asarray(im.convert("RGB")))
    counts = tvideo.prepare_xiph(str(src), str(tmp_path / "xiph"),
                                 ("Tango", "Crosswalk"), max_frames=2)
    assert counts == {"Tango": 2}
    assert sorted(os.listdir(tmp_path / "xiph" / "Tango")) == [
        "001.png", "002.png"]
