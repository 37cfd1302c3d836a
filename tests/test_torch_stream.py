"""Batched streaming, run-time window sizes, the Y4M reader and writer and
the video CLI of the port against the JAX package and against the port's
own batch-1 stream on the CPU (f32; JAX at HIGHEST matmul precision)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu.infer.pipeline import InterpolationPipeline as JPipeline
from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.utils import video as jvideo
from atmvfi_tpu_torch.cli import demo_2x
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.infer import InterpolationPipeline
from atmvfi_tpu_torch.models import get_config
from atmvfi_tpu_torch.ops import attention_cuda, conv_cuda, deconv_cuda
from atmvfi_tpu_torch.ops import warp_cuda
from atmvfi_tpu_torch.parallel import make_mesh
from atmvfi_tpu_torch.utils import video as tvideo
from test_torch_model import (
    NARROW,
    XLA_ROUTES,
    _jax_variables,
    _param_shapes,
    _random_params,
)

torch.set_num_threads(2)  # the test workers share the CPU

WRAPPERS = (attention_cuda.atm_block, attention_cuda.window_attention,
            warp_cuda.flow_warp_pair, warp_cuda.flow_warp,
            warp_cuda.flow_warp_blend, conv_cuda.conv3x3,
            conv_cuda.conv3x3_s2, conv_cuda.conv3x3_multi,
            conv_cuda.conv3x3_pair, deconv_cuda.deconv2x)


@pytest.fixture(scope="module")
def narrow():
    """(JAX config with the XLA routes, JAX variables, port state_dict)
    of one seeded narrow lite model."""
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **XLA_ROUTES)
    flat = _random_params(_param_shapes(jcfg), seed=4)
    return jcfg, _jax_variables(flat), params_from_jax(flat)


def _port(sd, **kw):
    cfg = dataclasses.replace(get_config("lite"), **NARROW)
    return InterpolationPipeline(sd, cfg, dtype=torch.float32, device="cpu",
                                 **kw)


def _jax(jcfg, variables):
    jp = JPipeline(variables, variant="lite", dtype=jnp.float32)
    jp.cfg = jcfg
    jp.net = JNetwork(jcfg)  # read when the forward is first traced
    return jp


def _moving_frames(n, H=48, W=64, seed=0):
    """n uint8 frames of one random canvas, each moved by a few pixels."""
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (H + 24, W + 24, 3), dtype=np.uint8)
    out, y, x = [], 12, 12
    for _ in range(n):
        out.append(np.ascontiguousarray(canvas[y:y + H, x:x + W]))
        y, x = y + int(rng.integers(-2, 3)), x + int(rng.integers(-3, 4))
    return out


def test_with_windows_matches_jax():
    for variant in ("base", "lite"):
        for args in ((), (6,), (None, 8), (4, 6, 10), (None, None, 12)):
            got = dataclasses.asdict(get_config(variant).with_windows(*args))
            want = dataclasses.asdict(jconfig(variant).with_windows(*args))
            for k in ("local_window", "global_window", "enhance_window"):
                assert got[k] == want[k], (variant, args, k)


def test_set_window_sizes_matches_jax(narrow):
    """Windows (6, 8): I_t within 1e-4 of JAX's pipeline with the same
    weights; back at (8, 12) the uint8 frame is bit-equal to the first."""
    jcfg, variables, sd = narrow
    f0, f1 = _moving_frames(2, 64, 96, seed=1)
    tp = _port(sd)
    first = tp.interpolate(f0, f1)
    tp.set_window_sizes(local=6, global_=8)
    assert (tp.cfg.local_window, tp.cfg.global_window,
            tp.cfg.enhance_window) == (6, 8, 8)
    assert tp.net.local_motion_atmformer[0].attn.window_size == 6
    assert tp.net.global_motion_atmformer[0].attn.window_size == 8
    jp = _jax(jcfg, variables)
    jp.set_window_sizes(local=6, global_=8)
    x0, x1 = (np.asarray(f, np.float32)[None] / 255.0 for f in (f0, f1))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jp.interpolate_device(jnp.asarray(x0),
                                                jnp.asarray(x1)))
    got = tp.interpolate_device(torch.from_numpy(x0), torch.from_numpy(x1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    tp.set_window_sizes(local=8, global_=12)
    np.testing.assert_array_equal(tp.interpolate(f0, f1), first)


@pytest.mark.parametrize("factor,n,batch", [(2, 6, 2), (2, 3, 8), (4, 4, 3)])
def test_batched_stream_matches_batch1(narrow, factor, n, batch):
    """(2, 6, 2): full batches and a padded tail; (2, 3, 8): a stream
    shorter than one batch; (4, 4, 3): the 4x recursion on batches."""
    tp = _port(narrow[2])
    frames = _moving_frames(n, seed=n)
    one = list(tp.interpolate_stream_device(frames, factor, 1))
    many = list(tp.interpolate_stream_device(frames, factor, batch))
    assert len(one) == len(many) == factor * (n - 1) + 1
    for a, b in zip(one, many):
        assert a.shape == b.shape == (1, 48, 64, 3)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)
    u1 = list(tp.interpolate_stream(frames, factor))
    ub = list(tp.interpolate_stream_batched(frames, factor, batch))
    for k, (a, b) in enumerate(zip(u1, ub)):
        assert b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        if k % factor == 0:  # the source frames pass through unchanged
            np.testing.assert_array_equal(b, frames[k // factor])


def test_batched_stream_matches_jax(narrow):
    jcfg, variables, sd = narrow
    frames = _moving_frames(4, seed=7)
    with jax.default_matmul_precision("highest"):
        want = list(_jax(jcfg, variables).interpolate_stream_batched(
            iter(frames), factor=2, batch=2))
    got = list(_port(sd).interpolate_stream_batched(frames, 2, 2))
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_data_mesh_stream_splits_the_batch(narrow):
    """A 'data' mesh runs the batched stream through the batch split."""
    frames = _moving_frames(5, seed=3)
    mesh = make_mesh((2, 1), ["cpu", "cpu"])
    got = list(_port(narrow[2], mesh=mesh).interpolate_stream_device(
        frames, 2, 2))
    want = list(_port(narrow[2]).interpolate_stream_device(frames, 2, 1))
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_kernel_calls_per_forward_do_not_grow_with_batch(narrow):
    """Every kernel wrapper is called as often at batch 3 as at batch 1:
    the batch rides in the tensors, not in more launches."""
    tp = _port(narrow[2])
    counts = []
    for B in (1, 3):
        ims = [torch.rand(B, 64, 64, 3, generator=torch.Generator()
                          .manual_seed(B + k)) for k in range(2)]
        for fn in WRAPPERS:
            fn.calls = 0
        out = tp.interpolate_device(*ims)
        assert out.shape == (B, 64, 64, 3)
        counts.append([fn.calls for fn in WRAPPERS])
    assert counts[0] == counts[1] and sum(counts[0]) > 0


def test_stream_refusals(narrow):
    sd = narrow[2]
    tp = _port(sd)
    with pytest.raises(ValueError, match="factor"):
        tp.interpolate_stream_batched([], factor=3)
    with pytest.raises(ValueError, match="batch"):
        tp.interpolate_stream_batched([], batch=0)
    rows = _port(sd, mesh=make_mesh((1, 2), ["cpu", "cpu"]))
    with pytest.raises(ValueError, match="row-sharded"):
        rows.interpolate_stream_batched([], batch=2)
    assert len(list(rows.interpolate_stream_batched(
        _moving_frames(2, 64, 64), batch=1))) == 3
    data = _port(sd, mesh=make_mesh((2, 1), ["cpu", "cpu"]))
    with pytest.raises(ValueError, match="'data' shards"):
        data.interpolate_stream_batched([], batch=3)


@pytest.mark.parametrize("colorspace", ["C444", "C420"])
def test_y4m_writer_and_reader_match_jax(tmp_path, colorspace):
    frames = _moving_frames(3, 20, 30, seed=5)
    paths = [str(tmp_path / f"{k}.y4m") for k in ("port", "jax")]
    for mod, path in zip((tvideo, jvideo), paths):
        with mod.Y4MWriter(path, 30, 20, fps=(50, 2),
                           colorspace=colorspace) as w:
            for f in frames:
                w.write(f)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1]
    assert data[0].startswith(b"YUV4MPEG2 W30 H20 F50:2 Ip A1:1 "
                              + colorspace.encode())
    with tvideo.Y4MReader(paths[0]) as tr, jvideo.Y4MReader(paths[0]) as jr:
        assert (tr.width, tr.height, tr.fps, tr.colorspace) == (
            jr.width, jr.height, jr.fps, jr.colorspace)
        assert tr.fps_float == 25.0
        got, want = list(tr), list(jr)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == (20, 30, 3)
        np.testing.assert_array_equal(a, b)
    if colorspace == "C444":  # full chroma: within a grey level or two
        assert np.abs(got[0].astype(int) - frames[0].astype(int)).max() <= 2


def test_y4m_refusals(tmp_path):
    with pytest.raises(ValueError, match="even"):
        tvideo.Y4MWriter(str(tmp_path / "odd.y4m"), 31, 20, colorspace="C420")
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"RIFF....\n")
    with pytest.raises(ValueError, match="YUV4MPEG2"):
        tvideo.Y4MReader(str(bad))
    np.testing.assert_array_equal(
        tvideo.rgb_to_ycbcr(np.full((1, 1, 3), 255, np.uint8)),
        jvideo.rgb_to_ycbcr(np.full((1, 1, 3), 255, np.uint8)))


def _cli(*args):
    return demo_2x.main(["--model_type", "lite", "--device", "cpu",
                         *map(str, args)])


def test_cli_video_doubles_frames_and_fps(tmp_path, capsys):
    src = str(tmp_path / "in.y4m")
    with tvideo.Y4MWriter(src, 56, 40, fps=(24000, 1001),
                          colorspace="C420jpeg") as w:
        for f in _moving_frames(4, 40, 56, seed=2):
            w.write(f)
    assert _cli("--video", src, "--out", tmp_path / "out", "--batch", 2,
                "--combine_video") == 0
    said = capsys.readouterr().out
    assert "--combine_video applies to --frames_dir mode only" in said
    assert f"wrote {tmp_path / 'out.y4m'}: 7 frames at 47.952 fps" in said
    with tvideo.Y4MReader(str(tmp_path / "out.y4m")) as r:
        assert (r.width, r.height, r.fps, r.colorspace) == (
            56, 40, (48000, 1001), "C420")
        assert len(list(r)) == 7


def test_cli_frames_dir_batch_agrees_with_batch1(tmp_path):
    """In f32 (--fp32): the bf16 towers' rounding alone can move a frame
    by two grey levels between two batch sizes."""
    src = tmp_path / "frames"
    src.mkdir()
    for k, f in enumerate(_moving_frames(4, 40, 56, seed=6)):
        np.save(src / f"{k:03d}.npy", f)
    outs = []
    for batch in (1, 2):
        out = tmp_path / f"out{batch}"
        assert _cli("--frames_dir", src, "--out", out, "--batch", batch,
                    "--fp32") == 0
        names = sorted(os.listdir(out))
        assert len(names) == 7
        outs.append([np.load(out / n) for n in names])
    for a, b in zip(*outs):
        assert a.shape == (40, 56, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_cli_combine_video_and_refusals(tmp_path):
    src = tmp_path / "frames"
    src.mkdir()
    frames = _moving_frames(3, 40, 56, seed=8)
    for k, f in enumerate(frames):
        np.save(src / f"{k:03d}.npy", f)
    out = tmp_path / "out"
    assert _cli("--frames_dir", src, "--out", out, "--factor", 4,
                "--combine_video") == 0
    names = sorted(os.listdir(out))
    assert len(names) == 9
    for i, n in enumerate(names):
        f = np.load(out / n)
        assert f.shape == (80, 56, 3)
        np.testing.assert_array_equal(f[:40], frames[min(i // 4, 2)])
        if i % 4 == 0:
            np.testing.assert_array_equal(f[40:], frames[i // 4])
    for bad in (("--batch", 0), ("--batch", 2, "--spatial_shards", 2)):
        with pytest.raises(SystemExit):
            _cli("--frames_dir", src, "--out", out, *bad)


def test_set_window_sizes_rebuilds_the_mesh_forward(narrow):
    """Under a 'data' mesh the batch split is rebuilt around the new
    network: the same I_t as a pipeline without a mesh at (6, 8)."""
    sd = narrow[2]
    ims = [torch.rand(2, 64, 64, 3, generator=torch.Generator()
                      .manual_seed(k)) for k in range(2)]
    want = _port(sd)
    want.set_window_sizes(local=6, global_=8)
    got = _port(sd, mesh=make_mesh((2, 1), ["cpu", "cpu"]))
    before = got.interpolate_device(*ims)
    got.set_window_sizes(local=6, global_=8)
    after = got.interpolate_device(*ims)
    np.testing.assert_allclose(after.numpy(),
                               want.interpolate_device(*ims).numpy(),
                               atol=1e-5, rtol=0)
    assert np.abs(after.numpy() - before.numpy()).max() > 1e-4
