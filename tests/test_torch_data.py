"""The port's datasets, loader, montage and train CLI against the JAX
package's on the CPU: items bit-equal for the same seed and order (one
worker thread: the JAX loader's workers share the dataset's
`random.Random`), the loader's batch order, the montage's pixels, and a
checkpoint of the train CLI that the JAX package's `load_params_npz`
reads."""
import os

import numpy as np
import pytest
import torch

from atmvfi_tpu import data as jdata
from atmvfi_tpu.train.checkpoints import load_params_meta, load_params_npz
from atmvfi_tpu.utils import visualize as jviz
from atmvfi_tpu.utils.images import read_image as jread_image
from atmvfi_tpu_torch import data as tdata
from atmvfi_tpu_torch.cli import train as train_cli
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.utils import visualize as tviz
from atmvfi_tpu_torch.utils.images import write_png

torch.set_num_threads(2)  # the test workers share the CPU

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_vimeo")


def vimeo_tree(root, repeat=1):
    """A Vimeo triplet tree over the fixture's 10 sequences: its test
    list, and a train list of the same sequences `repeat` times."""
    os.makedirs(root, exist_ok=True)
    os.symlink(os.path.join(FIXTURE, "sequences"),
               os.path.join(root, "sequences"))
    with open(os.path.join(FIXTURE, "tri_testlist.txt")) as f:
        seqs = [l for l in f.read().splitlines() if len(l) > 1]
    for name, lines in (("tri_testlist.txt", seqs),
                        ("tri_trainlist.txt", seqs * repeat)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def _same_items(tds, jds, order):
    for i in order:
        for t, j in zip(tds[i], jds[i]):
            assert t.dtype == j.dtype == np.float32
            np.testing.assert_array_equal(t, j)


def test_vimeo_train_items_match_jax(tmp_path):
    root = vimeo_tree(str(tmp_path / "vimeo"))
    tds = tdata.VimeoDataset("train", root, seed=0)
    jds = jdata.VimeoDataset("train", root, seed=0)
    assert len(tds) == len(jds) == 10
    _same_items(tds, jds, [3, 0, 9, 3, 5, 1, 7])
    assert tds[0][0].shape == (256, 256, 3)
    _same_items(tdata.VimeoDataset("test", root), jdata.VimeoDataset(
        "test", root), [0, 4])


def test_vimeo_scale_factor_2_matches_jax(tmp_path):
    """Pillow's BILINEAR upscale to 896x512 (the port's own, exact),
    then the 384 crop."""
    root = vimeo_tree(str(tmp_path / "vimeo"))
    tds = tdata.VimeoDataset("train", root, scale_factor=2, seed=1)
    jds = jdata.VimeoDataset("train", root, scale_factor=2, seed=1)
    _same_items(tds, jds, [2, 6])
    assert tds[0][0].shape == (384, 384, 3)


def _x4k_train_tree(root, rng, clips=2, frames=65, hw=(40, 52)):
    for c in range(clips):
        d = os.path.join(root, f"scene{c}", "sample0")
        os.makedirs(d)
        for f in range(frames):
            write_png(os.path.join(d, f"{f:04d}.png"),
                      rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    return root


def test_x4k_train_and_test_items_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    root = _x4k_train_tree(str(tmp_path / "x4k_train"), rng)
    tds = tdata.X4KTrain(root, patch_size=32, min_t_step_size=2, seed=5)
    jds = jdata.X4KTrain(root, patch_size=32, min_t_step_size=2, seed=5)
    assert len(tds) == len(jds) == 2
    _same_items(tds, jds, [0, 1, 1, 0, 1])
    assert tds[0][0].shape == (32, 32, 3)
    # the test protocol: type / scene / frames, t_step 32
    troot = str(tmp_path / "x4k_test")
    d = os.path.join(troot, "type1", "scene0")
    os.makedirs(d)
    for f in range(33):
        write_png(os.path.join(d, f"{f:04d}.png"),
                  rng.integers(0, 256, (24, 20, 3), dtype=np.uint8))
    for multiple in (2, 4):
        tds = tdata.X4KTest(troot, multiple=multiple, validation=False)
        jds = jdata.X4KTest(troot, multiple=multiple, validation=False)
        assert tds.items == jds.items and len(tds) == multiple - 1
        _same_items(tds, jds, range(len(tds)))


def test_snufilm_items_match_jax(tmp_path):
    """Replicate-padded to divisor 64 inside the dataset."""
    rng = np.random.default_rng(3)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    lines = []
    for i in range(2):
        names = []
        for j in range(3):
            p = str(img_dir / f"{i}_{j}.png")
            write_png(p, rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
            names.append(f"data/SNU-FILM/test/{i}_{j}.png")
        lines.append(" ".join(names))
    (tmp_path / "test-hard.txt").write_text("\n".join(lines) + "\n")
    kw = dict(path=str(tmp_path), img_data_path="imgs/")
    tds = tdata.SNUFilmDataset("hard", **kw)
    jds = jdata.SNUFilmDataset("hard", **kw)
    assert len(tds) == len(jds) == 2
    _same_items(tds, jds, [0, 1])
    assert tds[0][0].shape == (64, 128, 3)


class _Indices:
    """Items that name their index, so a batch shows which it holds."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return (np.full((2, 3), i, np.float32), np.array([i], np.int64))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_batch_order_matches_jax(shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last,
              num_workers=3, seed=7)
    tl, jl = tdata.DataLoader(_Indices(), **kw), jdata.DataLoader(
        _Indices(), **kw)
    assert len(tl) == len(jl) == (3 if drop_last else 4)
    for _ in range(2):  # two epochs: the shuffle moves with the epoch
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_loader_under_thread_switching_stress():
    """16 worker threads on 8 CPUs with a 1 us switch interval: every
    batch arrives once, in order, whole, within a time bound."""
    import sys
    import threading

    kw = dict(batch_size=2, shuffle=True, drop_last=False, num_workers=16,
              prefetch=1, seed=3)
    want = [b[1].ravel().tolist() for b in jdata.DataLoader(_Indices(), **kw)]
    interval = sys.getswitchinterval()
    got = []

    def run():
        got.extend(b[1].ravel().tolist() for b in tdata.DataLoader(
            _Indices(), **kw))

    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    assert got == want and sorted(sum(got, [])) == list(range(11))


def test_montage_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    ims = [rng.random((1, 24, 32, 3), dtype=np.float32) for _ in range(4)]
    flows = [3 * rng.standard_normal((24, 32, 2)).astype(np.float32)
             for _ in range(2)]
    occ = rng.random((24, 32, 1), dtype=np.float32)
    kw = dict(psnr=31.25, flow0=flows[0], flow1=flows[1], occ=occ)
    t = tviz.save_prediction(*ims, str(tmp_path / "t"), 3, **kw)
    j = jviz.save_prediction(*ims, str(tmp_path / "j"), 3, **kw)
    assert os.path.basename(t) == os.path.basename(j) == "sample_00003.png"
    got, want = jread_image(t), jread_image(j)
    assert got.shape == (48, 128, 3)
    np.testing.assert_array_equal(got, want)


def test_train_cli_writes_a_checkpoint_jax_reads(tmp_path, capsys):
    """Phase 1, lite, one step of batch 2 on the CPU, one validation
    step, then the epoch's params .npz: JAX's `load_params_npz` reads
    it as the lite params tree, and its values are the trained ones
    (they left the seeded initialisation)."""
    root = vimeo_tree(str(tmp_path / "vimeo"))
    ckpt = str(tmp_path / "ckpt")
    rc = train_cli.main([
        "--device", "cpu", "--variant", "lite", "--debug", "--debug_iter",
        "1", "--vimeo_path", root, "--batch_size", "2", "--num_epoch", "1",
        "--num_workers", "2", "--model_checkpoints", ckpt, "--seed", "3"])
    assert rc == 0
    assert "phase phase1_local" in capsys.readouterr().out
    (name,) = os.listdir(ckpt)
    assert name.startswith("phase1_local_epoch_0_psnr_") and name.endswith(
        ".npz")
    path = os.path.join(ckpt, name)
    tree = load_params_npz(path)["params"]
    meta = load_params_meta(path)
    assert meta["epoch"] == 0 and meta["phase"] == "phase1_local"
    assert set(meta["train_metric"]) == {"loss", "psnr", "lap_loss",
                                         "warping_loss"}
    from flax.traverse_util import flatten_dict

    from atmvfi_tpu_torch.models import Network, get_config

    flat = {"/".join(k): v for k, v in flatten_dict(tree).items()}
    sd = params_from_jax(flat)
    net = Network(get_config("lite"))
    net.load_state_dict(sd, strict=True)
    init = Network(get_config("lite"), torch.Generator().manual_seed(3))
    moved = [k for k, v in init.state_dict().items()
             if not torch.equal(v, sd[k])]
    assert any(k.startswith("local_motion") for k in moved)
    assert not any(k.startswith("global_motion") for k in moved)
