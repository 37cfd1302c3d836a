"""Datasets: Vimeo90K triplets, X4K1000FPS clips, SNU-FILM
(`atmvfi_tpu/data/datasets.py`).

Items are NHWC float32 [0, 1] numpy triplets `(img0, gt, img1)`, read
through the port's `utils.images.read_image`. The augmentations draw
from a `random.Random(seed)` per dataset with the JAX package's calls
in its order, so a dataset read in the same order gives the same items:

  Vimeo train:  random square crop (256 at 1x), temporal reversal,
                v-flip, h-flip, 0 / 90 / 180 / 270 rotation
  X4K train:    triplet (i, i+t, i+t/2) with random t in [min_t, max_t],
                random crop, h-flip, rot90, reversal
  SNU-FILM:     test only; replicate-pads to divisor 64 in the dataset

Vimeo at `scale_factor > 1` resizes with Pillow's BILINEAR, ported
exactly (`utils.resample`), so no Pillow is needed.
"""
from __future__ import annotations

import glob
import os
import random
from typing import List, Optional, Tuple

import numpy as np

from atmvfi_tpu_torch.utils.images import read_image
from atmvfi_tpu_torch.utils.resample import pillow_resize

Triplet = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _to_float(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img, dtype=np.float32) / 255.0


class VimeoDataset:
    """Vimeo90K triplets (train / test splits from tri_*list.txt)."""

    def __init__(self, split: str, path: str, scale_factor: int = 1,
                 train_crop: Optional[int] = None, seed: int = 0):
        self.split = split
        self.data_root = path
        self.image_root = os.path.join(path, "sequences")
        list_file = os.path.join(path, "tri_trainlist.txt" if split != "test"
                                 else "tri_testlist.txt")
        with open(list_file) as f:
            self.meta_data = [l for l in f.read().splitlines() if len(l) > 1]
        self.scale_factor = scale_factor
        if train_crop is None:
            train_crop = {1: 256, 2: 384}.get(scale_factor, 448)
        self.train_crop = train_crop
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.meta_data)

    def _read(self, index: int):
        base = os.path.join(self.image_root, self.meta_data[index])
        imgs = [read_image(os.path.join(base, f"im{i}.png"))
                for i in (1, 2, 3)]
        if self.scale_factor > 1:
            w, h = 448 * self.scale_factor, 256 * self.scale_factor
            imgs = [pillow_resize(im, w, h, "bilinear") for im in imgs]
        return imgs

    def __getitem__(self, index: int) -> Triplet:
        img0, gt, img1 = self._read(index)
        if "train" in self.split:
            rng = self.rng
            h = w = self.train_crop
            ih, iw = img0.shape[:2]
            x = rng.randint(0, ih - h)
            y = rng.randint(0, iw - w)
            img0, gt, img1 = (im[x:x + h, y:y + w] for im in (img0, gt, img1))
            if rng.random() < 0.5:  # temporal reversal
                img0, img1 = img1, img0
            if rng.random() < 0.5:  # vertical flip
                img0, gt, img1 = (im[::-1] for im in (img0, gt, img1))
            if rng.random() < 0.5:  # horizontal flip
                img0, gt, img1 = (im[:, ::-1] for im in (img0, gt, img1))
            p = rng.random()
            if p < 0.75:  # 90 cw / 180 / 90 ccw
                k = {0: 3, 1: 2, 2: 1}[int(p * 4)]  # np.rot90 is ccw
                img0, gt, img1 = (np.rot90(im, k) for im in (img0, gt, img1))
        return _to_float(img0), _to_float(gt), _to_float(img1)


def _x4k_scan_train(root: str) -> List[List[str]]:
    clips = []
    for scene in sorted(glob.glob(os.path.join(root, "*", ""))):
        for sample in sorted(glob.glob(os.path.join(scene, "*", ""))):
            frames = sorted(glob.glob(os.path.join(sample, "*.png")))
            if frames:
                clips.append(frames)
    return clips


def _x4k_scan_test(root: str, multiple: int, t_step_size: int):
    items = []
    ts = np.linspace(1 / multiple, 1 - 1 / multiple, multiple - 1)
    for type_folder in sorted(glob.glob(os.path.join(root, "*", ""))):
        for scene in sorted(glob.glob(os.path.join(type_folder, "*", ""))):
            frames = sorted(glob.glob(os.path.join(scene, "*.png")))
            for idx in range(0, len(frames), t_step_size):
                if idx == len(frames) - 1:
                    break
                for mul in range(multiple - 1):
                    items.append((
                        frames[idx], frames[idx + t_step_size],
                        frames[idx + (t_step_size // multiple) * (mul + 1)],
                        float(ts[mul])))
    return items


class X4KTrain:
    """X4K1000FPS 65-frame training clips."""

    def __init__(self, root: str, max_t_step_size: int = 32,
                 min_t_step_size: int = 8, random_crop: bool = True,
                 patch_size: int = 512, seed: int = 0):
        self.clips = _x4k_scan_train(root)
        if not self.clips:
            raise RuntimeError(f"no X4K training clips under {root}")
        self.max_t = max_t_step_size
        self.min_t = min_t_step_size
        self.random_crop = random_crop
        self.patch_size = patch_size
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, idx: int) -> Triplet:
        rng = self.rng
        t = rng.randint(self.min_t, self.max_t)
        frames = self.clips[idx]
        first = rng.randint(0, 64 - t)
        inter = first + t // 2
        if rng.randint(0, 1):
            order = (first, first + t, inter)
        else:  # temporally reversed
            order = (first + t, first, inter)
        imgs = np.stack([read_image(frames[i]) for i in order], 0)
        if self.random_crop:
            ps = self.patch_size
            ih, iw = imgs.shape[1:3]
            ix = rng.randrange(0, iw - ps + 1)
            iy = rng.randrange(0, ih - ps + 1)
            imgs = imgs[:, iy:iy + ps, ix:ix + ps]
        if rng.random() < 0.5:
            imgs = imgs[:, :, ::-1]
        imgs = np.rot90(imgs, rng.randint(0, 3), (1, 2))
        return _to_float(imgs[0]), _to_float(imgs[2]), _to_float(imgs[1])


class X4KTest:
    """X4K1000FPS test protocol (t_step 32, centre crop 512)."""

    def __init__(self, root: str, multiple: int = 2, validation: bool = True):
        self.items = _x4k_scan_test(root, multiple, t_step_size=32)
        if not self.items:
            raise RuntimeError(f"no X4K test items under {root}")
        self.validation = validation

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Triplet:
        p0, p1, pt, _t = self.items[idx]
        imgs = np.stack([read_image(p) for p in (p0, p1, pt)], 0)
        if self.validation:
            ps = 512
            ih, iw = imgs.shape[1:3]
            iy, ix = (ih - ps) // 2, (iw - ps) // 2
            imgs = imgs[:, iy:iy + ps, ix:ix + ps]
        return _to_float(imgs[0]), _to_float(imgs[2]), _to_float(imgs[1])


class SNUFilmDataset:
    """SNU-FILM difficulty split; pads to divisor 64 in the dataset."""

    def __init__(self, difficulty: str = "hard", path: str = "",
                 img_data_path: str = "", pad_divisor: int = 64):
        self.path = path
        self.pad_divisor = pad_divisor
        self.file_list = []
        with open(os.path.join(path, f"test-{difficulty}.txt")) as f:
            for line in f:
                line = line.replace("data/SNU-FILM/test/",
                                    img_data_path).strip()
                if line:
                    self.file_list.append(line.split(" "))

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index: int) -> Triplet:
        paths = [os.path.join(self.path, p) for p in self.file_list[index]]
        imgs = [_to_float(read_image(p)) for p in paths]
        h, w = imgs[0].shape[:2]
        d = self.pad_divisor
        pad_h = (((h // d) + 1) * d - h) % d
        pad_w = (((w // d) + 1) * d - w) % d
        pads = ((pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2), (0, 0))
        imgs = [np.pad(im, pads, mode="edge") for im in imgs]
        return imgs[0], imgs[1], imgs[2]
