"""Benchmark harnesses: Vimeo90K, UCF101, SNU-FILM, Xiph, DAVIS.

The port's counterpart of `atmvfi_tpu/evalkit/harness.py`, with every
protocol quirk kept:

  Vimeo90K:  global_motion=False (the caller's pipeline), no padding
             (448x256 divides by 64), ssim_matlab on the float
             prediction, PSNR in f64 numpy
  UCF101:    global_motion=False, SSIM on the ROUNDED uint8 prediction
  SNU-FILM:  global_motion=True, pad divisor 64, four difficulty splits
  Xiph:      global_motion=True, pad divisor 32; categories resized-2k
             (2048x1080, Pillow's BOX filter ported in numpy) and
             cropped-4k (center crop)
  DAVIS:     recursive 4x slow motion

Each runner takes an `InterpolationPipeline` and a data root and returns
mean PSNR / SSIM (per split where there are splits). Frames go to the
pipeline's device as NHWC f32 in [0, 1] and the metrics run there
(`evalkit.metrics`). TTA (the doubly flipped average) is available
everywhere. Images are read with the port's own PNG reader.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from atmvfi_tpu_torch.evalkit import metrics
from atmvfi_tpu_torch.infer.padder import InputPadder
from atmvfi_tpu_torch.utils.images import read_image
from atmvfi_tpu_torch.utils.meters import AverageMeter
from atmvfi_tpu_torch.utils.resample import pillow_resize


def _flip(t: torch.Tensor) -> torch.Tensor:
    return t.flip((1, 2))


def _forward_tta(pipeline, x0, x1, tta: bool, tta_swaporder: bool = False):
    """The middle frame, with the doubly flipped TTA average and the
    frame-order swap average where asked (the reference's --TTA path
    calls a `model.inference` that does not exist; this is what it
    meant)."""
    pred = pipeline.interpolate_device(x0, x1)
    if tta:
        pred_f = pipeline.interpolate_device(_flip(x0), _flip(x1))
        pred = (pred + _flip(pred_f)) / 2
    if tta_swaporder:
        pred_sa = pipeline.interpolate_device(x1, x0)
        pred_sa_f = pipeline.interpolate_device(_flip(x1), _flip(x0))
        pred_sa = (pred_sa + _flip(pred_sa_f)) / 2
        pred = (pred + pred_sa) / 2
    return pred


def _to_unit(img: np.ndarray, device) -> torch.Tensor:
    """uint8 [H, W, 3] -> f32 [1, H, W, 3] in [0, 1] on `device`."""
    return torch.from_numpy(np.ascontiguousarray(img)).to(
        device).float()[None] / 255.0


def _psnr_f64(gt: np.ndarray, pred: np.ndarray) -> float:
    return -10 * math.log10(((gt - pred) ** 2).mean())


class _SteadyTimer:
    """Per-item forward timer that leaves out the first call of each
    input shape.

    A runner's `seconds` / `fps` are wall clock over the whole run: they
    hold the first calls (cuDNN plans, the cached masks), image reading
    and the metrics. `steady_fps` counts only the later forward calls,
    each ended by `torch.cuda.synchronize(device)` on the card, metric
    math left out.
    """

    def __init__(self, device):
        self._seen = set()
        self.device = torch.device(device)
        self.steady = 0.0
        self.n = 0

    def run(self, key, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if key in self._seen:
            self.steady += dt
            self.n += 1
        else:
            self._seen.add(key)
        return out

    @property
    def fps(self) -> float:
        return self.n / self.steady if self.steady > 0 else 0.0


def run_vimeo90k(pipeline, path: str, tta: bool = False,
                 limit: Optional[int] = None, progress: bool = True,
                 tta_swaporder: bool = False) -> Dict:
    """test_vimeo90k.py protocol (global motion off: the caller's)."""
    t_start = time.time()
    dev = pipeline.device
    timer = _SteadyTimer(dev)
    psnr_m, ssim_m = AverageMeter(), AverageMeter()
    with open(os.path.join(path, "tri_testlist.txt")) as f:
        names = [ln.strip() for ln in f if len(ln.strip()) > 1]
    if limit:
        names = names[:limit]
    for i, name in enumerate(names):
        base = os.path.join(path, "sequences", name)
        I0 = _to_unit(read_image(os.path.join(base, "im1.png")), dev)
        I1 = read_image(os.path.join(base, "im2.png"))
        I2 = _to_unit(read_image(os.path.join(base, "im3.png")), dev)
        pred = timer.run(tuple(I0.shape), lambda: _forward_tta(
            pipeline, I0, I2, tta, tta_swaporder))
        ssim = float(metrics.ssim_matlab(_to_unit(I1, dev), pred))
        mid = pred[0].double().cpu().numpy()
        psnr = _psnr_f64(I1.astype(np.float64) / 255.0, mid)
        psnr_m.update(psnr)
        ssim_m.update(ssim)
        if progress:
            print(f"{i+1}/{len(names)} psnr {psnr_m.avg:.4f}", end="\r")
    dt = time.time() - t_start
    return {"psnr": psnr_m.avg, "ssim": ssim_m.avg, "n": len(names),
            "seconds": dt, "fps": len(names) / dt if dt else 0.0,
            "steady_fps": timer.fps}


def run_ucf101(pipeline, path: str, tta: bool = False,
               limit: Optional[int] = None) -> Dict:
    """test_ucf101.py protocol: SSIM on the rounded prediction."""
    t_start = time.time()
    dev = pipeline.device
    timer = _SteadyTimer(dev)
    psnr_m, ssim_m = AverageMeter(), AverageMeter()
    dirs = sorted(os.listdir(path))
    if limit:
        dirs = dirs[:limit]
    for d in dirs:
        img0, img1, gt = (
            _to_unit(read_image(os.path.join(path, d, f)), dev)
            for f in ("frame_00.png", "frame_02.png", "frame_01_gt.png"))
        pred = timer.run(tuple(img0.shape),
                         lambda: _forward_tta(pipeline, img0, img1, tta))
        rounded = torch.round(pred * 255.0) / 255.0
        ssim = float(metrics.ssim_matlab(gt, rounded))
        psnr = _psnr_f64(gt[0].double().cpu().numpy(),
                         rounded[0].double().cpu().numpy())
        psnr_m.update(psnr)
        ssim_m.update(ssim)
    dt = time.time() - t_start
    return {"psnr": psnr_m.avg, "ssim": ssim_m.avg, "n": len(dirs),
            "seconds": dt, "fps": len(dirs) / dt if dt else 0.0,
            "steady_fps": timer.fps}


SNU_SPLITS = ("easy", "medium", "hard", "extreme")


def run_snufilm(pipeline, path: str, img_data_path: str = "",
                splits=SNU_SPLITS, tta: bool = False,
                limit: Optional[int] = None) -> Dict:
    """test_snufilm.py protocol: pad 64, four difficulty splits."""
    dev = pipeline.device
    results = {}
    for split in splits:
        t_start = time.time()
        timer = _SteadyTimer(dev)
        psnr_m, ssim_m = AverageMeter(), AverageMeter()
        file_list = []
        with open(os.path.join(path, f"test-{split}.txt")) as f:
            for line in f:
                line = line.replace("data/SNU-FILM/test/",
                                    img_data_path).strip()
                if line:
                    file_list.append(line.split(" "))
        if limit:
            file_list = file_list[:limit]
        for p0, p1, p2 in file_list:
            I0, I1, I2 = (_to_unit(read_image(os.path.join(path, p)), dev)
                          for p in (p0, p1, p2))
            padder = InputPadder(I0.shape, divisor=64)
            I0p, I2p = padder.pad(I0, I2)
            pred = padder.unpad(timer.run(tuple(I0p.shape), lambda: (
                _forward_tta(pipeline, I0p, I2p, tta))))
            ssim = float(metrics.ssim_matlab(I1, pred))
            psnr = _psnr_f64(I1[0].double().cpu().numpy(),
                             pred[0].double().cpu().numpy())
            psnr_m.update(psnr)
            ssim_m.update(ssim)
        dt = time.time() - t_start
        results[split] = {"psnr": psnr_m.avg, "ssim": ssim_m.avg,
                          "n": len(file_list), "seconds": dt,
                          "fps": len(file_list) / dt if dt else 0.0,
                          "steady_fps": timer.fps}
    return results


XIPH_CLIPS = ("BoxingPractice", "Crosswalk", "DrivingPOV", "FoodMarket",
              "FoodMarket2", "RitualDance", "SquareAndTimelapse", "Tango")


def run_xiph(pipeline, root: str, categories=("resized-2k", "cropped-4k"),
             tta: bool = False, clips=XIPH_CLIPS,
             frame_limit: Optional[int] = None, resize_to=(2048, 1080),
             crop_margin=(540, 1024)) -> Dict:
    """test_xiph.py protocol: pad 32, even frames from odd neighbours.

    Expects `root/<clip>/NNN.png` frame dumps (`utils.video.
    prepare_xiph` stages them from .y4m sources)."""
    dev = pipeline.device
    results = {}
    for category in categories:
        t_start = time.time()
        timer = _SteadyTimer(dev)
        psnr_m, ssim_m = AverageMeter(), AverageMeter()
        for clip in clips:
            d = os.path.join(root, clip)
            if not os.path.isdir(d):
                continue
            frames = list(range(2, 99, 2))
            if frame_limit is not None:
                frames = frames[:frame_limit]
            for t in frames:
                try:
                    img0 = read_image(f"{d}/{t-1:03d}.png")
                    img1 = read_image(f"{d}/{t+1:03d}.png")
                    imgt = read_image(f"{d}/{t:03d}.png")
                except FileNotFoundError:
                    continue
                if category == "resized-2k":
                    img0, img1, imgt = (pillow_resize(im, *resize_to, "box")
                                        for im in (img0, img1, imgt))
                else:  # cropped-4k: center crop
                    mh, mw = crop_margin
                    img0, img1, imgt = (im[mh:-mh, mw:-mw]
                                        for im in (img0, img1, imgt))
                x0, x1, xt = (_to_unit(im, dev) for im in (img0, img1, imgt))
                padder = InputPadder(x0.shape, divisor=32)
                x0p, x1p = padder.pad(x0, x1)
                pred = padder.unpad(timer.run(tuple(x0p.shape), lambda: (
                    _forward_tta(pipeline, x0p, x1p, tta))))
                psnr_m.update(float(metrics.psnr(pred, xt)))
                ssim_m.update(float(metrics.ssim_matlab(pred, xt)))
        dt = time.time() - t_start
        results[category] = {"psnr": psnr_m.avg, "ssim": ssim_m.avg,
                             "n": psnr_m.count, "seconds": dt,
                             "fps": psnr_m.count / dt if dt else 0.0,
                             "steady_fps": timer.fps}
    return results


def run_davis_4x(pipeline, frames: List[np.ndarray]) -> List[np.ndarray]:
    """Recursive 4x slow motion (davis-vid.py:102-106): between each
    consecutive pair emit [f_i, p025, p05, p075], then the last frame."""
    dev = pipeline.device
    out = []
    for a, b in zip(frames[:-1], frames[1:]):
        x0, x1 = _to_unit(a, dev), _to_unit(b, dev)
        padder = InputPadder(x0.shape, divisor=64)
        x0p, x1p = padder.pad(x0, x1)
        mid = pipeline.interpolate_device(x0p, x1p)
        q1 = pipeline.interpolate_device(x0p, mid)
        q3 = pipeline.interpolate_device(mid, x1p)
        out.append(a)
        for t in (q1, mid, q3):
            out.append(torch.round(torch.clamp(padder.unpad(t)[0], 0, 1)
                                   * 255).to(torch.uint8).cpu().numpy())
    out.append(frames[-1])
    return out
