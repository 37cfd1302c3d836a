"""Pose-consistency loss, with injected detector and pose network
(`atmvfi_tpu/losses/pose.py`).

detector: (ground-truth batch [B, H, W, 3] in [0, 1]) -> per-sample raw
boxes [N, 6] (xmin, ymin, xmax, ymax, conf, cls) or None; pose_fn:
(crops [M, 256, 192, 3]) -> heatmaps [M, K, h, w]. The box filtering,
ImageNet normalisation, crop, 3:4 pad and bilinear resize run on the
host in numpy, as in the JAX package, so neither image's crops carry a
gradient into the network: the loss moves only what `pose_fn` holds.
Mode 1 is the masked per-pixel cross entropy, mode 2 (the default) the
channelwise KL. Without both callables the loss is 0.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from atmvfi_tpu_torch.ops.resize import resize_bilinear

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def process_boxes(raw: np.ndarray, H: int, W: int,
                  conf_thresh: float = 0.35, pad: int = 10) -> np.ndarray:
    """Keep conf >= thresh and cls == 0, round to int, pad by `pad` px,
    clamp to the image."""
    raw = np.asarray(raw, np.float32).reshape(-1, 6)
    keep = (raw[:, 4] >= conf_thresh) & (raw[:, 5] == 0)
    b = np.round(raw[keep]).astype(np.int64)
    b[:, [0, 2]] = np.clip(b[:, [0, 2]] + np.array([-pad, pad]), 0, W)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]] + np.array([-pad, pad]), 0, H)
    return b


def _pad_to_aspect(crop: np.ndarray, aspect: float = 3.0 / 4.0):
    """Zero-pad [h, w, 3] to width / height == aspect."""
    h, w = crop.shape[:2]
    if w / h < aspect:
        pw = int(aspect * h) - w
        left = pw // 2
        return np.pad(crop, ((0, 0), (left, pw - left), (0, 0))), (left, 0)
    ph = int(w / aspect) - h
    top = ph // 2
    return np.pad(crop, ((top, ph - top), (0, 0), (0, 0))), (0, top)


def _numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().float().cpu().numpy()
    return np.asarray(img, np.float32)


def prepare_crops(img, boxes_per_sample: Sequence[np.ndarray],
                  resize_hw=(256, 192), max_batch: int = 64,
                  device=None) -> Optional[torch.Tensor]:
    """Normalise, crop each box, pad to 3:4, resize to 256x192 -> [M,
    256, 192, 3] (M <= max_batch) on `device` (img's when None), or None
    when no box survives. No gradient flows back into img."""
    if device is None:
        device = img.device if isinstance(img, torch.Tensor) else "cpu"
    img = (_numpy(img) - _IMAGENET_MEAN) / _IMAGENET_STD
    crops: List[np.ndarray] = []
    for b, boxes in enumerate(boxes_per_sample):
        for box in np.asarray(boxes).reshape(
                -1, boxes.shape[-1] if len(boxes) else 4):
            x0, y0, x1, y1 = (int(v) for v in box[:4])
            if x1 <= x0 or y1 <= y0:
                continue
            padded, _ = _pad_to_aspect(img[b, y0:y1, x0:x1])
            resized = resize_bilinear(torch.from_numpy(
                np.ascontiguousarray(padded, np.float32))[None], *resize_hw)
            crops.append(resized[0].numpy())
    crops = crops[:max_batch]
    if not crops:
        return None
    return torch.from_numpy(np.stack(crops)).to(device)


def pose_mask(gt_hm: torch.Tensor, threshold: float = 0.9,
              kp_threshold: float = 1.2) -> torch.Tensor:
    """gt_hm [N, K, h, w] -> [N, h, w]: 1 where the pixel's argmax class
    peaks above kp_threshold somewhere and the pixel reaches threshold x
    that class's peak."""
    mx, cls = torch.amax(gt_hm, 1), torch.argmax(gt_hm, 1)
    a = torch.amax(gt_hm, (2, 3))  # [N, K]
    valid = a > kp_threshold
    N, h, w = mx.shape
    flat = cls.reshape(N, h * w)
    a_pix = torch.gather(a, 1, flat).reshape(N, h, w)
    v_pix = torch.gather(valid, 1, flat).reshape(N, h, w)
    return (v_pix & (mx >= threshold * a_pix)).to(gt_hm.dtype)


def heatmap_ce_loss(pred_hm: torch.Tensor, gt_hm: torch.Tensor):
    """Per-pixel CE over the K channels against the gt argmax, masked,
    mean over all pixels."""
    gt_hm = gt_hm.detach()
    label = torch.argmax(gt_hm, 1)
    log_p = torch.log_softmax(pred_hm, 1)
    ce = -torch.gather(log_p, 1, label[:, None])[:, 0]
    return torch.mean(ce * pose_mask(gt_hm))


def heatmap_kl_loss(pred_hm: torch.Tensor, gt_hm: torch.Tensor):
    """Channelwise softmax KL, mean over every element."""
    gt_hm = gt_hm.detach()
    p = torch.log_softmax(pred_hm, 1)
    q = torch.softmax(gt_hm, 1)
    return torch.mean(q * (torch.log(torch.clamp(q, min=1e-38)) - p))


class PoseLoss:
    """(pred image, gt image) -> heatmap consistency loss."""

    def __init__(self, detector: Optional[Callable] = None,
                 pose_fn: Optional[Callable] = None, mode: int = 2,
                 max_batch: int = 64):
        self.detector = detector
        self.pose_fn = pose_fn
        self.mode = mode
        self.max_batch = max_batch

    @property
    def available(self) -> bool:
        return self.detector is not None and self.pose_fn is not None

    def heatmap_loss(self, pred_hm, gt_hm):
        if self.mode == 2:
            return heatmap_kl_loss(pred_hm, gt_hm)
        return heatmap_ce_loss(pred_hm, gt_hm)

    def __call__(self, pred_img, gt_img) -> torch.Tensor:
        dev = pred_img.device if isinstance(pred_img, torch.Tensor) else "cpu"
        if not self.available:
            return torch.zeros((), device=dev)
        B, H, W = gt_img.shape[:3]
        raw = self.detector(gt_img)
        boxes = [process_boxes(r, H, W) if r is not None and len(r)
                 else np.zeros((0, 6), np.int64)
                 for r in (raw if raw is not None else [None] * B)]
        gt_crops = prepare_crops(gt_img, boxes, max_batch=self.max_batch,
                                 device=dev)
        if gt_crops is None:
            return torch.zeros((), device=dev)
        pred_crops = prepare_crops(pred_img, boxes, max_batch=self.max_batch,
                                   device=dev)
        return self.heatmap_loss(self.pose_fn(pred_crops),
                                 self.pose_fn(gt_crops))
