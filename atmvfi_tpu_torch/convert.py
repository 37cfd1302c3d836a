"""Weights into the port: JAX parameter trees, reference .pt, native .npz.

The port's module names are the reference model's state_dict names, so
every source maps onto one `state_dict` that loads with `strict=True`:

* `params_from_jax(flat)`: a JAX `params` tree flattened to numpy,
  {'/'-joined flax path: array}, with the layout transforms
  HWIO -> OIHW (conv), (kh, kw, I, O) -> (I, O, kh, kw) (deconv) and
  (in, out) -> (out, in) (dense). This is the port's own copy of the
  key map of `atmvfi_tpu/convert/torch_export.py`.
* `load_checkpoint(path)`: a reference-format .pt, wrapped
  ({'model_state_dict': ...}) or raw, without the cached
  resolution-dependent buffers (`relative_coord`, `attn_mask`, `HW`).
* `load_npz(path)`: the .npz that the JAX package's `save_params_npz`
  writes (read with numpy only).
"""
from __future__ import annotations

import json
import re
from typing import Dict, Tuple

import numpy as np
import torch

STRIP_BUFFER_SUFFIXES = ("relative_coord", "attn_mask", "HW")
_NPZ_META_KEY = "__meta__"

_INNER = {
    "norm1/scale": ("norm1.weight", "direct"),
    "norm1/bias": ("norm1.bias", "direct"),
    "norm2/scale": ("norm2.weight", "direct"),
    "norm2/bias": ("norm2.bias", "direct"),
    "attn/q/kernel": ("attn.q.weight", "linear"),
    "attn/q/bias": ("attn.q.bias", "direct"),
    "attn/kv/kernel": ("attn.kv.weight", "linear"),
    "attn/kv/bias": ("attn.kv.bias", "direct"),
    "attn/qkv/kernel": ("attn.qkv.weight", "linear"),
    "attn/qkv/bias": ("attn.qkv.bias", "direct"),
    "attn/proj/kernel": ("attn.proj.weight", "linear"),
    "attn/proj/bias": ("attn.proj.bias", "direct"),
    "attn/mlp_fc1/kernel": ("attn.mlp.0.weight", "linear"),
    "attn/mlp_fc1/bias": ("attn.mlp.0.bias", "direct"),
    "attn/mlp_fc2/kernel": ("attn.mlp.2.weight", "linear"),
    "attn/mlp_fc2/bias": ("attn.mlp.2.bias", "direct"),
    "mlp/fc1/kernel": ("mlp.fc1.weight", "linear"),
    "mlp/fc1/bias": ("mlp.fc1.bias", "direct"),
    "mlp/fc2/kernel": ("mlp.fc2.weight", "linear"),
    "mlp/fc2/bias": ("mlp.fc2.bias", "direct"),
    "mlp/dwconv/dwconv/kernel": ("mlp.dwconv.dwconv.weight", "conv"),
    "mlp/dwconv/dwconv/bias": ("mlp.dwconv.dwconv.bias", "direct"),
}


def _transform(kind: str, arr: np.ndarray) -> np.ndarray:
    if kind == "conv":  # HWIO -> OIHW
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "deconv":  # (kh, kw, I, O) -> (I, O, kh, kw)
        return np.transpose(arr, (2, 3, 0, 1))
    if kind == "linear":  # (in, out) -> (out, in)
        return np.transpose(arr, (1, 0))
    return arr


def _seq(prefix: str, leaf: str) -> Tuple[str, str]:
    """ConvPReLU (conv/kernel, conv/bias, prelu) or Deconv2x (kernel,
    bias, prelu) leaves -> `prefix.0.*` / `prefix.1.weight`."""
    table = {
        "conv/kernel": (f"{prefix}.0.weight", "conv"),
        "conv/bias": (f"{prefix}.0.bias", "direct"),
        "prelu": (f"{prefix}.1.weight", "direct"),
        "kernel": (f"{prefix}.0.weight", "deconv"),
        "bias": (f"{prefix}.0.bias", "direct"),
    }
    return table[leaf]


def _plain(prefix: str, leaf: str) -> Tuple[str, str]:
    """A bare conv (kernel, bias) -> `prefix.weight` / `prefix.bias`."""
    return ((f"{prefix}.weight", "conv") if leaf == "kernel"
            else (f"{prefix}.bias", "direct"))


def map_flax_key(path: str) -> Tuple[str, str]:
    """'/'-joined flax param path -> (port state_dict key, transform)."""
    m = re.match(r"^feat_extracts_(\d+)/(.+)$", path)
    if m:
        k = int(m.group(1))
        return _seq(f"feat_extracts.{k // 2}.{k % 2}", m.group(2))
    m = re.match(r"^(cross_scale_feature_fusion|global_feature_fusion)/(.+)$",
                 path)
    if m:
        mod, rest = m.groups()
        m2 = re.match(r"^layers_(\d+)/(kernel|bias)$", rest)
        if m2:
            return _plain(f"{mod}.layers.{m2.group(1)}", m2.group(2))
        table = {
            "proj/kernel": (f"{mod}.proj.weight", "conv"),
            "proj/bias": (f"{mod}.proj.bias", "direct"),
            "norm/scale": (f"{mod}.norm.weight", "direct"),
            "norm/bias": (f"{mod}.norm.bias", "direct"),
        }
        return table[rest]
    m = re.match(r"^(feat_enhance_transformer|local_motion_atmformer|"
                 r"global_motion_atmformer)_(\d+)/(.+)$", path)
    if m:
        mod, k, rest = m.groups()
        name, kind = _INNER[rest]
        return f"{mod}.{k}.{name}", kind
    m = re.match(r"^(local_motion_mlp|global_motion_mlp)_(\d+)/(.+)$", path)
    if m:
        mod, k, rest = m.group(1), int(m.group(2)), m.group(3)
        if k == 2:
            return _plain(f"{mod}.2", rest)
        return _seq(f"{mod}.{k}", rest)
    m = re.match(r"^(last_feat_extract|down1|down2|down3|refine_head)_(\d+)/"
                 r"(.+)$", path)
    if m:
        return _seq(f"{m.group(1)}.{m.group(2)}", m.group(3))
    m = re.match(r"^refine_proj/(.+)$", path)
    if m:
        return _seq("proj", m.group(1))
    m = re.match(r"^upsample(\d)_(\d)/(.+)$", path)
    if m:
        stage, idx, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        pre = "upsample_pyramid"
        if stage == 0:  # (deconv, conv, plain conv)
            if idx == 2:
                return _plain(f"{pre}.0.2", rest)
            return _seq(f"{pre}.0.{idx}", rest)
        # (PReLU, deconv, conv, plain conv)
        if idx == 0:
            return f"{pre}.{stage}.0.weight", "direct"
        if idx == 3:
            return _plain(f"{pre}.{stage}.3", rest)
        return _seq(f"{pre}.{stage}.{idx}", rest)
    m = re.match(r"^(up1|up2|up3)_(\d)/(.+)$", path)
    if m:
        return _seq(f"{m.group(1)}.{m.group(2)}", m.group(3))
    raise KeyError(f"no port mapping for flax path {path!r}")


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{'/'-joined flax param path: array} -> the port's state_dict.

    A leading 'params/' (the flattened `variables` dict) is accepted."""
    out = {}
    for path, arr in flat.items():
        if path.startswith("params/"):
            path = path[len("params/"):]
        key, kind = map_flax_key(path)
        out[key] = torch.from_numpy(
            np.ascontiguousarray(_transform(kind, np.asarray(arr, np.float32))))
    return out


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Reference-format .pt -> (state_dict, meta). Accepts the wrapped
    trainer format and a raw state_dict; drops the cached buffers."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    meta = {}
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
        meta = {k: v for k, v in ckpt.items()
                if k not in ("model_state_dict", "optimizer_state_dict")}
    else:
        sd = ckpt
    sd = {k: v.float() for k, v in sd.items()
          if not k.endswith(STRIP_BUFFER_SUFFIXES)}
    return sd, meta


def load_npz(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """JAX `save_params_npz` file -> (the port's state_dict, meta)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != _NPZ_META_KEY}
        meta = (json.loads(bytes(data[_NPZ_META_KEY]).decode())
                if _NPZ_META_KEY in data.files else {})
    return params_from_jax(flat), meta
