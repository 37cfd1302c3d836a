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

And out of the port, the inverse of each:

* `params_to_jax(state_dict)`: {'/'-joined flax param path: array}, the
  inverse of `params_from_jax` (every path checked to map back onto its
  key through `map_flax_key`); buffers the JAX params do not hold
  (`STRIP_BUFFER_SUFFIXES`) are dropped.
* `save_npz(path, state_dict, meta)`: the .npz that the JAX package's
  `save_params_npz` writes of {'params': ...} ('params/'-prefixed
  '/'-joined flax keys, `__meta__` as JSON bytes).
* `save_checkpoint(path, state_dict, meta)`: the reference's wrapped .pt
  ({'model_state_dict': ..., 'optimizer_state_dict': None,
  'meta_data': ..., 'train_metric': {}, 'val_metric': {}}).
"""
from __future__ import annotations

import json
import re
from typing import Dict, Optional, Tuple

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


# torch module prefixes whose (0, 1) children are a ConvTranspose2d and a
# PReLU (flax `Deconv2x`: kernel, bias, prelu) rather than a conv
_DECONV_SEQ = re.compile(r"^(upsample_pyramid\.0\.0|"
                         r"upsample_pyramid\.[1-9]\d*\.1|up[123]\.0)$")
_INNER_INV = {torch_name: flax for flax, (torch_name, _) in _INNER.items()}


def _flax_seq(flax_prefix: str, torch_prefix: str, leaf: str) -> str:
    """A conv / deconv + PReLU sequence's leaf ('0.weight', '0.bias',
    '1.weight') -> its flax path."""
    if leaf == "1.weight":
        return f"{flax_prefix}/prelu"
    name = {"0.weight": "kernel", "0.bias": "bias"}[leaf]
    if _DECONV_SEQ.match(torch_prefix):
        return f"{flax_prefix}/{name}"
    return f"{flax_prefix}/conv/{name}"


def flax_path_of(key: str) -> str:
    """The port's state_dict key -> its '/'-joined flax param path (the
    inverse of `map_flax_key`'s key)."""
    m = re.match(r"^feat_extracts\.(\d+)\.(\d+)\.(.+)$", key)
    if m:
        k = 2 * int(m.group(1)) + int(m.group(2))
        return _flax_seq(f"feat_extracts_{k}", key, m.group(3))
    m = re.match(r"^(cross_scale_feature_fusion|global_feature_fusion)\."
                 r"(layers\.(\d+)|proj|norm)\.(weight|bias)$", key)
    if m:
        mod, part, k, wb = m.group(1), m.group(2), m.group(3), m.group(4)
        if part == "norm":
            return f"{mod}/norm/{'scale' if wb == 'weight' else 'bias'}"
        sub = f"layers_{k}" if k is not None else "proj"
        return f"{mod}/{sub}/{'kernel' if wb == 'weight' else 'bias'}"
    m = re.match(r"^(feat_enhance_transformer|local_motion_atmformer|"
                 r"global_motion_atmformer)\.(\d+)\.(.+)$", key)
    if m:
        return f"{m.group(1)}_{m.group(2)}/{_INNER_INV[m.group(3)]}"
    m = re.match(r"^(local_motion_mlp|global_motion_mlp|up1|up2|up3|"
                 r"last_feat_extract|down1|down2|down3|refine_head|"
                 r"upsample_pyramid\.\d+)\.(\d+)\.(.+)$", key)
    if m:
        mod, k, rest = m.group(1), int(m.group(2)), m.group(3)
        flax_mod = (f"upsample{mod.split('.')[1]}" if mod.startswith(
            "upsample") else mod)
        prefix = f"{flax_mod}_{k}"
        plain = ((mod.endswith("motion_mlp") and k == 2)
                 or (mod == "upsample_pyramid.0" and k == 2)
                 or (mod.startswith("upsample_pyramid.") and k == 3))
        if plain:
            return f"{prefix}/{'kernel' if rest == 'weight' else 'bias'}"
        if mod.startswith("upsample_pyramid.") and mod != \
                "upsample_pyramid.0" and k == 0:
            return f"{prefix}/prelu"
        return _flax_seq(prefix, f"{mod}.{k}", rest)
    m = re.match(r"^proj\.(.+)$", key)
    if m:
        return _flax_seq("refine_proj", "proj", m.group(1))
    raise KeyError(f"no flax path for port key {key!r}")


def _inverse(kind: str, arr: np.ndarray) -> np.ndarray:
    if kind == "conv":  # OIHW -> HWIO
        return np.transpose(arr, (2, 3, 1, 0))
    if kind == "deconv":  # (I, O, kh, kw) -> (kh, kw, I, O)
        return np.transpose(arr, (2, 3, 0, 1))
    if kind == "linear":  # (out, in) -> (in, out)
        return np.transpose(arr, (1, 0))
    return arr


def params_to_jax(state_dict) -> Dict[str, np.ndarray]:
    """The port's state_dict -> {'/'-joined flax param path: f32 array},
    the inverse of `params_from_jax`; cached buffers are dropped."""
    out = {}
    for key, value in state_dict.items():
        if key.endswith(STRIP_BUFFER_SUFFIXES):
            continue
        path = flax_path_of(key)
        back, kind = map_flax_key(path)
        if back != key:
            raise KeyError(f"{key!r} -> {path!r} maps back to {back!r}")
        arr = value.detach().float().cpu().numpy()
        out[path] = np.ascontiguousarray(_inverse(kind, arr))
    return out


def save_npz(path: str, state_dict, meta: Optional[dict] = None) -> None:
    """Write the JAX package's params-only .npz, as its trainer and
    converter call `save_params_npz` on {'params': ...}: keys
    'params/<flax path>', `__meta__` as JSON bytes."""
    arrays = {f"params/{k}": v for k, v in params_to_jax(state_dict).items()}
    if meta is not None:
        arrays[_NPZ_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                              dtype=np.uint8)
    np.savez(path, **arrays)


def save_checkpoint(path: str, state_dict, meta: Optional[dict] = None
                    ) -> None:
    """Write the reference's wrapped .pt (as the JAX package's
    `save_torch_checkpoint` does): f32 CPU tensors under the port's (the
    reference model's) names, cached buffers dropped."""
    sd = {k: v.detach().float().cpu().clone() for k, v in state_dict.items()
          if not k.endswith(STRIP_BUFFER_SUFFIXES)}
    torch.save({"model_state_dict": sd, "optimizer_state_dict": None,
                "meta_data": meta or {}, "train_metric": {},
                "val_metric": {}}, path)
