"""Dotted-path config instantiation: `build_from_cfg({'type':
'pkg.mod.Class', **kwargs})` imports pkg.mod and calls Class(**kwargs).

The port's own copy of `atmvfi_tpu/utils/registry.py`.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict


def build_from_cfg(config: Dict[str, Any]):
    cfg = dict(config)
    target = cfg.pop("type")
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"'type' must be a dotted path, got {target!r}")
    obj = getattr(importlib.import_module(module_name), attr)
    return obj(**cfg)
