"""Backbone factory (port of esvit_tpu/models/registry.py): the Swin,
ViL, CvT, ViT and ResNet families, keyed by the config's ``name``."""

from __future__ import annotations

import importlib

import torch

_FAMILIES = {
    "swin": ("swin", "build_swin"),
    "vil": ("vil", "build_vil"),
    "cvt": ("cvt", "build_cvt"),
    "vit": ("vit", "build_vit"),
    "resnet": ("resnet", "build_resnet"),
}


def build_backbone(cfg, dtype=torch.float32, generator=None):
    """Build a backbone module from its config dataclass."""
    name = getattr(cfg, "name", None)
    if name not in _FAMILIES:
        raise ValueError(f"no backbone for {name!r}; have {list(_FAMILIES)}")
    module, fn = _FAMILIES[name]
    build = getattr(importlib.import_module(f"esvit_tpu_torch.models.{module}"),
                    fn)
    return build(cfg, dtype=dtype, generator=generator)
