"""Backbone factory (port of esvit_tpu/models/registry.py).

The port has the Swin family only; the others are later slices.
"""

from __future__ import annotations

import torch

_NOT_PORTED = {
    "vil": "ROADMAP queue 1 item 9",
    "cvt": "ROADMAP queue 1 item 11",
    "vit": "ROADMAP queue 1 item 11",
    "resnet": "ROADMAP queue 1 item 11",
}


def build_backbone(cfg, dtype=torch.float32, generator=None):
    """Build a backbone module from its config dataclass."""
    name = getattr(cfg, "name", None)
    if name == "swin":
        from esvit_tpu_torch.models.swin import build_swin

        return build_swin(cfg, dtype=dtype, generator=generator)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet ({_NOT_PORTED[name]})")
    raise ValueError(f"no backbone for {name!r}; have ['swin']")
