"""Backbone factory (port of esvit_tpu/models/registry.py).

The port has the Swin, ViL, CvT and ViT families; ResNet is a later
slice.
"""

from __future__ import annotations

import torch

_NOT_PORTED = {
    "resnet": "ROADMAP queue 1 item 11",
}


def build_backbone(cfg, dtype=torch.float32, generator=None):
    """Build a backbone module from its config dataclass."""
    name = getattr(cfg, "name", None)
    if name == "swin":
        from esvit_tpu_torch.models.swin import build_swin

        return build_swin(cfg, dtype=dtype, generator=generator)
    if name == "vil":
        from esvit_tpu_torch.models.vil import build_vil

        return build_vil(cfg, dtype=dtype, generator=generator)
    if name == "cvt":
        from esvit_tpu_torch.models.cvt import build_cvt

        return build_cvt(cfg, dtype=dtype, generator=generator)
    if name == "vit":
        from esvit_tpu_torch.models.vit import build_vit

        return build_vit(cfg, dtype=dtype, generator=generator)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet ({_NOT_PORTED[name]})")
    raise ValueError(f"no backbone for {name!r}; have ['swin', 'vil', 'cvt', 'vit']")
