"""Load reference torch checkpoints into the port's backbones (port of the
loading half of esvit_tpu/io/torch_import.py).

The released EsViT checkpoints (ref: main_esvit.py:476-488 save layout)
store ``{'student': sd, 'teacher': sd, 'optimizer', 'epoch', 'args',
'dino_loss'}``, each state_dict with the backbone keys at the root plus
``head.*`` / ``head_dense.*``, and an optional ``module.`` DDP prefix. The
port's parameter and buffer names are the reference's (Swin, ViL, CvT
with its BatchNorm running statistics, ViT), so loading is a key filter:
the heads, the ``relative_position_index`` / ``attn_mask`` / CvT
``rel_pos_idx`` buffers (static tables here), BatchNorm's
``num_batches_tracked`` (unused: flax's BatchNorm has a fixed momentum)
and the Performer's ``calls_since_last_redraw`` are dropped, as
esvit_tpu/io/torch_import.py:176-180, 239 drops them. :func:`adapt_swin_tables` resizes the
relative-position tables and the absolute position embedding when the
checkpoint's window size or resolution differs from the model's
(ref: swin_transformer.py:852-917 init_weights).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from esvit_tpu_torch.ops.resample import bicubic_resize

_DROPPED = ("relative_position_index", "attn_mask", "rel_pos_idx",
            "num_batches_tracked", "calls_since_last_redraw")


def load_torch_checkpoint(path: str, key: str = "teacher"
                          ) -> dict[str, torch.Tensor]:
    """A reference .pth as a flat ``{name: tensor}`` for the model ``key``
    ('teacher' for the evals, like utils.py:78-103), ``module.`` stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt[key] if key in ckpt else ckpt
    return {k.removeprefix("module."): torch.as_tensor(v)
            for k, v in sd.items()}


def backbone_state(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The backbone's entries of a reference state_dict: no heads, no
    static index or mask buffers, no BatchNorm step counts."""
    return {k: v for k, v in sd.items()
            if not k.startswith(("head.", "head_dense."))
            and not any(d in k for d in _DROPPED)}


def adapt_swin_tables(state: Mapping[str, torch.Tensor],
                      target: Mapping[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """Bicubic-resize each ``relative_position_bias_table`` ((2w-1)^2, nH)
    and the ``absolute_pos_embed`` (1, L, C) whose shape differs from the
    target model's, with torch-interpolate semantics
    (esvit_tpu/io/torch_import.py:306-345). Other entries pass as they
    are."""
    out = dict(state)
    for name, v in state.items():
        want = target.get(name)
        if want is None or tuple(v.shape) == tuple(want.shape):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "relative_position_bias_table":
            (L1, nH), L2 = v.shape, want.shape[0]
            s1, s2 = math.isqrt(L1), math.isqrt(L2)
            out[name] = bicubic_resize(v.reshape(1, s1, s1, nH), s2,
                                       s2).reshape(L2, nH)
        elif leaf == "absolute_pos_embed":
            (_, L1, C), L2 = v.shape, want.shape[1]
            s1, s2 = math.isqrt(L1), math.isqrt(L2)
            out[name] = bicubic_resize(v.reshape(1, s1, s1, C), s2,
                                       s2).reshape(1, L2, C)
    return out


def load_backbone_checkpoint(backbone, path: str, key: str = "teacher"):
    """Load the ``key`` model of a reference .pth into ``backbone`` in
    place (Swin tables adapted to its window size and resolution); every
    backbone parameter must come from the file."""
    state = backbone_state(load_torch_checkpoint(path, key))
    if getattr(backbone.cfg, "name", None) == "swin":
        state = adapt_swin_tables(state, backbone.state_dict())
    backbone.load_state_dict(state, strict=True)
    return backbone
