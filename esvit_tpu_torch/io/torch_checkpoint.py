"""Load reference torch checkpoints into the port's backbones and whole
EsViT models (port of the loading half of esvit_tpu/io/torch_import.py).

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
:func:`load_esvit_checkpoint` loads the whole model (backbone, ``head``
and, with the dense head, ``head_dense``; esvit_tpu
``import_esvit_model``), and :func:`verify_state_matches` lists what a
state dict lacks, has over, or holds in another shape than a reference
one (esvit_tpu ``verify_tree_matches``).
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
    return {k: v for k, v in sd.items() if _backbone_key(k) and _kept(k)}


def _backbone_key(name: str) -> bool:
    return not name.startswith(("head.", "head_dense."))


def _kept(name: str) -> bool:
    """Not one of the static buffers the port builds itself."""
    return not any(d in name for d in _DROPPED)


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


def _load_reference(module, cfg, path: str, key: str, keep):
    """Load the entries of the ``key`` model of a reference .pth whose
    names ``keep`` accepts into ``module`` in place: the static buffers
    dropped, Swin's tables adapted to the module; every entry of the
    module must come from the file (strict)."""
    state = {k: v for k, v in load_torch_checkpoint(path, key).items()
             if keep(k) and _kept(k)}
    if getattr(cfg, "name", None) == "swin":
        state = adapt_swin_tables(state, module.state_dict())
    module.load_state_dict(state, strict=True)
    return module


def load_backbone_checkpoint(backbone, path: str, key: str = "teacher"):
    """Load the ``key`` model of a reference .pth into ``backbone`` in
    place (Swin tables adapted to its window size and resolution); every
    backbone parameter must come from the file."""
    return _load_reference(backbone, backbone.cfg, path, key, _backbone_key)


def load_esvit_checkpoint(model, path: str, key: str = "teacher",
                          use_dense_prediction: bool = True):
    """Load the ``key`` model of a released EsViT .pth into a whole
    ``EsViTModel`` in place: ``module.`` stripped, the static buffers
    dropped, Swin's tables adapted to the model, ``head_dense`` taken only
    with ``use_dense_prediction``; every entry of the model must come from
    the file (strict)."""
    return _load_reference(
        model, model.backbone.cfg, path, key,
        lambda k: use_dense_prediction or not k.startswith("head_dense."))


def verify_state_matches(imported: Mapping[str, torch.Tensor],
                         reference: Mapping[str, torch.Tensor]) -> list[str]:
    """Missing, unexpected and shape-mismatched entries of ``imported``
    against ``reference``, as human-readable lines (none: a match)."""
    problems = [f"{k}: missing from import"
                for k in sorted(set(reference) - set(imported))]
    problems += [f"{k}: unexpected in import"
                 for k in sorted(set(imported) - set(reference))]
    for k in sorted(set(imported) & set(reference)):
        have, want = tuple(imported[k].shape), tuple(reference[k].shape)
        if have != want:
            problems.append(f"{k}: shape {have} != expected {want}")
    return problems
