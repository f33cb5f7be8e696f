"""The weight bridge from esvit_tpu's flax params to this package.

The port's parameter names are the reference torch checkpoint's, so this
is exactly the inverse of esvit_tpu/io/torch_import.py
(``import_swin_backbone``, ``_import_dino_head``):
- Linear ``kernel`` (in, out)         -> ``weight`` (out, in)
- Conv ``kernel`` (kh, kw, in, out)   -> ``weight`` (out, in, kh, kw)
- LayerNorm ``ln/scale``, ``ln/bias`` -> ``weight``, ``bias``
- ``kernel_v`` (in, out)              -> ``weight_v`` (out, in)
- ``scale_g`` (out,)                  -> ``weight_g`` (out, 1)
- ``layers_i/blocks_j`` -> ``layers.i.blocks.j``, ``norm_final`` -> ``norm``,
  head ``mlp_k`` -> ``mlp.{2k}`` (the GELUs sit between), or ``mlp``
  for a one-layer head; the ``backbone`` level is dropped.

Inputs are nested dicts of numpy arrays (``jax.device_get`` of the flax
tree); nothing here imports jax.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(path: tuple[str, ...], v: np.ndarray, n_head_mlps: int
             ) -> tuple[str, np.ndarray]:
    parts = list(path)
    if parts[0] == "backbone":
        parts = parts[1:]
    leaf = parts.pop()
    if parts and parts[-1] == "ln":                 # LayerNorm scope
        parts.pop()
        leaf = {"scale": "weight", "bias": "bias"}[leaf]
    elif leaf == "kernel":
        leaf = "weight"
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    elif leaf == "kernel_v":
        leaf, v = "weight_v", v.T
    elif leaf == "scale_g":
        leaf, v = "weight_g", v.reshape(-1, 1)
    names = []
    for p in parts:
        if m := re.fullmatch(r"(layers|blocks)_(\d+)", p):
            names += [m.group(1), m.group(2)]
        elif m := re.fullmatch(r"mlp_(\d+)", p):
            names += ["mlp"] if n_head_mlps == 1 else ["mlp", str(2 * int(m.group(1)))]
        elif p == "norm_final":
            names.append("norm")
        else:
            names.append(p)
    return ".".join(names + [leaf]), np.ascontiguousarray(v)


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """EsViTModel (or bare backbone) flax params -> the port's state_dict."""
    n_head_mlps = sum(1 for k in params.get("head", {}) if k.startswith("mlp_"))
    out = {}
    for path, v in _leaves(params):
        name, arr = _convert(path, v, n_head_mlps)
        out[name] = torch.from_numpy(np.array(arr, copy=True))
    return out


def _adam_state(opt_state):
    """The ScaleByAdamState inside the fused path's optax state:
    (EmptyState, inject) with clipping, inject alone without."""
    inject = opt_state if hasattr(opt_state, "inner_state") else opt_state[1]
    return inject.inner_state[0]


def train_state_from_jax(jax_state, trainer):
    """esvit_tpu TrainState (numpy leaves) -> the port's TrainState on
    ``trainer.device``: student, teacher, AdamW moments and count, step
    and centers."""
    from esvit_tpu_torch.losses import DinoCenters
    from esvit_tpu_torch.train.step import TrainState

    dev = trainer.device

    def model(params):
        m = trainer.build_model()
        m.load_state_dict(state_dict_from_flax(params))
        return m.to(dev)

    def by_name(tree):
        return {k: v.to(dev) for k, v in state_dict_from_flax(tree).items()}

    adam = _adam_state(jax_state.opt_state)
    teacher = model(jax_state.teacher).requires_grad_(False)
    c = jax_state.centers
    return TrainState(
        step=int(jax_state.step), student=model(jax_state.student),
        teacher=teacher, mu=by_name(adam.mu), nu=by_name(adam.nu),
        adam_count=int(adam.count),
        centers=DinoCenters(center=torch.tensor(np.asarray(c.center)).to(dev),
                            center_grid=torch.tensor(
                                np.asarray(c.center_grid)).to(dev)))
