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
- ViL (the inverse of ``import_vil_backbone``): ``embed_i`` ->
  ``layer{i+1}.0``, ``stage{i}_attn{j}`` -> ``layer{i+1}.{2j+1}``,
  ``stage{i}_mlp{j}`` -> ``layer{i+1}.{2j+2}``; the rpe tables, ``g2l`` /
  ``g2g``, Linformer's stored ``proj_k`` / ``proj_v``, the pooled keys'
  scales and cross-window table keep their names, ``pool_fc`` and
  SRFormer's ``proj_sr`` convert as every Dense / Conv kernel; the
  ``performer`` collection's ``projection`` -> each Performer's buffer
  ``fast_attention.projection_matrix``.
- CvT (the inverse of ``import_cvt_backbone``): ``embed_i`` ->
  ``stage{i}.0``; ``stage{i}_block{j}`` -> ``stage{i}.1.layers.{j}``, its
  ``norm_attn`` / ``attn`` under ``.0`` (``norm`` / ``fn``) and
  ``norm_ff`` / ``ff_1`` / ``ff_2`` under ``.1`` (``norm`` /
  ``fn.net.0`` / ``fn.net.2``); the depthwise kernel (k, k, 1, C) ->
  (C, 1, k, k) like every conv kernel; BatchNorm ``scale`` -> ``weight``
  and the ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``.
- ViT (the inverse of ``import_vit_backbone``): ``patch_embed`` ->
  ``patch_embed.proj``; ``cls_token``, ``pos_embed`` and ``blocks_i`` as
  they are.
- ResNet, to torchvision's names: ``stem/conv`` -> ``conv1``, ``stem/bn``
  -> ``bn1``, ``layer{i}_block{j}`` -> ``layer{i}.{j}``, its ``cb{k}/conv``
  / ``cb{k}/bn`` -> ``conv{k}`` / ``bn{k}`` and ``down/conv`` /
  ``down/bn`` -> ``downsample.0`` / ``downsample.1``; conv kernels HWIO ->
  OIHW, BatchNorm as CvT's.
- A BatchNorm head (``use_bn``): ``mlp_k`` -> ``mlp.{3k}`` and ``bn_k``
  -> ``mlp.{3k+1}`` (the reference's Linear, BatchNorm1d, GELU), its
  ``scale`` / ``bias`` and ``batch_stats`` ``mean`` / ``var`` as above.
- The standalone modules (T2T, the CNN extras, the auxiliary
  attentions) keep their flax names; their BatchNorms (``bn``, ``v_bn``,
  ``q_bn``, ``kv_bn``) convert as CvT's, depthwise kernels (k, k, 1, C)
  -> (C, 1, k, k), and ``FrozenBatchNorm``'s ``frozen_stats`` collection
  (``weight``, ``bias``, ``mean``, ``var``) -> its buffers ``weight``,
  ``bias``, ``running_mean``, ``running_var``.

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


_CVT_BLOCK = {"norm_attn": ["0", "norm"], "attn": ["0", "fn"],
              "norm_ff": ["1", "norm"], "ff_1": ["1", "fn", "net", "0"],
              "ff_2": ["1", "fn", "net", "2"]}


_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _resnet_names(parts: list[str]) -> list[str]:
    """ResNet's flax scopes (BatchNorm leaves already renamed) ->
    torchvision's module path."""
    if parts[0] == "stem":
        return [{"conv": "conv1", "bn": "bn1"}[parts[1]]]
    m = re.fullmatch(r"layer(\d+)_block(\d+)", parts[0])
    names = [f"layer{m.group(1)}", m.group(2)]
    if parts[1] == "down":
        return names + ["downsample", {"conv": "0", "bn": "1"}[parts[2]]]
    k = re.fullmatch(r"cb(\d)", parts[1]).group(1)
    return names + [f"{parts[2]}{k}"]


def _convert(path: tuple[str, ...], v: np.ndarray, n_head_mlps: int,
             cvt: bool, head_bn: bool = False, resnet: bool = False
             ) -> tuple[str, np.ndarray]:
    parts = list(path)
    backbone = parts[0] not in ("head", "head_dense")
    if parts[0] == "backbone":
        parts = parts[1:]
    leaf = parts.pop()
    if parts and parts[-1] == "ln":                 # LayerNorm scope
        parts.pop()
        leaf = {"scale": "weight", "bias": "bias"}[leaf]
    elif parts and re.fullmatch(r"(?:\w+_)?bn|bn_\d+", parts[-1]):
        leaf = _BN_LEAVES[leaf]                     # BatchNorm scope
    elif parts == ["patch_embed"]:                  # ViT's patch conv
        parts.append("proj")
    elif leaf == "projection":                      # the performer collection
        parts.append("fast_attention")
        leaf = "projection_matrix"
    if leaf == "kernel":
        leaf = "weight"
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    elif leaf == "kernel_v":
        leaf, v = "weight_v", v.T
    elif leaf == "scale_g":
        leaf, v = "weight_g", v.reshape(-1, 1)
    if resnet and backbone:
        return ".".join(_resnet_names(parts) + [leaf]), np.ascontiguousarray(v)
    names = []
    for i, p in enumerate(parts):
        if m := re.fullmatch(r"bn_(\d+)", p):
            names += ["mlp", str(3 * int(m.group(1)) + 1)]
        elif m := re.fullmatch(r"(layers|blocks)_(\d+)", p):
            names += [m.group(1), m.group(2)]
        elif cvt and (m := re.fullmatch(r"embed_(\d+)", p)):
            names += [f"stage{m.group(1)}", "0"]
        elif m := re.fullmatch(r"embed_(\d+)", p):
            names += [f"layer{int(m.group(1)) + 1}", "0"]
        elif m := re.fullmatch(r"stage(\d+)_block(\d+)", p):
            names += [f"stage{m.group(1)}", "1", "layers", m.group(2)]
        elif i > 0 and p in _CVT_BLOCK and re.fullmatch(
                r"stage\d+_block\d+", parts[i - 1]):
            names += _CVT_BLOCK[p]
        elif m := re.fullmatch(r"stage(\d+)_(attn|mlp)(\d+)", p):
            j = 2 * int(m.group(3)) + (1 if m.group(2) == "attn" else 2)
            names += [f"layer{int(m.group(1)) + 1}", str(j)]
        elif m := re.fullmatch(r"mlp_(\d+)", p):
            step = 3 if head_bn else 2
            names += (["mlp"] if n_head_mlps == 1
                      else ["mlp", str(step * int(m.group(1)))])
        elif p == "norm_final":
            names.append("norm")
        else:
            names.append(p)
    return ".".join(names + [leaf]), np.ascontiguousarray(v)


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] | None = None,
                         performer: Mapping[str, Any] | None = None,
                         frozen_stats: Mapping[str, Any] | None = None
                         ) -> dict[str, torch.Tensor]:
    """EsViTModel (or bare backbone, or standalone module) flax params, and
    its ``batch_stats``, ``performer`` and ``frozen_stats`` collections
    where it has them -> the port's state_dict."""
    n_head_mlps = sum(1 for k in params.get("head", {}) if k.startswith("mlp_"))
    head_bn = any(k.startswith("bn_") for k in params.get("head", {}))
    trees = [params] + [t for t in (batch_stats, performer) if t]
    keys = {p for tree in trees for path, _ in _leaves(tree) for p in path}
    cvt = any(re.fullmatch(r"stage\d+_block\d+", p) for p in keys)
    resnet = any(re.fullmatch(r"layer\d+_block\d+", p) for p in keys)
    out = {}
    for tree in trees:
        for path, v in _leaves(tree):
            name, arr = _convert(path, v, n_head_mlps, cvt, head_bn, resnet)
            out[name] = torch.from_numpy(np.array(arr, copy=True))
    for path, v in _leaves(frozen_stats or {}):
        leaf = {"mean": "running_mean", "var": "running_var"}.get(
            path[-1], path[-1])
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
            np.array(v, copy=True))
    return out


def _adam_state(opt_state):
    """The ScaleByAdamState inside the fused path's optax state:
    (EmptyState, inject) with clipping, inject alone without."""
    inject = opt_state if hasattr(opt_state, "inner_state") else opt_state[1]
    return inject.inner_state[0]


def _trace_state(opt_state):
    """The TraceState (SGD's or LARS's momentum) inside an optax state."""
    if hasattr(opt_state, "trace") and not hasattr(opt_state, "inner_state"):
        return opt_state
    children = (opt_state.inner_state if hasattr(opt_state, "inner_state")
                else opt_state)
    if isinstance(children, tuple):
        for child in children:
            if isinstance(child, tuple) or hasattr(child, "inner_state"):
                found = _trace_state(child)
                if found is not None:
                    return found
    return None


def train_state_from_jax(jax_state, trainer):
    """esvit_tpu TrainState (numpy leaves, whole arrays) -> the port's
    TrainState on ``trainer.device``: student and teacher with their
    BatchNorm state (``student_state`` / ``teacher_state``) and their
    Performer projections (the ``performer`` collection there), the
    optimizer's state (AdamW moments and count, or the SGD / LARS trace),
    step and centers. Under ``trainer.mesh``'s model axis the heads'
    ``kernel_v`` / ``scale_g``, their optimizer state and the centers are
    this rank's rows (parallel/mesh.py ``Mesh.shard_state``)."""
    from esvit_tpu_torch.losses import DinoCenters
    from esvit_tpu_torch.train.step import TrainState

    dev = trainer.device
    mesh = trainer.mesh

    def model(params, extra):
        m = trainer.build_model()
        extra = extra or {}
        m.load_state_dict(mesh.shard_state(state_dict_from_flax(
            params, extra.get("batch_stats"), extra.get("performer"))))
        return m.to(dev)

    def by_name(tree):
        return {k: v.to(dev) for k, v in
                mesh.shard_state(state_dict_from_flax(tree)).items()}

    def rows(x):
        return mesh.rows(torch.tensor(np.asarray(x))).to(dev)

    opt = trainer.cfg.optim.optimizer
    if opt == "adamw":
        adam = _adam_state(jax_state.opt_state)
        moments = dict(mu=by_name(adam.mu), nu=by_name(adam.nu),
                       adam_count=int(adam.count), trace={})
    else:
        moments = dict(mu={}, nu={}, adam_count=0, trace=by_name(
            _trace_state(jax_state.opt_state).trace))
    teacher = model(jax_state.teacher,
                    jax_state.teacher_state).requires_grad_(False)
    c = jax_state.centers
    return TrainState(
        step=int(jax_state.step),
        student=model(jax_state.student, jax_state.student_state),
        teacher=teacher, optimizer=opt, **moments,
        centers=DinoCenters(center=rows(c.center),
                            center_grid=rows(c.center_grid)))
