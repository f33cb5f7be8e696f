"""Clip + AdamW / SGD / LARS + last-layer freeze + frozen layers +
teacher EMA (port of esvit_tpu/train/optim.py).

- AdamW (betas 0.9/0.999, eps 1e-8); no weight decay on biases and 1-D
  params (ref: utils.py:672-683 get_params_groups).
- Each parameter's gradient is clipped to norm ``clip`` on its own
  (ref: utils.py:106-115), not by a global norm.
- The DINO-head last layer is frozen for the first epochs
  (ref: utils.py:118-123): its gradient and its update are zeroed.

The JAX package left this to XLA, so here it is plain torch: a few
``torch._foreach_*`` passes over all parameters, in the op order of
``esvit_tpu/train/optim.py:128-130``, so the fp32 step matches:
    mu' = (1-b1)*g + b1*mu;  nu' = (1-b2)*g^2 + b2*nu;
    u = (mu'/bc1) / (sqrt(nu'/bc2) + eps);  u += wd*p (masked);
    p' = p + (-u)*lr;  t' = t*m + p'*(1-m).
Parameters, moments and the teacher are updated in place.

SGD and LARS (ref utils.py:519-557, the ResNet recipes) are
``sgd_lars_ema_apply``, in the update order of the optax chains that
``esvit_tpu.train.optim.make_optimizer`` builds (:74-108), which is not
``torch.optim``'s:
    sgd:  t' = g + 0.9*t;  u = t' + wd*p (masked);  u = (u * -1) * lr
    lars: u = g + wd*p (masked);  u *= 0.001*||p|| / ||u|| (1 where
          either norm is 0, every leaf);  u *= -lr;  t' = u + 0.9*t;  u = t'
so the LARS trace holds lr-scaled updates. ``frozen_layers``
(``freeze_mask_by_prefix``) zero a subtree's gradient and update for the
whole run, as torch's ``requires_grad=False`` leaves it out of the
optimizer.

Under the head's tensor parallelism (parallel/mesh.py) the leaves marked
``sharded`` hold this rank's rows of a whole tensor. The clip's and
LARS's norms are the whole tensor's, as esvit_tpu takes them on the
global array (esvit_tpu/train/optim.py:57-71): the shards' sums of
squares are all-reduced over the model group (``global_norms``).
Everything else here is element-wise and stays local.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def wd_mask(named_params: Mapping[str, torch.Tensor],
            decay_scale_g: bool = False) -> dict[str, bool]:
    """True for weight-decayed params: ndim > 1 and not a bias. The
    weight-norm gain ``weight_g`` is decayed only when it is trainable
    (``decay_scale_g``, i.e. norm_last_layer=False)."""
    def f(name, p):
        if name.endswith("weight_g"):
            return decay_scale_g
        return p.ndim > 1 and not name.endswith("bias")
    return {n: f(n, p) for n, p in named_params.items()}


def last_layer_mask(named_params: Mapping[str, torch.Tensor]) -> dict[str, bool]:
    """True for DINO-head last-layer params."""
    return {n: "last_layer" in n.split(".") for n in named_params}


def global_norms(tensors: list[torch.Tensor],
                 sharded: list[bool] | None = None, mesh=None
                 ) -> list[torch.Tensor]:
    """Each tensor's L2 norm; those marked ``sharded`` over ``mesh``'s
    model group the whole tensor's, from the shards' sums of squares in
    one collective."""
    norms = list(torch._foreach_norm(tensors))
    idx = [i for i, s in enumerate(sharded or ()) if s]
    if mesh is None or not idx:
        return norms
    (sq,) = mesh.all_reduce_sum([torch.stack([norms[i] for i in idx]) ** 2],
                                over="model")
    for j, i in enumerate(idx):
        norms[i] = sq[j].sqrt()
    return norms


def per_param_clip_(grads: list[torch.Tensor], clip: float,
                    sharded: list[bool] | None = None, mesh=None) -> None:
    """In place: g *= min(clip / (||g|| + 1e-6), 1) for each g, ||g|| the
    whole tensor's (``global_norms``)."""
    norms = global_norms(grads, sharded, mesh)
    coefs = [torch.clamp(clip / (n + 1e-6), max=1.0) for n in norms]
    torch._foreach_mul_(grads, coefs)


def held_mask(ll_mask, frozen, f_mask):
    """Per leaf: whether the last-layer freeze or frozen_layers hold it."""
    f_mask = f_mask or [False] * len(ll_mask)
    return [fm or (frozen and llm) for llm, fm in zip(ll_mask, f_mask)]


def _zero_(tensors, held):
    for x, h in zip(tensors, held):
        if h:
            x.zero_()


def fused_adamw_ema_apply(grads: list[torch.Tensor], params: list[torch.Tensor],
                          mu: list[torch.Tensor], nu: list[torch.Tensor],
                          teacher: list[torch.Tensor], *, count: int,
                          lr: float, wd: float, ema_m: float,
                          clip: float | None, decay_mask: list[bool],
                          ll_mask: list[bool], frozen: bool,
                          f_mask: list[bool] | None = None,
                          sharded: list[bool] | None = None, mesh=None,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8) -> None:
    """One clip + AdamW + freeze + apply + teacher-EMA step, in place.

    ``count`` is the Adam step count before this update (bias correction
    uses count + 1). ``grads`` are consumed (overwritten). ``f_mask``
    marks the frozen_layers leaves: their gradient and update are zero,
    as the last layer's are while ``frozen``. ``sharded`` / ``mesh``:
    the leaves split over the model axis (module docstring)."""
    held = held_mask(ll_mask, frozen, f_mask)
    _zero_(grads, held)
    if clip is not None and clip > 0:
        per_param_clip_(grads, clip, sharded, mesh)
    n = np.float32(count + 1)
    bc1 = float(np.float32(1.0) - np.power(np.float32(b1), n, dtype=np.float32))
    bc2 = float(np.float32(1.0) - np.power(np.float32(b2), n, dtype=np.float32))

    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                               1 - b2))
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    decayed = [i for i, d in enumerate(decay_mask) if d]
    if decayed:
        torch._foreach_add_([u[i] for i in decayed],
                            torch._foreach_mul([params[i] for i in decayed], wd))
    torch._foreach_mul_(u, -1.0)
    torch._foreach_mul_(u, lr)
    _zero_(u, held)
    _apply_and_ema(params, u, teacher, ema_m)


def _apply_and_ema(params, u, teacher, ema_m):
    """p' = p + u; the teacher's EMA toward p' (main_esvit.py:586-590)."""
    torch._foreach_add_(params, u)
    torch._foreach_mul_(teacher, ema_m)
    torch._foreach_add_(teacher, torch._foreach_mul(params, 1.0 - ema_m))


def sgd_lars_ema_apply(optimizer: str, grads: list[torch.Tensor],
                       params: list[torch.Tensor], trace: list[torch.Tensor],
                       teacher: list[torch.Tensor], *, lr: float, wd: float,
                       ema_m: float, clip: float | None,
                       decay_mask: list[bool], ll_mask: list[bool],
                       frozen: bool, f_mask: list[bool] | None = None,
                       sharded: list[bool] | None = None, mesh=None,
                       momentum: float = 0.9,
                       trust_coefficient: float = 0.001) -> None:
    """One SGD or LARS step with esvit_tpu's unfused chain
    (train/step.py:242-257): the freezes zero the gradients, the
    per-parameter clip, the optimizer (module docstring; its trace
    updated in place), the freezes zero the updates, apply, teacher EMA.
    ``grads`` are consumed. The clip's and the trust ratio's norms are
    the whole tensors' (``sharded`` / ``mesh``)."""
    if optimizer not in ("sgd", "lars"):
        raise ValueError(f"sgd_lars_ema_apply takes sgd or lars, not "
                         f"{optimizer!r}")
    held = held_mask(ll_mask, frozen, f_mask)
    _zero_(grads, held)
    if clip is not None and clip > 0:
        per_param_clip_(grads, clip, sharded, mesh)
    decayed = [i for i, d in enumerate(decay_mask) if d]

    def add_decay(u):
        if decayed:
            torch._foreach_add_([u[i] for i in decayed],
                                torch._foreach_mul([params[i] for i in decayed],
                                                   wd))

    if optimizer == "sgd":
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, grads)
        u = [t.clone() for t in trace]
        add_decay(u)
        torch._foreach_mul_(u, -1.0)
        torch._foreach_mul_(u, lr)
    else:
        u = grads
        add_decay(u)
        pn = global_norms(params, sharded, mesh)
        un = global_norms(u, sharded, mesh)
        ratios = [torch.where((p == 0) | (n == 0), torch.ones_like(p),
                              trust_coefficient * p / n)
                  for p, n in zip(pn, un)]
        torch._foreach_mul_(u, ratios)
        torch._foreach_mul_(u, -lr)
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, u)
        u = [t.clone() for t in trace]
    _zero_(u, held)
    _apply_and_ema(params, u, teacher, ema_m)


def flax_keys(name: str, family: str, head_layers: Mapping[str, str]
              ) -> tuple[str, ...]:
    """The first two keys of esvit_tpu's flax path of the port's
    parameter ``name`` (backbone-relative, as esvit_tpu's
    freeze_mask_by_prefix reads them), for a backbone of ``family``.
    ``head_layers`` maps a head's ``mlp`` index ('head.mlp.3') to its
    flax scope ('mlp_1' or 'bn_0'); see ``head_layer_keys``."""
    parts = name.split(".")
    if parts[0] in ("head", "head_dense"):
        if parts[1] == "mlp":
            key = (".".join(parts[:3]) if len(parts) > 3
                   else ".".join(parts[:2]))
            return parts[0], head_layers[key]
        return parts[0], parts[1]
    if parts[0] == "norm":
        return "norm_final", "ln"
    if family == "swin":
        if parts[0] == "layers":
            return f"layers_{parts[1]}", (f"blocks_{parts[3]}"
                                          if parts[2] == "blocks"
                                          else parts[2])
        return tuple(parts[:2])
    if family == "vit":
        if parts[0] == "blocks":
            return f"blocks_{parts[1]}", parts[2]
        if parts[0] == "patch_embed":
            return "patch_embed", {"weight": "kernel"}.get(parts[2], parts[2])
        return tuple(parts[:1])
    if family == "cvt":
        i = re.fullmatch(r"stage(\d+)", parts[0]).group(1)
        if parts[1] == "0":
            return f"embed_{i}", parts[2]
        block = f"stage{i}_block{parts[3]}"
        sub = ({"norm": "norm_attn", "fn": "attn"} if parts[4] == "0"
               else {"norm": "norm_ff"})
        if parts[5] in sub:
            return block, sub[parts[5]]
        return block, f"ff_{int(parts[7]) // 2 + 1}"
    if family == "vil":
        i = int(re.fullmatch(r"layer(\d+)", parts[0]).group(1)) - 1
        j = int(parts[1])
        if j == 0:
            return f"embed_{i}", parts[2]
        kind = "attn" if j % 2 else "mlp"
        return f"stage{i}_{kind}{(j - 1) // 2}", parts[2]
    if family == "resnet":
        if parts[0] in ("conv1", "bn1"):
            return "stem", parts[0][:-1]
        block = f"{parts[0]}_block{parts[1]}"
        if parts[2] == "downsample":
            return block, "down"
        return block, f"cb{parts[2][-1]}"
    raise ValueError(f"no flax keys for family {family!r}")


def head_layer_keys(named_params: Mapping[str, torch.Tensor]
                    ) -> dict[str, str]:
    """'head.mlp.{i}' -> its flax scope: the Linears in order are
    'mlp_0', 'mlp_1', ... and the BatchNorms (1-D weights) 'bn_0', ...;
    a one-layer head's 'head.mlp' is 'mlp_0'."""
    out = {}
    for head in ("head", "head_dense"):
        if f"{head}.mlp.weight" in named_params:
            out[f"{head}.mlp"] = "mlp_0"
            continue
        idx = sorted({int(n.split(".")[2]) for n in named_params
                      if n.startswith(f"{head}.mlp.")})
        dense = [i for i in idx
                 if named_params[f"{head}.mlp.{i}.weight"].ndim == 2]
        bns = [i for i in idx if i not in dense]
        for kind, ids in (("mlp", dense), ("bn", bns)):
            for k, i in enumerate(ids):
                out[f"{head}.mlp.{i}"] = f"{kind}_{k}"
    return out


def freeze_mask_by_prefix(named_params: Mapping[str, torch.Tensor],
                          frozen_layers, family: str) -> dict[str, bool]:
    """True for the parameters under any of ``frozen_layers``: the
    parameters that esvit_tpu's freeze_mask_by_prefix (train/optim.py:
    215-247, the reference's freeze_pretrained_layers) freezes on the
    bridged tree. Entries are esvit_tpu's keys ('patch_embed',
    'layers_0', 'layers_0/blocks_1', dotted 'layers.0'), 'head' or '*';
    an entry matches a parameter whose first flax key, or first two, it
    names."""
    wanted = {n.replace(".", "_").replace("/", " ").strip()
              for n in frozen_layers}
    star = "*" in wanted
    heads = head_layer_keys(named_params)

    def f(name):
        if star:
            return True
        keys = flax_keys(name, family, heads)
        return keys[0] in wanted or (len(keys) > 1
                                     and " ".join(keys[:2]) in wanted)
    return {n: f(n) for n in named_params}
