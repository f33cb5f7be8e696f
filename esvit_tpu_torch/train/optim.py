"""Clip + AdamW + last-layer freeze + teacher EMA
(port of esvit_tpu/train/optim.py, the ``fused_update`` path).

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
"""

from __future__ import annotations

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


def per_param_clip_(grads: list[torch.Tensor], clip: float) -> None:
    """In place: g *= min(clip / (||g|| + 1e-6), 1) for each g."""
    norms = torch._foreach_norm(grads)
    coefs = [torch.clamp(clip / (n + 1e-6), max=1.0) for n in norms]
    torch._foreach_mul_(grads, coefs)


def fused_adamw_ema_apply(grads: list[torch.Tensor], params: list[torch.Tensor],
                          mu: list[torch.Tensor], nu: list[torch.Tensor],
                          teacher: list[torch.Tensor], *, count: int,
                          lr: float, wd: float, ema_m: float,
                          clip: float | None, decay_mask: list[bool],
                          ll_mask: list[bool], frozen: bool,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8) -> None:
    """One clip + AdamW + freeze + apply + teacher-EMA step, in place.

    ``count`` is the Adam step count before this update (bias correction
    uses count + 1). ``grads`` are consumed (overwritten)."""
    if frozen:
        for g, llm in zip(grads, ll_mask):
            if llm:
                g.zero_()
    if clip is not None and clip > 0:
        per_param_clip_(grads, clip)
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
    if frozen:
        for x, llm in zip(u, ll_mask):
            if llm:
                x.zero_()
    torch._foreach_add_(params, u)
    torch._foreach_mul_(teacher, ema_m)
    torch._foreach_add_(teacher, torch._foreach_mul(params, 1.0 - ema_m))
