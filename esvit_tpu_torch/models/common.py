"""Shared building blocks, with the reference's numerics.

Port of esvit_tpu/models/common.py:
- ``Dense`` is flax ``nn.Dense`` as the JAX modules use it: fp32 master
  weight, input and kernel cast to the compute dtype, the product rounded
  to it, the bias added in it. The weight is stored (out, in) like
  ``torch.nn.Linear``, so names and layouts are the reference checkpoint's.
- ``LayerNorm`` runs in fp32 (eps 1e-6) and casts its result to the
  compute dtype.
- ``DropPath`` is per-sample stochastic depth (timm semantics) drawn from
  an explicit ``torch.Generator``; ``Dropout`` is flax's ``nn.Dropout``
  (keep with probability 1 - rate, scale by 1 / (1 - rate)) drawn the
  same way.
- GELU is the exact erf form.
- ``remat`` runs a block under ``torch.utils.checkpoint`` with the step's
  explicit generator rewound for the recompute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """The unit normal truncated to [-2, 2], times ``std``, with no
    rescale: what flax's ``truncated_normal(stddev=std)`` (esvit_tpu's
    ``trunc_normal_init``) draws. Its std is 0.8796 ``std`` (the original
    EsViT's timm init rescales to ``std``; esvit_tpu does not)."""
    with torch.no_grad():
        t.normal_(generator=generator)
        while True:
            bad = t.abs() > 2.0
            if not bad.any():
                break
            t[bad] = torch.randn(int(bad.sum()), generator=generator,
                                 dtype=t.dtype, device=t.device)
        t.mul_(std)
    return t


class Dense(nn.Module):
    """flax-numerics linear layer: y = cast(x) @ cast(W)^T + cast(b)."""

    def __init__(self, din: int, dout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(trunc_normal_(torch.empty(dout, din),
                                                 generator=generator))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class PatchConv(nn.Module):
    """Non-overlapping conv patch projection on NHWC input: flax
    ``nn.Conv`` with stride == kernel, as one product of each flattened
    patch with the flattened kernel in the compute dtype. The weight is
    stored OIHW like ``torch.nn.Conv2d``. Returns (B, H/p, W/p, dout)."""

    def __init__(self, din: int, dout: int, patch_size: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(trunc_normal_(
            torch.empty(dout, din, patch_size, patch_size), generator=generator))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, Cin = x.shape
        ps = self.patch_size
        Hp, Wp = H // ps, W // ps
        x = x[:, :Hp * ps, :Wp * ps, :].reshape(B, Hp, ps, Wp, ps, Cin)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(B, Hp, Wp, Cin * ps * ps)
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(x.to(self.dtype), w.to(self.dtype)) + self.bias.to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` on channels-last input: (B, H, W, din) ->
    (B, H', W', dout), input and weight cast to ``dtype``, the bias added
    in it. ``groups=din`` is a depthwise conv. The weight is OIHW, as
    ``torch.nn.Conv2d`` stores it, drawn by ``trunc_normal_`` with
    ``std``."""

    def __init__(self, din: int, dout: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype=torch.float32, generator=None, std: float = 0.02):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.weight = nn.Parameter(trunc_normal_(
            torch.empty(dout, din // groups, kernel, kernel), std=std,
            generator=generator))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = self.bias.to(self.dtype) if self.bias is not None else None
        x = x.to(self.dtype)
        if w.shape[-1] == 1 and self.stride == 1 and self.groups == 1:
            return F.linear(x, w.reshape(w.shape[0], -1), b)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """fp32 LayerNorm that casts its result to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(self.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth: keep each sample with probability
    1 - rate and scale it by 1/keep (timm DropPath semantics)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def keep_mask(self, batch: int, generator: torch.Generator | None,
                  device) -> torch.Tensor:
        """(batch,) bool: which samples keep their branch."""
        u = torch.rand(batch, generator=generator, device=device)
        return u < 1.0 - self.rate

    def apply_mask(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        scaled = x / torch.tensor(1.0 - self.rate, dtype=x.dtype)
        return torch.where(keep.reshape(shape), scaled, torch.zeros_like(x))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        return self.apply_mask(x, self.keep_mask(x.shape[0], generator,
                                                 x.device))


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``): each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the mask drawn
    from ``generator``; the identity when deterministic or rate is 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def remat(fn, x: torch.Tensor, generator: torch.Generator | None):
    """``fn(x)`` under ``torch.utils.checkpoint`` (non-reentrant): backward
    recomputes fn's activations from x instead of keeping them. The
    checkpoint restores only the global RNGs, and fn draws its drop-path
    and dropout masks from ``generator``; so the recompute runs from the
    generator state the forward started from, and leaves the generator
    where it found it, giving the forward's masks again."""
    if not torch.is_grad_enabled():
        return fn(x)
    if generator is None:
        return checkpoint(fn, x, use_reentrant=False)
    start = generator.get_state()
    calls = []

    def run(x):
        if not calls:
            calls.append(1)
            return fn(x)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(x)
        finally:
            generator.set_state(now)
    return checkpoint(run, x, use_reentrant=False)


def exact_fp32_convolutions() -> None:
    """cuDNN rounds fp32 convolutions to TF32 unless told not to
    (``torch.backends.cudnn.allow_tf32`` is on by default), and not only
    in the call's own scope: a convolution's backward reads the flag when
    it runs. So a process that runs fp32 convolutions (CvT's) turns it
    off for itself: the fp32 path is fp32 throughout."""
    torch.backends.cudnn.allow_tf32 = False


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout (ref:
    models/swin_transformer.py:21-37)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None, drop: float = 0.0):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype, generator=generator)
        self.fc2 = Dense(hidden, dim, dtype=dtype, generator=generator)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.drop(gelu(self.fc1(x)), deterministic, generator)
        return self.drop(self.fc2(x), deterministic, generator)


def softmax_fp32(logits: torch.Tensor, dim: int = -1,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Softmax in fp32, optionally cast back down."""
    p = torch.softmax(logits.float(), dim=dim)
    return p.to(out_dtype) if out_dtype is not None else p
