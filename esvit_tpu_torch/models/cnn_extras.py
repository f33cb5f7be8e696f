"""CNN helper modules (port of esvit_tpu/models/cnn_extras.py; ref:
layers/{se_layer,dropblock,dy_relu,batch_norm}.py).

Standalone modules for the reference's CNN experiments, none on the
EsViT main path. Input is channels-last (B, H, W, C), as in esvit_tpu.

- ``SELayer2D``: squeeze-excitation, fc1 -> ReLU -> fc2 -> sigmoid gate.
- ``h_sigmoid`` / ``DyReLU2``: dynamic ReLU-B, max(a1 x + b1, a2 x + b2)
  with the four coefficients from a squeeze head, split a1, b1, a2, b2.
- ``FrozenBatchNorm``: y = (x - mean) / sqrt(var + eps) * weight + bias,
  all four buffers (flax keeps them in the ``frozen_stats`` collection).
- ``DropBlock``: contiguous blocks zeroed, the keep probability ramped
  by ``progress``, the uniform draws from an explicit generator;
  ``dropblock_mask`` builds the mask from a given uniform field.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from esvit_tpu_torch.models.common import Dense


class SELayer2D(nn.Module):
    """Squeeze-excitation on (B, H, W, C) maps (ref: se_layer.py:4-19)."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Dense(channels, channels // reduction, bias=False,
                         dtype=dtype, generator=generator)
        self.fc2 = Dense(channels // reduction, channels, bias=False,
                         dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc2(torch.relu(self.fc1(x.mean(dim=(1, 2)))))
        return x * torch.sigmoid(y)[:, None, None, :]


def h_sigmoid(x: torch.Tensor, h_max: float = 1.0) -> torch.Tensor:
    """relu6(x + 3) * h_max / 6 (ref: dy_relu.py:18-25)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) * h_max / 6.0


class DyReLU2(nn.Module):
    """Dynamic ReLU-B (ref: dy_relu.py:28-101, K2=True, use_bias=True):
    per-channel slopes and intercepts from a squeeze head."""

    def __init__(self, channels: int, reduction: int = 4,
                 lambda_a: float = 1.0,
                 init_a: Sequence[float] = (1.0, 0.0),
                 init_b: Sequence[float] = (0.0, 0.0),
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lambda_a, self.init_a, self.init_b = lambda_a, init_a, init_b
        squeeze = channels // reduction
        self.fc1 = Dense(channels, squeeze, dtype=dtype, generator=generator)
        self.fc2 = Dense(squeeze, 4 * channels, dtype=dtype,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lam = self.lambda_a * 2.0
        y = self.fc2(torch.relu(self.fc1(x.mean(dim=(1, 2)))))
        a1, b1, a2, b2 = h_sigmoid(y)[:, None, None, :].chunk(4, dim=-1)
        a1 = (a1 - 0.5) * lam + self.init_a[0]
        a2 = (a2 - 0.5) * lam + self.init_a[1]
        b1 = b1 - 0.5 + self.init_b[0]
        b2 = b2 - 0.5 + self.init_b[1]
        return torch.maximum(x * a1 + b1, x * a2 + b2)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed affine and statistics (ref: batch_norm.py:10-121
    FrozenBatchNorm2d), in fp32, cast to ``dtype``."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x.float() * scale + shift).to(self.dtype)


def dropblock_mask(u: torch.Tensor, block_size: int, gamma: float
                   ) -> torch.Tensor:
    """The fp32 keep mask (B, H, W, C) of DropBlock from the uniform field
    ``u`` of the same shape: a centre where u < gamma and the whole block
    fits in the map (``bs // 2`` from the top / left edge, ``(bs - 1) // 2``
    from the bottom / right), each centre grown to a bs x bs block by a
    stride-1 SAME max-pool."""
    B, H, W, C = u.shape
    bs = block_size
    i = torch.arange(H, device=u.device)[:, None]
    j = torch.arange(W, device=u.device)[None, :]
    valid = ((i >= bs // 2) & (i < H - (bs - 1) // 2)
             & (j >= bs // 2) & (j < W - (bs - 1) // 2))
    centres = ((u < gamma) & valid[None, :, :, None]).float()
    lo = (bs - 1) // 2                              # SAME: the extra pad after
    padded = F.pad(centres.permute(0, 3, 1, 2), (lo, bs - 1 - lo, lo,
                                                 bs - 1 - lo))
    blocks = F.max_pool2d(padded, bs, stride=1).permute(0, 2, 3, 1)
    return 1.0 - blocks


class DropBlock(nn.Module):
    """DropBlock with a linear keep-probability ramp (ref: dropblock.py:6-75):
    ``progress`` in [0, 1] takes the keep probability from 1 to
    ``keep_prob``; the output is rescaled by the kept fraction (floor
    1e-6). ``gamma`` uses W twice, as esvit_tpu does."""

    def __init__(self, block_size: int = 7, keep_prob: float = 0.9):
        super().__init__()
        self.block_size, self.keep_prob = block_size, keep_prob

    def gamma(self, W: int, progress: float) -> tuple[int, float]:
        """(block size, centre rate) at ``progress`` for maps W wide."""
        keep = 1.0 - progress * (1.0 - self.keep_prob)
        bs = min(self.block_size, W)
        return bs, (1.0 - keep) * W * W / bs ** 2 / (W - bs + 1) ** 2

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                progress: float = 1.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if deterministic or self.keep_prob >= 1.0:
            return x
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return self.apply_mask(x, dropblock_mask(
            u, *self.gamma(x.shape[2], progress)))

    @staticmethod
    def apply_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x masked and rescaled by the kept fraction (floor 1e-6)."""
        kept = torch.clamp(mask.mean(), min=1e-6)
        return x * mask.to(x.dtype) / kept.to(x.dtype)
