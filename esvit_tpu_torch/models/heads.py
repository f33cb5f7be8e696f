"""DINO projection head (port of esvit_tpu/models/heads.py).

MLP (hidden 2048, exact GELU) -> bottleneck 256 -> L2 normalise (fp32)
-> weight-normalised linear to out_dim. Parameters carry the reference
checkpoint's names and layouts: ``mlp.{0,2,4}`` Linears (the GELUs sit at
the odd indices), ``last_layer.weight_v`` (out, in) and
``last_layer.weight_g`` (out, 1), as ``torch.nn.utils.weight_norm`` stores
them. The effective weight ``g * v / ||v||`` (per output row) is computed
in ``forward``; with ``norm_last_layer`` g is pinned and gets no gradient
(vision_transformer.py:404-406).
"""

from __future__ import annotations

import torch
from torch import nn

from esvit_tpu_torch.config import HeadConfig
from esvit_tpu_torch.models.common import Dense, gelu, trunc_normal_


class _GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class WeightNormDense(nn.Module):
    """x @ (g * v / ||v||)^T, rows of v normalised, no bias."""

    def __init__(self, din: int, dout: int, norm_last_layer: bool = True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.norm_last_layer = norm_last_layer
        self.dtype = dtype
        self.weight_v = nn.Parameter(trunc_normal_(torch.empty(dout, din),
                                                   generator=generator))
        self.weight_g = nn.Parameter(torch.ones(dout, 1))

    def weight(self) -> torch.Tensor:
        """Effective (out, in) matrix in the compute dtype."""
        g = self.weight_g.detach() if self.norm_last_layer else self.weight_g
        norm = torch.linalg.vector_norm(self.weight_v, dim=1, keepdim=True)
        return (g * self.weight_v / (norm + 1e-12)).to(self.dtype)

    def forward(self, x):
        return nn.functional.linear(x.to(self.dtype), self.weight())


class DINOHead(nn.Module):

    def __init__(self, cfg: HeadConfig, in_dim: int, dtype=torch.float32,
                 generator=None):
        super().__init__()
        nlayers = max(cfg.nlayers, 1)
        if nlayers == 1:
            self.mlp = Dense(in_dim, cfg.bottleneck_dim, dtype=dtype,
                             generator=generator)
        else:
            layers = [Dense(in_dim, cfg.hidden_dim, dtype=dtype,
                            generator=generator), _GELU()]
            for _ in range(nlayers - 2):
                layers += [Dense(cfg.hidden_dim, cfg.hidden_dim, dtype=dtype,
                                 generator=generator), _GELU()]
            layers.append(Dense(cfg.hidden_dim, cfg.bottleneck_dim,
                                dtype=dtype, generator=generator))
            self.mlp = nn.Sequential(*layers)
        self.last_layer = WeightNormDense(cfg.bottleneck_dim, cfg.out_dim,
                                          cfg.norm_last_layer, dtype, generator)
        self.dtype = dtype

    def bottleneck(self, x):
        """MLP + L2 normalise in fp32 (F.normalize, eps 1e-12)."""
        x32 = self.mlp(x).float()
        norm = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
        return (x32 / torch.clamp(norm, min=1e-12)).to(self.dtype)

    def forward(self, x):
        return self.last_layer(self.bottleneck(x))
