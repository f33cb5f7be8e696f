"""DINO projection head (port of esvit_tpu/models/heads.py).

MLP (hidden 2048, exact GELU) -> bottleneck 256 -> L2 normalise (fp32)
-> weight-normalised linear to out_dim. Parameters carry the reference
checkpoint's names and layouts: ``mlp.{0,2,4}`` Linears (the GELUs sit at
the odd indices), ``last_layer.weight_v`` (out, in) and
``last_layer.weight_g`` (out, 1), as ``torch.nn.utils.weight_norm`` stores
them. The effective weight ``g * v / ||v||`` (per output row) is computed
in ``forward``; with ``norm_last_layer`` g is pinned and gets no gradient
(vision_transformer.py:404-406).

With ``use_bn`` a BatchNorm follows each hidden linear, as the
reference's ``nn.BatchNorm1d`` does (``mlp.{0,3,6}`` Linears, ``mlp.{1,4}``
BatchNorms): flax's default BatchNorm as esvit_tpu builds it (fp32 out,
momentum 0.99, eps 1e-5), then the exact GELU in fp32. Its mode follows
esvit_tpu's rule, ``use_running_average=deterministic``
(esvit_tpu/models/heads.py:98-100): the student's head normalises by the
batch and updates its buffers, the teacher's (deterministic) by its
running buffers, which therefore never move. The statistics are global
over the process group (parallel/mesh.py ``Mesh.batch_norm``).

Under the head's tensor parallelism (parallel/mesh.py) the last layer
holds ``shard = (index, count)``'s rows of the whole (out, in) matrix,
drawn whole from the generator so that every grid starts from the
weights of one process, and the head emits that slice of the logits; the
weight norm is per output row, so it stays within the slice.

``bottleneck`` and ``last_weight`` are the head's two halves, for the
K-streamed loss (losses.ddino_loss_streamed), which contracts the
bottleneck with the last layer chunk by chunk.
"""

from __future__ import annotations

import torch
from torch import nn

from esvit_tpu_torch.config import HeadConfig
from esvit_tpu_torch.models.batchnorm import BatchNorm
from esvit_tpu_torch.models.common import Dense, gelu, trunc_normal_

HEAD_BN_MOMENTUM = 0.99         # flax nn.BatchNorm's default


class _GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class WeightNormDense(nn.Module):
    """x @ (g * v / ||v||)^T, rows of v normalised, no bias; with
    ``shard = (index, count)``, rows ``index`` of ``count`` equal slices
    of the dout rows."""

    def __init__(self, din: int, dout: int, norm_last_layer: bool = True,
                 dtype=torch.float32, generator=None,
                 shard: tuple[int, int] = (0, 1)):
        super().__init__()
        self.norm_last_layer = norm_last_layer
        self.dtype = dtype
        v = trunc_normal_(torch.empty(dout, din), generator=generator)
        index, count = shard
        if count > 1:
            if dout % count:
                raise ValueError(f"{dout} rows do not split {count} ways")
            rows = dout // count
            v = v[index * rows:(index + 1) * rows].clone()
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.ones(v.shape[0], 1))

    def weight(self) -> torch.Tensor:
        """Effective (out, in) matrix in the compute dtype."""
        g = self.weight_g.detach() if self.norm_last_layer else self.weight_g
        norm = torch.linalg.vector_norm(self.weight_v, dim=1, keepdim=True)
        return (g * self.weight_v / (norm + 1e-12)).to(self.dtype)

    def forward(self, x):
        return nn.functional.linear(x.to(self.dtype), self.weight())


class DINOHead(nn.Module):

    def __init__(self, cfg: HeadConfig, in_dim: int, dtype=torch.float32,
                 generator=None, shard: tuple[int, int] = (0, 1)):
        super().__init__()
        nlayers = max(cfg.nlayers, 1)
        if nlayers == 1:
            self.mlp = Dense(in_dim, cfg.bottleneck_dim, dtype=dtype,
                             generator=generator)
        else:
            def hidden(din):
                bn = ([BatchNorm(cfg.hidden_dim, momentum=HEAD_BN_MOMENTUM)]
                      if cfg.use_bn else [])
                return [Dense(din, cfg.hidden_dim, dtype=dtype,
                              generator=generator), *bn, _GELU()]

            layers = hidden(in_dim)
            for _ in range(nlayers - 2):
                layers += hidden(cfg.hidden_dim)
            layers.append(Dense(cfg.hidden_dim, cfg.bottleneck_dim,
                                dtype=dtype, generator=generator))
            self.mlp = nn.Sequential(*layers)
        self.last_layer = WeightNormDense(cfg.bottleneck_dim, cfg.out_dim,
                                          cfg.norm_last_layer, dtype, generator,
                                          shard)
        self.dtype = dtype

    def bottleneck(self, x, deterministic: bool = True):
        """MLP + L2 normalise in fp32 (F.normalize, eps 1e-12)."""
        if isinstance(self.mlp, nn.Sequential):
            for layer in self.mlp:
                if isinstance(layer, BatchNorm):
                    x = layer(x, bn_train=not deterministic,
                              out_dtype=torch.float32)
                else:
                    x = layer(x)
        else:
            x = self.mlp(x)
        x32 = x.float()
        norm = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
        return (x32 / torch.clamp(norm, min=1e-12)).to(self.dtype)

    def last_weight(self) -> torch.Tensor:
        """The last layer's effective (out_dim, bottleneck) matrix (this
        shard's rows) in the compute dtype."""
        return self.last_layer.weight()

    def forward(self, x, deterministic: bool = True):
        return self.last_layer(self.bottleneck(x, deterministic))
