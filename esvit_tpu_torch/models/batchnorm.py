"""BatchNorm with esvit_tpu's semantics (flax ``nn.BatchNorm`` as
esvit_tpu/models/cvt.py:58 uses it), on channels-last input.

- It runs in fp32 on ``x.float()`` and casts its output back to the
  input's dtype; eps 1e-5.
- ``bn_train`` is its own flag, apart from ``deterministic``: True
  normalises by the batch's statistics and updates the running buffers,
  False normalises by the running buffers. The teacher runs
  ``deterministic=True, bn_train=True`` (esvit_tpu/models/esvit.py:53-80).
- The running variance takes the biased batch variance, E[x^2] - E[x]^2,
  as flax's does (``F.batch_norm``'s own update takes the unbiased one,
  so it is not used): running = 0.9 * running + 0.1 * batch (flax's
  momentum 0.9 is torch's 0.1). Each forward call updates the buffers
  once, so the student's two resolution groups update them one after the
  other, as flax's mutable ``batch_stats`` do.
- The batch statistics are global over the process group
  (parallel/mesh.py ``Mesh.batch_norm``), with a gradient through them.

The names are ``torch.nn.BatchNorm2d``'s (``weight``, ``bias``,
``running_mean``, ``running_var``); there is no ``num_batches_tracked``,
which loading a reference checkpoint skips.
"""

from __future__ import annotations

import torch
from torch import nn

from esvit_tpu_torch.parallel.mesh import make_mesh

MOMENTUM = 0.9          # flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch


class BatchNorm(nn.Module):

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, bn_train: bool) -> torch.Tensor:
        """x (..., C) -> the same shape and dtype."""
        C = x.shape[-1]
        xf = x.float().reshape(-1, C)
        if bn_train:
            y, mean, var = make_mesh().batch_norm(xf, self.weight, self.bias,
                                                  self.eps)
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean
                                        + (1.0 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var
                                       + (1.0 - MOMENTUM) * var)
        else:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (xf - self.running_mean) * mul + self.bias
        return y.reshape(x.shape).to(x.dtype)
