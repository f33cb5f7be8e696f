"""BatchNorm with esvit_tpu's semantics (flax ``nn.BatchNorm`` as
esvit_tpu/models/cvt.py:58 uses it), on channels-last input.

- It runs in fp32 on ``x.float()`` and casts its output back to the
  input's dtype (or to ``out_dtype``); eps 1e-5.
- ``bn_train`` is its own flag, apart from ``deterministic``: True
  normalises by the batch's statistics and updates the running buffers,
  False normalises by the running buffers. The teacher runs
  ``deterministic=True, bn_train=True`` (esvit_tpu/models/esvit.py:53-80).
- The running variance takes the biased batch variance, E[x^2] - E[x]^2,
  as flax's does (``F.batch_norm``'s own update takes the unbiased one,
  so it is not used): running = m * running + (1 - m) * batch, flax's
  ``momentum`` m (torch's 1 - m). CvT's and ResNet's take 0.9
  (esvit_tpu/models/cvt.py:58, resnet.py:40), the DINO head's flax's
  default 0.99 (esvit_tpu/models/heads.py:71-80). Each forward call updates the buffers
  once, so the student's two resolution groups update them one after the
  other, as flax's mutable ``batch_stats`` do.
- The batch statistics are global over the data axis of the process
  grid (parallel/mesh.py ``Mesh.batch_norm``), with a gradient through
  them: the grid is ``mesh``, which the trainer sets (the model ranks of
  a data index hold the same samples), else ``make_mesh()``'s.

The names are ``torch.nn.BatchNorm2d``'s (``weight``, ``bias``,
``running_mean``, ``running_var``); there is no ``num_batches_tracked``,
which loading a reference checkpoint skips.
"""

from __future__ import annotations

import torch
from torch import nn

from esvit_tpu_torch.parallel.mesh import make_mesh


class BatchNorm(nn.Module):

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.mesh = None

    def forward(self, x: torch.Tensor, bn_train: bool,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
        """x (..., C) -> the same shape, in x's dtype or ``out_dtype``."""
        C = x.shape[-1]
        xf = x.float().reshape(-1, C)
        if bn_train:
            y, mean, var = (self.mesh or make_mesh()).batch_norm(
                xf, self.weight, self.bias, self.eps)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (xf - self.running_mean) * mul + self.bias
        return y.reshape(x.shape).to(out_dtype or x.dtype)
