"""The data axis of esvit_tpu/parallel/mesh.py, as processes.

The reference is data-parallel only (DDP over NCCL, SURVEY.md §2.9;
ref utils.py:442-465). esvit_tpu lays a ``(data, model)`` device mesh over
every device and lets XLA insert the collectives; the port runs one
process per card, so its data axis is the ``torch.distributed`` group:
each process holds a replica of the parameters and ``1 / world`` of the
batch. The collectives the step needs are here: one coalesced all-reduce
(every tensor of a list flattened into one buffer, one collective,
unflattened), a gather of host arrays for the evals, and BatchNorm's
batch statistics over the global batch (:meth:`Mesh.batch_norm`), as
esvit_tpu gets them from pjit's global reductions (esvit_tpu/models/
cvt.py:7-8; SyncBN in the reference, main_esvit.py:367-372). Without an
initialised group every collective is the identity; in a group, of one
process too, each runs (a group of one on NCCL runs the card's
collectives and gives back its input).

esvit_tpu's model axis (``MeshConfig.model > 1``, the DINO head's tensor
parallelism) is ROADMAP queue 1 item 12 and refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from esvit_tpu_torch.config import MeshConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: this process's ``rank`` of ``world``;
    ``distributed`` when a process group is initialised."""

    world: int = 1
    rank: int = 0
    distributed: bool = False

    def all_reduce_sum(self, tensors: list[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """The element-wise sum over processes of each tensor, in one
        collective over one flat fp32 buffer."""
        if not self.distributed:
            return list(tensors)
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def all_reduce_mean(self, tensors: list[torch.Tensor]
                        ) -> list[torch.Tensor]:
        """The mean over processes of each tensor, in one collective."""
        if not self.distributed:
            return list(tensors)
        return [t / self.world for t in self.all_reduce_sum(tensors)]

    def batch_norm(self, x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training-mode BatchNorm of fp32 ``x`` (rows, C) over the rows of
        every process: (y, mean, var), var the biased variance E[x^2] -
        E[x]^2 clipped at 0, and y = (x - mean) * (rsqrt(var + eps) *
        weight) + bias, flax's order. One all-reduce of (sum, sum of
        squares, count) forward and one of (sum dy, sum dy * xhat)
        backward; with no group, plain BatchNorm. The gradient of
        weight and bias is this process's own (the step averages it)."""
        return _GlobalBatchNorm.apply(x, weight, bias, eps, self)

    def all_gather(self, x: np.ndarray) -> np.ndarray:
        """(world, *x.shape): every process's ``x``, in rank order. The
        arrays must have one shape and dtype on every process."""
        if not self.distributed:
            return x[None]
        device = ("cuda" if dist.get_backend() == dist.Backend.NCCL
                  else "cpu")
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return np.stack([p.cpu().numpy() for p in parts])


class _GlobalBatchNorm(torch.autograd.Function):
    """Mesh.batch_norm. The backward is the analytic one of the global
    statistics: with xhat = (x - mean) * rstd and N the global rows,
    dx = weight * rstd * (dy - sum(dy) / N - xhat * sum(dy * xhat) / N),
    the sums over every process's rows (each process's dy is the
    gradient of its own loss; the step averages the parameters'
    gradients, which makes this the gradient of the mean loss)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        count = torch.full((1,), float(x.shape[0]), device=x.device)
        s1, s2, n = mesh.all_reduce_sum([x.sum(0), (x * x).sum(0), count])
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        xc = x - mean
        y = xc * (rstd * weight) + bias
        ctx.save_for_backward(xc, rstd, weight, n)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xc, rstd, weight, n = ctx.saved_tensors
        xhat = xc * rstd
        sum_dy = dy.sum(0)
        sum_dy_xhat = (dy * xhat).sum(0)
        g1, g2 = ctx.mesh.all_reduce_sum([sum_dy, sum_dy_xhat])
        dx = (weight * rstd) * (dy - g1 / n - xhat * (g2 / n))
        return dx, sum_dy_xhat, sum_dy, None, None


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The data axis over the initialised process group (one process, no
    group: world 1)."""
    cfg = cfg or MeshConfig()
    if cfg.model > 1:
        raise NotImplementedError(
            f"MeshConfig(model={cfg.model}), the DINO head's tensor "
            "parallelism, is not ported yet (ROADMAP queue 1 item 12)")
    mesh = (Mesh(world=dist.get_world_size(), rank=dist.get_rank(),
                 distributed=True)
            if dist.is_available() and dist.is_initialized() else Mesh())
    if cfg.data > 0 and cfg.data != mesh.world:
        raise ValueError(f"mesh data axis {cfg.data} != {mesh.world} "
                         "processes")
    return mesh
