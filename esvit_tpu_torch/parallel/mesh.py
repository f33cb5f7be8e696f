"""The (data, model) process grid of esvit_tpu/parallel/mesh.py.

The reference is data-parallel only (DDP over NCCL, SURVEY.md §2.9;
ref utils.py:442-465). esvit_tpu lays its devices out as
``reshape(data, model)`` and lets XLA insert the collectives; the port
runs one process per device of that grid: rank r sits at data index
``r // model`` and model index ``r % model``. Batches are split over the
data axis only, so the ``model`` ranks of one data index hold the same
samples. Every parameter is replicated except the DINO heads' last
layers (``weight_v``, ``weight_g``; ``is_head_shard``), whose rows, the
out dim (esvit_tpu's columns), are split over the model axis
(esvit_tpu/parallel/mesh.py:47-65): each rank holds rows ``[m K/model,
(m+1) K/model)`` and emits that slice of the logits; the DINO centers and
those rows' optimizer state go with them.

Each rank belongs to two groups beside the world: its data group (the
ranks of its model index, one per data index) and its model group (the
ranks of its data index). The collectives the step needs are here:
``all_reduce_sum`` / ``all_reduce_mean`` over the group they name, in
one collective over one flat fp32 buffer; ``model_max`` and
``model_sum``, the loss's reductions over K (losses.py); BatchNorm's
batch statistics over the data group (:meth:`Mesh.batch_norm`, as
esvit_tpu gets them from pjit's global reductions, esvit_tpu/models/
cvt.py:7-8; SyncBN in the reference, main_esvit.py:367-372);
``gather_rows``, the whole head for a checkpoint; ``any``, a flag agreed
over the world (a SIGTERM that one rank got, so that every rank saves);
a gather of host arrays for the evals. Every model-axis collective is an all-reduce or a
broadcast, the two that gloo takes on CUDA tensors, so two ranks can
share one card over gloo (NCCL takes one rank per card).

``model_sum`` is the sum over the model group with an identity backward.
Each model rank computes the same loss from the summed statistics, so the
gradient that reaches the sum is the same on every rank, and it is the
gradient of this rank's own term: the backward passes it on unchanged.
(``torch.distributed.nn``'s all-reduce would sum it over the ranks, which
gives each rank ``model`` times its gradient.) A rank's backward reaches
the replicated parameters only through its own rows, so their gradients
are its shares of a sum over the model group: the step sums them
(train/step.py).

Without an initialised group every collective is the identity; in a
group, of one process too, each collective over the world runs (a group
of one on NCCL runs the card's collectives and gives back its input);
the data and model groups of a grid skip theirs where they hold one
rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from esvit_tpu_torch.config import MeshConfig, check_mesh

_SUM = dist.ReduceOp.SUM if dist.is_available() else None
_MAX = dist.ReduceOp.MAX if dist.is_available() else None


def is_head_shard(name: str) -> bool:
    """Whether parameter ``name`` is split over the model axis: a DINO
    head's last-layer ``weight_v`` or ``weight_g`` (esvit_tpu's
    ``kernel_v`` / ``scale_g``)."""
    parts = name.split(".")
    return "last_layer" in parts and parts[-1] in ("weight_v", "weight_g")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's ``rank`` of ``world``, ``model`` ranks to a data
    index; ``distributed`` when a process group is initialised."""

    world: int = 1
    rank: int = 0
    distributed: bool = False
    model: int = 1
    # The data and model process groups of a grid (model > 1).
    groups: dict | None = dataclasses.field(default=None, compare=False,
                                            repr=False)

    def __deepcopy__(self, memo):
        return self             # immutable; its process groups are shared

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def size(self, over: str) -> int:
        return {"world": self.world, "data": self.data,
                "model": self.model}[over]

    def _reduce_(self, flat: torch.Tensor, over: str, op) -> None:
        """``flat`` reduced in place over the group ``over`` ('world',
        'data' or 'model')."""
        if self.model == 1 and over == "data":
            over = "world"
        if not self.distributed or (over != "world" and self.size(over) == 1):
            return
        group = None if over == "world" else self.groups[over]
        dist.all_reduce(flat, op=op, group=group)

    def _broadcast_(self, buf: torch.Tensor, m: int) -> None:
        """``buf`` of model rank ``m`` of this rank's model group, in
        place on each of its ranks."""
        dist.broadcast(buf, src=self.data_index * self.model + m,
                       group=self.groups["model"])

    def _flat_reduce(self, tensors, over, op):
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        self._reduce_(flat, over, op)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def all_reduce_sum(self, tensors: list[torch.Tensor], *, over: str
                       ) -> list[torch.Tensor]:
        """The element-wise sum of each tensor over the group ``over``
        ('world', 'data' or 'model'), in one collective over one flat
        fp32 buffer."""
        if not self.distributed:
            return list(tensors)
        return self._flat_reduce(tensors, over, _SUM)

    def all_reduce_mean(self, tensors: list[torch.Tensor], *, over: str
                        ) -> list[torch.Tensor]:
        """The mean of each tensor over the group ``over``, in one
        collective."""
        if not self.distributed:
            return list(tensors)
        n = self.size(over)
        return [t / n for t in self.all_reduce_sum(tensors, over=over)]

    def any(self, flag: bool, device) -> bool:
        """Whether ``flag`` holds on any rank of the world: one all-reduce
        of a flag on ``device``, all ranks calling it."""
        if not self.distributed:
            return flag
        t = torch.tensor([float(flag)], device=device)
        self._reduce_(t, "world", _MAX)
        return bool(t.item())

    def model_max(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The element-wise max over the model group, without gradient."""
        return self._flat_reduce(tensors, "model", _MAX)

    def model_sum(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The element-wise sum over the model group, with the identity
        backward (module docstring), in one collective."""
        if self.model == 1:
            return list(tensors)
        return list(_ModelSum.apply(self, *tensors))

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole tensor split over the model axis."""
        if self.model == 1:
            return t
        if t.shape[0] % self.model:
            raise ValueError(f"{t.shape[0]} rows do not split over the "
                             f"model axis {self.model}")
        n = t.shape[0] // self.model
        return t[self.model_index * n:(self.model_index + 1) * n].clone()

    def shard_state(self, tensors: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
        """A whole state dict (or optimizer state by parameter name) with
        the head shards cut to this rank's rows."""
        return {k: self.rows(v) if is_head_shard(k) else v
                for k, v in tensors.items()}

    def gather_rows(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The whole tensors from each model rank's rows of them, on every
        rank of the model group, bit for bit: each rank broadcasts its
        rows of all of them in one flat buffer (of their common dtype)."""
        if self.model == 1 or not tensors:
            return list(tensors)
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        parts = []
        for m in range(self.model):
            buf = flat.clone() if m == self.model_index else torch.empty_like(
                flat)
            self._broadcast_(buf, m)
            parts.append(buf)
        out, off = [], 0
        for t in tensors:
            out.append(torch.cat([p[off:off + t.numel()].view(t.shape)
                                  for p in parts]))
            off += t.numel()
        return out

    def batch_norm(self, x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training-mode BatchNorm of fp32 ``x`` (rows, C) over the rows of
        every process of the data group (model ranks hold the same
        samples): (y, mean, var), var the biased variance E[x^2] -
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


class _ModelSum(torch.autograd.Function):
    """Mesh.model_sum: forward the sum over the model group, backward the
    identity."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        return tuple(mesh._flat_reduce(tensors, "model", _SUM))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


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
        s1, s2, n = mesh.all_reduce_sum([x.sum(0), (x * x).sum(0), count],
                                        over="data")
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
        g1, g2 = ctx.mesh.all_reduce_sum([sum_dy, sum_dy_xhat], over="data")
        dx = (weight * rstd) * (dy - g1 / n - xhat * (g2 / n))
        return dx, sum_dy_xhat, sum_dy, None, None


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The (data, model) grid over the initialised process group (one
    process, no group: world 1), its data and model groups made in the
    same order on every rank (``dist.new_group`` is collective)."""
    cfg = cfg or MeshConfig()
    distributed = dist.is_available() and dist.is_initialized()
    world, rank = ((dist.get_world_size(), dist.get_rank()) if distributed
                   else (1, 0))
    check_mesh(cfg, world)
    model = max(cfg.model, 1)
    if not distributed:
        return Mesh()
    groups = None
    if model > 1:
        groups = {}
        data = world // model
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups["model"] = group
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups["data"] = group
    return Mesh(world=world, rank=rank, distributed=True, model=model,
                groups=groups)
