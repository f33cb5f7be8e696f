"""The data axis of esvit_tpu/parallel/mesh.py, as processes.

The reference is data-parallel only (DDP over NCCL, SURVEY.md §2.9;
ref utils.py:442-465). esvit_tpu lays a ``(data, model)`` device mesh over
every device and lets XLA insert the collectives; the port runs one
process per card, so its data axis is the ``torch.distributed`` group:
each process holds a replica of the parameters and ``1 / world`` of the
batch. The collectives the step needs are here: one coalesced all-reduce
(every tensor of a list flattened into one buffer, one collective,
unflattened) and a gather of host arrays for the evals. Without an
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
