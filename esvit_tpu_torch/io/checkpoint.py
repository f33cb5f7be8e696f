"""Checkpoints of the full training state (port of
esvit_tpu/io/checkpoint.py).

One ``torch.save`` file holds what the reference's checkpoint.pth holds
(main_esvit.py:476-488), as esvit_tpu's tree does: the step, the AdamW
step count, the student's and the teacher's state dicts (the reference's
parameter names, so the evals load the file as they load the
reference's; each net's BatchNorm running statistics are in its own,
as esvit_tpu keeps ``student_state`` and ``teacher_state``), the
optimizer's name and state by parameter name (AdamW's moments ``mu`` /
``nu``, or SGD's / LARS's ``trace``), and both DINO centers. Restoring a
file into a state of another optimizer raises. Every tensor is a host copy, so a checkpoint loads on
a machine without a card. Cadence as the reference's: ``checkpoint.pth``
every epoch (overwritten) and ``checkpoint{epoch:04d}.pth`` every
``save_every_epochs`` epochs or when asked. Each file is written under a
temporary name and then renamed into place, so a save that dies leaves
the last good file. Resume restores everything, centers included, into
the live state's tensors on their device. The step's random draws are
not saved (esvit_tpu does not save them either).

Under the head's tensor parallelism (parallel/mesh.py) a checkpoint is
still whole: the model group gathers the heads' last-layer rows, their
optimizer state and the centers (``Mesh.gather_rows``), so the file is
the one a run of one process writes, and the evals and
``--pretrained_weights_ckpt`` read it unchanged. Any grid restores it:
each rank takes its rows (``Mesh.shard_state``).
"""

from __future__ import annotations

import os
import shutil

import torch

from esvit_tpu_torch.losses import DinoCenters
from esvit_tpu_torch.parallel.mesh import Mesh, is_head_shard
from esvit_tpu_torch.train.step import TrainState

LATEST = "checkpoint"
_PARTS = ("student", "teacher", "mu", "nu", "trace")


def _host(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _whole(state: TrainState, mesh: Mesh | None):
    """The state's tensors by part and name, and the centers, whole where
    they lie: over a model axis the head's rows and the centers gathered
    from ``mesh``'s model group, a collective of its ranks."""
    trees = {"student": state.student.state_dict(),
             "teacher": state.teacher.state_dict(),
             "mu": dict(state.mu), "nu": dict(state.nu),
             "trace": dict(state.trace)}
    centers = {"center": state.centers.center,
               "center_grid": state.centers.center_grid}
    if mesh is not None and mesh.model > 1:
        keys = [(part, k) for part in _PARTS for k in trees[part]
                if is_head_shard(k)]
        whole = mesh.gather_rows([trees[p][k] for p, k in keys]
                                 + list(centers.values()))
        for (part, k), t in zip(keys, whole):
            trees[part][k] = t
        centers = dict(zip(centers, whole[len(keys):]))
    return trees, centers


def state_to_dict(state: TrainState, mesh: Mesh | None = None) -> dict:
    """The state as a tree of ints and host tensors, whole: over a model
    axis every rank of ``mesh``'s model group must call it (they gather
    the head's rows and the centers)."""
    trees, centers = _whole(state, mesh)
    return {
        "step": state.step,
        "adam_count": state.adam_count,
        "student": _host(trees["student"]),
        "teacher": _host(trees["teacher"]),
        "optimizer": state.optimizer,
        "mu": _host(trees["mu"]),
        "nu": _host(trees["nu"]),
        "trace": _host(trees["trace"]),
        "centers": _host(centers),
    }


def load_state_dict(like: TrainState, tree: dict, mesh: Mesh | None = None
                    ) -> TrainState:
    """Copy ``tree`` (whole) into ``like``'s tensors, in place and on their
    device, each rank of ``mesh``'s model axis its rows of the head and
    the centers; every tensor must be there with its shape, and the
    file's optimizer must be the state's (a file without the key is
    AdamW's)."""
    mesh = mesh or Mesh()
    saved_opt = tree.get("optimizer", "adamw")
    if saved_opt != like.optimizer:
        raise ValueError(f"checkpoint of optimizer {saved_opt!r} restored "
                         f"into a {like.optimizer!r} run")
    like.student.load_state_dict(mesh.shard_state(tree["student"]),
                                 strict=True)
    like.teacher.load_state_dict(mesh.shard_state(tree["teacher"]),
                                 strict=True)
    with torch.no_grad():
        for part in ("mu", "nu", "trace"):
            live = getattr(like, part)
            saved = mesh.shard_state(tree.get(part, {}))
            if set(live) != set(saved):
                raise KeyError(f"checkpoint {part} names differ from the "
                               f"model's: {sorted(set(live) ^ set(saved))}")
            for name, t in live.items():
                t.copy_(saved[name])
    c = like.centers
    like.centers = DinoCenters(
        center=mesh.rows(tree["centers"]["center"]).to(c.center.device),
        center_grid=mesh.rows(tree["centers"]["center_grid"]).to(
            c.center_grid.device))
    like.step = int(tree["step"])
    like.adam_count = int(tree["adam_count"])
    return like


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        """The file of checkpoint ``name`` ('checkpoint', 'checkpoint0004'
        or a file name ending in .pth)."""
        if not name.endswith(".pth"):
            name += ".pth"
        return os.path.join(self.directory, name)

    def save(self, state: TrainState, *, epoch: int,
             save_every_epochs: int = 0, force_named: bool = False,
             mesh: Mesh | None = None) -> list[str]:
        """Write checkpoint.pth and, every ``save_every_epochs`` epochs or
        with ``force_named``, checkpoint{epoch:04d}.pth; returns the paths
        written. Every rank of ``mesh`` calls it: rank 0 writes, the other
        ranks of the first data index give it their rows of the head (no
        host copy), and the rest return at once; all but rank 0 return
        []."""
        mesh = mesh or Mesh()
        if mesh.rank != 0:
            if mesh.data_index == 0:
                _whole(state, mesh)
            return []
        tree = state_to_dict(state, mesh)
        tmp = self._path(LATEST) + f".{os.getpid()}.tmp"
        named = None
        if force_named or (save_every_epochs
                           and epoch % save_every_epochs == 0):
            named = self._path(f"{LATEST}{epoch:04d}")
        named_tmp = f"{named}.{os.getpid()}.tmp"
        try:
            torch.save(tree, tmp)
            if named is not None:
                shutil.copyfile(tmp, named_tmp)
                os.replace(named_tmp, named)
            os.replace(tmp, self._path(LATEST))
        finally:
            for left in (tmp, named_tmp):
                if os.path.exists(left):
                    os.remove(left)
        return [self._path(LATEST)] + ([named] if named else [])

    def restore(self, like: TrainState, name: str = LATEST,
                mesh: Mesh | None = None) -> TrainState | None:
        """``like`` with checkpoint ``name`` loaded into it (in place; this
        rank's rows of the head under ``mesh``), or None when there is no
        such file."""
        path = self._path(name)
        if not os.path.isfile(path):
            return None
        tree = torch.load(path, map_location="cpu", weights_only=True)
        return load_state_dict(like, tree, mesh)

    def has_checkpoint(self) -> bool:
        return os.path.isfile(self._path(LATEST))
