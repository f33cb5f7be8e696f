"""The system under test: ``esvit_tpu_torch``'s pre-training step.

The only module of the benchmark that imports the program. It builds the
port's ``TrainConfig`` from a configuration file and a traffic mix,
its ``EsViTTrainer`` and ``TrainState`` on the device, loads the
benchmark's weights into student and teacher, and steps
``EsViTTrainer.train_step`` as ``train()`` calls it
(esvit_tpu_torch/train/train.py). What it reads back for the check comes
from the program's own state: the first gradient from AdamW's first
moments after one step (mu = (1 - b1) g, from zero), and the change of
student and teacher from their parameters.

In the checked steps the student's stochastic depth takes the
benchmark's uniforms (inputs.py ``make_drop_draws``) in place of its own
generator's: each block's ``DropPath.keep_mask`` returns, for its n-th
call of a step on a group of that many crops, uniform < 1 - its rate of
the group's attention row (even n) or MLP row (odd n). The mask goes on
through the program's own path (the fused kernels' keep scales, the
classic blocks' ``apply_mask``); the window's steps draw their own.

``plant`` breaks the step on purpose, for the tests and for the
calibration of the correctness limits (calibrate.py): the benchmark's
runs never call it.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import re

import torch

ADAM_B1 = 0.9
DROP_PATH = re.compile(r"^layers\.(\d+)\.blocks\.(\d+)\.drop_path$")


def train_config(config: dict, traffic: dict):
    from esvit_tpu_torch import config as C

    m, h, lo, o = (config[k] for k in ("model", "head", "loss", "optim"))
    # model kind k is the port's config class named k + "config" in any
    # case (swin -> SwinConfig), built from the group's keys it has
    (cls,) = [c for n, c in vars(C).items()
              if n.lower() == m["kind"] + "config"]
    fields = {f.name for f in dataclasses.fields(cls)}
    model = cls(**{k: tuple(v) if isinstance(v, list) else v
                   for k, v in m.items() if k in fields})
    head = C.HeadConfig(out_dim=h["out_dim"], hidden_dim=h["hidden_dim"],
                        bottleneck_dim=h["bottleneck_dim"],
                        nlayers=h["nlayers"], use_bn=False,
                        norm_last_layer=h["norm_last_layer"])
    loss = C.LossConfig(
        out_dim=h["out_dim"], use_dense_prediction=traffic["region_task"],
        warmup_teacher_temp=lo["warmup_teacher_temp"],
        teacher_temp=lo["teacher_temp"],
        warmup_teacher_temp_epochs=lo["warmup_teacher_temp_epochs"],
        student_temp=lo["student_temp"],
        center_momentum=lo["center_momentum"])
    crops = C.CropConfig(global_size=traffic["global_size"],
                         local_size=traffic["local_size"],
                         local_crops_number=traffic["local_crops"])
    optim = C.OptimConfig(
        optimizer="adamw", lr=o["lr"], min_lr=o["min_lr"],
        warmup_epochs=o["warmup_epochs"], weight_decay=o["weight_decay"],
        weight_decay_end=o["weight_decay_end"],
        momentum_teacher=o["momentum_teacher"], clip_grad=o["clip_grad"],
        freeze_last_layer_epochs=o["freeze_last_layer_epochs"],
        epochs=o["epochs"], batch_size_per_device=traffic["batch_per_card"])
    return C.TrainConfig(model=model, head=head, loss=loss, crops=crops,
                         optim=optim, steps_per_epoch=config["steps_per_epoch"],
                         dtype=getattr(torch, config["compute_dtype"]))


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        from esvit_tpu_torch.parallel.mesh import make_mesh
        from esvit_tpu_torch.train.step import EsViTTrainer

        cfg = train_config(config, traffic)
        self.device = torch.device(device)
        self.trainer = EsViTTrainer(cfg, total_batch_size=traffic[
            "lr_total_batch"], device=self.device, mesh=make_mesh(cfg.mesh))
        # The port's own init runs on the device; load() overwrites it.
        with torch.device(self.device):
            self.state = self.trainer.init_state(
                torch.Generator(device=self.device).manual_seed(0))
        self.state.step = traffic["start_epoch"] * config["steps_per_epoch"]
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        self._fault = None

    def names(self) -> list[str]:
        return [n for n, _ in self.state.student.named_parameters()]

    @torch.no_grad()
    def load(self, weights: dict) -> None:
        for net in (self.state.student, self.state.teacher):
            named = dict(net.named_parameters())
            if set(named) != set(weights):
                raise ValueError("the program's parameters are not the "
                                 "reference's: " + str(sorted(
                                     set(named) ^ set(weights))[:8]))
            names = list(named)
            torch._foreach_copy_([named[n] for n in names],
                                 [weights[n] for n in names])

    def step(self, batch, draws=None) -> torch.Tensor:
        """One train_step; the loss on the device (the caller reads it).
        ``draws``: the step's stochastic-depth uniforms, per crop group
        (blocks, 2, crops), or None for the program's own."""
        if self._fault is not None:
            return self._fault(batch, draws)
        return self._step(batch, draws)

    def _step(self, batch, draws):
        with self._drop_draws(draws):
            self.state, metrics = self.trainer.train_step(self.state, batch,
                                                          self.gen)
        return metrics["loss"]

    @contextlib.contextmanager
    def _drop_draws(self, draws):
        if draws is None:
            yield
            return
        depths = self.trainer.cfg.model.depths
        paths = {}
        for name, module in self.state.student.named_modules():
            m = DROP_PATH.match(name)
            if m:
                s, j = int(m[1]), int(m[2])
                paths[sum(depths[:s]) + j] = module
        calls = collections.Counter()

        def keep_mask_of(k, dp):
            def keep_mask(batch, generator, device):
                groups = [d for d in draws if d.shape[-1] == batch]
                n = calls[k, batch]
                calls[k, batch] += 1
                return groups[n // 2][k, n % 2] < 1.0 - dp.rate
            return keep_mask

        for k, dp in paths.items():
            dp.keep_mask = keep_mask_of(k, dp)
        try:
            yield
        finally:
            for dp in paths.values():
                del dp.keep_mask

    @torch.no_grad()
    def first_grad_norms(self) -> dict[str, float]:
        """After the first step: each leaf's gradient norm as AdamW got
        it, ||mu|| / (1 - b1)."""
        names = self.names()
        norms = torch._foreach_norm([self.state.mu[n] for n in names])
        return dict(zip(names, (torch.stack(norms) / (1 - ADAM_B1))
                        .cpu().tolist()))

    @torch.no_grad()
    def change_norms(self, start: dict) -> dict[str, dict[str, float]]:
        """Each leaf's ||p - p0|| for the student and the teacher."""
        out = {}
        for key, net in (("student", self.state.student),
                         ("teacher", self.state.teacher)):
            named = dict(net.named_parameters())
            names = list(named)
            diff = torch._foreach_sub([named[n] for n in names],
                                      [start[n] for n in names])
            norms = torch.stack(torch._foreach_norm(diff)).cpu().tolist()
            out[key] = dict(zip(names, norms))
            del diff
        return out

    def free(self) -> None:
        del self.state, self.trainer, self._fault

    def plant(self, fault: str) -> None:
        """Break the step: 'unchanged' returns the state as it was (the
        loss computed); 'half_batch' leaves out half the images and
        takes the mean over the rest; 'no_exchange' leaves out the
        all-reduce between processes."""
        if fault == "unchanged":
            def broken(batch, draws):
                keep = copy.deepcopy(self.state)
                loss = self._step(batch, draws)
                self.state = keep
                return loss
        elif fault == "half_batch":
            def broken(batch, draws):
                b = batch[0].shape[0] // 2

                def half(x, dim=0):
                    v = x.shape[dim] // b
                    x = x.unflatten(dim, (v, b)).narrow(dim + 1, 0, b // 2)
                    return x.flatten(dim, dim + 1)

                return self._step(tuple(half(x) for x in batch),
                                  None if draws is None
                                  else [half(d, 2) for d in draws])
        elif fault == "no_exchange":
            self.trainer._all_reduce = lambda loss, grads, sharded: (loss,
                                                                     grads)
            return
        else:
            raise ValueError(f"unknown fault {fault!r}")
        self._fault = broken
