"""The EsViT training step (port of esvit_tpu/train/step.py).

Teacher forward on the 2 global views (no autograd), student forward and
backward on all views, DINO/DDINO loss with the center EMA, per-param
clip, last-layer freeze, AdamW and the teacher EMA with cosine momentum.
Schedules are evaluated from the step counter.

Compute is bf16 by explicit casts inside each module, as the JAX modules
do; parameters, gradients and optimizer moments stay fp32. There is no
GradScaler and no autocast (autocast would round in other places). The
step updates the state in place: parameters, moments and teacher are
written where they lie.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch

from esvit_tpu_torch import losses
from esvit_tpu_torch.config import TrainConfig, check_supported
from esvit_tpu_torch.models.esvit import EsViTModel
from esvit_tpu_torch.train import optim as optim_lib
from esvit_tpu_torch.utils import schedules


def _span(name: str):
    """A named range in torch.profiler traces (utils/profile.py reads
    them); costs about a microsecond when no profiler runs."""
    return torch.profiler.record_function(f"esvit/{name}")


@dataclasses.dataclass
class TrainState:
    step: int                                 # global step
    student: EsViTModel                       # fp32 params
    teacher: EsViTModel                       # fp32 params, EMA of student
    mu: dict[str, torch.Tensor]               # AdamW first moments by name
    nu: dict[str, torch.Tensor]               # AdamW second moments by name
    adam_count: int                           # AdamW steps taken
    centers: losses.DinoCenters


class EsViTTrainer:
    """Builds the model, schedules and the step function."""

    def __init__(self, cfg: TrainConfig, total_batch_size: int | None = None,
                 device: torch.device | str = "cpu"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        o = cfg.optim
        self.total_steps = o.epochs * cfg.steps_per_epoch
        self.warmup_steps = o.warmup_epochs * cfg.steps_per_epoch
        # Linear LR scaling rule (main_esvit.py:423): lr * total_batch / 256.
        tb = (total_batch_size if total_batch_size is not None
              else o.batch_size_per_device)
        self.base_lr = o.lr * tb / 256.0
        self.lr_fn = functools.partial(
            schedules.cosine_schedule, base_value=self.base_lr,
            final_value=o.min_lr, total_steps=self.total_steps,
            warmup_steps=self.warmup_steps)
        self.wd_fn = functools.partial(
            schedules.cosine_schedule, base_value=o.weight_decay,
            final_value=o.weight_decay_end, total_steps=self.total_steps)
        self.momentum_fn = functools.partial(
            schedules.cosine_schedule, base_value=o.momentum_teacher,
            final_value=1.0, total_steps=self.total_steps)
        self.teacher_temp_fn = functools.partial(
            schedules.teacher_temp_schedule,
            warmup_teacher_temp=cfg.loss.warmup_teacher_temp,
            teacher_temp=cfg.loss.teacher_temp,
            warmup_teacher_temp_epochs=cfg.loss.warmup_teacher_temp_epochs)

    def build_model(self, generator: torch.Generator | None = None) -> EsViTModel:
        cfg = self.cfg
        return EsViTModel(cfg.model, cfg.head,
                          use_dense_prediction=cfg.loss.use_dense_prediction,
                          dtype=cfg.dtype, generator=generator)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Random weights from ``generator`` (a CPU generator, so a seed
        gives the same weights on every device); the teacher starts as a
        copy of the student (main_esvit.py:380-383)."""
        student = self.build_model(generator).to(self.device)
        teacher = copy.deepcopy(student).requires_grad_(False)
        named = dict(student.named_parameters())
        return TrainState(
            step=0, student=student, teacher=teacher,
            mu={n: torch.zeros_like(p) for n, p in named.items()},
            nu={n: torch.zeros_like(p) for n, p in named.items()},
            adam_count=0,
            centers=losses.DinoCenters.zeros(self.cfg.loss.out_dim,
                                              self.device))

    def train_step(self, state: TrainState, batch,
                   generator: torch.Generator | None = None):
        """batch: per-resolution crop tensors ((2B, Sg, Sg, 3), (L*B, Sl,
        Sl, 3)) on the device. ``generator`` draws drop-path masks.
        Returns (state, metrics); the state is updated in place."""
        cfg = self.cfg
        B = batch[0].shape[0] // 2
        ncrops = 2 + (batch[1].shape[0] // B if len(batch) > 1 else 0)
        step = state.step
        epoch = step // cfg.steps_per_epoch
        t_temp = self.teacher_temp_fn(epoch)
        dtype = cfg.dtype

        with torch.no_grad(), _span("teacher_forward"):
            t_out = state.teacher((batch[0].to(dtype),), deterministic=True,
                                  batch_size=B)
        with _span("student_forward"):
            s_out = state.student(tuple(b.to(dtype) for b in batch),
                                  deterministic=False, generator=generator,
                                  batch_size=B)
        with _span("loss"):
            loss, new_centers = self._loss(state, s_out, t_out, t_temp,
                                           ncrops, B)

        names, params = zip(*state.student.named_parameters())
        with _span("backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        # A pinned weight_g (norm_last_layer) gets no gradient: zeros, as
        # JAX's stop_gradient gives.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]

        ll = optim_lib.last_layer_mask(dict(zip(names, params)))
        ll_mask = [ll[n] for n in names]
        frozen = epoch < cfg.optim.freeze_last_layer_epochs
        decay = optim_lib.wd_mask(dict(zip(names, params)),
                                  decay_scale_g=not cfg.head.norm_last_layer)
        teacher = dict(state.teacher.named_parameters())
        m = self.momentum_fn(step)
        lr, wd = self.lr_fn(step), self.wd_fn(step)
        with torch.no_grad(), _span("optimizer"):
            norms = torch._foreach_norm([g for g, llm in zip(grads, ll_mask)
                                         if not (frozen and llm)])
            grad_norm = torch.linalg.vector_norm(torch.stack(norms))
            optim_lib.fused_adamw_ema_apply(
                grads, list(params), [state.mu[n] for n in names],
                [state.nu[n] for n in names], [teacher[n] for n in names],
                count=state.adam_count, lr=lr, wd=wd, ema_m=m,
                clip=cfg.optim.clip_grad, decay_mask=[decay[n] for n in names],
                ll_mask=ll_mask, frozen=frozen)

        state.step += 1
        state.adam_count += 1
        state.centers = new_centers
        metrics = {"loss": loss.detach(), "lr": lr, "wd": wd,
                   "teacher_momentum": m, "teacher_temp": t_temp,
                   "grad_norm": grad_norm}
        return state, metrics

    def _loss(self, state, s_out, t_out, t_temp, ncrops, B):
        cfg = self.cfg
        if cfg.loss.use_dense_prediction:
            loss, new_centers = losses.ddino_loss(
                s_out, t_out, state.centers, t_temp, ncrops=ncrops,
                batch_size=B, student_temp=cfg.loss.student_temp,
                center_momentum=cfg.loss.center_momentum)
        else:
            loss, new_center = losses.dino_loss(
                s_out, t_out, state.centers.center, t_temp, ncrops=ncrops,
                student_temp=cfg.loss.student_temp,
                center_momentum=cfg.loss.center_momentum)
            new_centers = state.centers._replace(center=new_center)
        return loss, new_centers
