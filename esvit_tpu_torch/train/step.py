"""The EsViT training step (port of esvit_tpu/train/step.py).

Teacher forward on the 2 global views (no autograd), student forward and
backward on all views, DINO/DDINO loss with the center EMA, per-param
clip, last-layer freeze, frozen layers, AdamW (one fused pass) or SGD /
LARS (esvit_tpu's unfused chain) and the teacher EMA with cosine
momentum. With ``LossConfig.streamed`` both nets stop before their heads'
last layers and the K-streamed loss takes the bottlenecks and the
effective last-layer matrices (esvit_tpu/train/step.py:139-198).
Schedules are evaluated from the step counter. Over several processes
(parallel/mesh.py, one card each) the gradients and the loss are
averaged in one coalesced all-reduce before the clip, and the centers
move toward the global batch's means.

Over a (data, model) grid the heads' last layers hold this rank's rows
(``parallel.mesh.is_head_shard``), the loss combines its reductions over
K across the model group (losses.py) and comes out the same on every
model rank. Each rank's backward reaches the replicated parameters
through its own rows only, so their gradients are shares of a sum over
the model group: one all-reduce over the world sums them with the loss,
and divides by the data axis (the model group's sum, the data group's
mean); the shards' gradients are averaged over the data group. So a
replicated parameter gets the same gradient, and the same update, on
every model rank. The norms of the clip, of LARS and of the logged
``grad_norm`` are the whole tensors' (train/optim.py ``global_norms``).

Compute is bf16 by explicit casts inside each module, as the JAX modules
do; parameters, gradients and optimizer moments stay fp32. There is no
GradScaler and no autocast (autocast would round in other places). The
step updates the state in place: parameters, moments and teacher are
written where they lie.

BatchNorm state (CvT, ResNet, BatchNorm heads) lives in each net's
buffers, as esvit_tpu keeps a
``student_state`` and a ``teacher_state`` (esvit_tpu/train/step.py:
36-41): each net's forwards update its own running statistics, the
teacher's EMA moves parameters only, and the teacher starts with a copy
of the student's buffers.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch

from esvit_tpu_torch import losses
from esvit_tpu_torch.config import TrainConfig, check_supported
from esvit_tpu_torch.data import mixup as mixup_lib
from esvit_tpu_torch.models.batchnorm import BatchNorm
from esvit_tpu_torch.models.esvit import EsViTModel
from esvit_tpu_torch.parallel.mesh import Mesh, is_head_shard
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
    optimizer: str = "adamw"                  # adamw | sgd | lars
    # SGD / LARS momentum traces by name (empty for AdamW, whose mu / nu
    # are then empty the other way round).
    trace: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


class EsViTTrainer:
    """Builds the model, schedules and the step function."""

    def __init__(self, cfg: TrainConfig, total_batch_size: int | None = None,
                 device: torch.device | str = "cuda", mesh: Mesh | None = None):
        """total_batch_size: the global per-view batch, which scales the
        LR; mesh: the process grid (one process: none)."""
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh or Mesh()
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
        """The model with this rank's rows of the heads' last layers, its
        BatchNorms' statistics over the mesh's data group."""
        cfg = self.cfg
        model = EsViTModel(cfg.model, cfg.head,
                           use_dense_prediction=cfg.loss.use_dense_prediction,
                           dtype=cfg.dtype, generator=generator,
                           head_shard=(self.mesh.model_index, self.mesh.model))
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mesh = self.mesh
        return model

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Random weights from ``generator`` (a CPU generator, so a seed
        gives the same weights on every device); the teacher starts as a
        copy of the student, buffers included (main_esvit.py:380-383)."""
        student = self.build_model(generator).to(self.device)
        teacher = copy.deepcopy(student).requires_grad_(False)
        named = dict(student.named_parameters())
        opt = self.cfg.optim.optimizer

        def zeros(use):
            return ({n: torch.zeros_like(p) for n, p in named.items()}
                    if use else {})
        return TrainState(
            step=0, student=student, teacher=teacher,
            mu=zeros(opt == "adamw"), nu=zeros(opt == "adamw"),
            adam_count=0,
            centers=losses.DinoCenters.zeros(
                self.cfg.loss.out_dim // self.mesh.model, self.device),
            optimizer=opt, trace=zeros(opt != "adamw"))

    def train_step(self, state: TrainState, batch,
                   generator: torch.Generator | None = None,
                   mixup_draws: list[mixup_lib.MixupDraws] | None = None,
                   mode: int = 0, teacher_mode: int = 0):
        """batch: per-resolution crop tensors ((2B, Sg, Sg, 3), (L*B, Sl,
        Sl, 3)) on the device, B this process's share of the batch.
        ``generator`` draws drop-path masks. mode / teacher_mode: a ViL
        backbone's sliding-chunk neighbour modes for the student's and the
        teacher's forwards (esvit_tpu/train/step.py:104-186; 9 =
        models/vil.py ``PER_LAYER_MODE``, each layer's own draw from
        ``generator``, the teacher's before the student's). With
        ``cfg.mixup`` enabled,
        ``mixup_draws`` (data/mixup.py ``draw_multicrop``) mix the first
        student views (main_esvit.py:515-538): the teacher sees the clean
        globals, and the targets feed the view-level DINO loss (DDINO
        ignores them, as the reference does). Returns (state, metrics),
        the loss the mean over every process's batch; the state is
        updated in place."""
        cfg = self.cfg
        B = batch[0].shape[0] // 2
        ncrops = 2 + (batch[1].shape[0] // B if len(batch) > 1 else 0)
        step = state.step
        epoch = step // cfg.steps_per_epoch
        t_temp = self.teacher_temp_fn(epoch)
        dtype = cfg.dtype

        student_in = tuple(b.to(dtype) for b in batch)
        targets_mixup = None
        mix = cfg.mixup
        if mix is not None and mix.enabled:
            if mixup_draws is None:
                raise ValueError("cfg.mixup is enabled: pass the step's "
                                 "mixup_draws (data/mixup.py draw_multicrop)")
            with _span("mixup"):
                g, loc, targets_mixup = mixup_lib.mixup_multicrop(
                    student_in[0], student_in[1] if len(student_in) > 1
                    else student_in[0][:0], mix, mixup_draws)
            student_in = (g, loc) if len(student_in) > 1 else (g,)

        streamed = cfg.loss.use_dense_prediction and cfg.loss.streamed
        # BatchNorm backbones: the teacher runs deterministic with BN on
        # batch statistics, updating its own running buffers.
        with torch.no_grad(), _span("teacher_forward"):
            t_out = state.teacher((batch[0].to(dtype),), deterministic=True,
                                  generator=generator, batch_size=B,
                                  bn_train=True, bottleneck_outputs=streamed,
                                  mode=teacher_mode)
        with _span("student_forward"):
            s_out = state.student(student_in, deterministic=False,
                                  generator=generator, batch_size=B,
                                  bottleneck_outputs=streamed, mode=mode)
        with _span("loss"):
            loss, new_centers = self._loss(state, s_out, t_out, t_temp,
                                           ncrops, B, targets_mixup)

        named = dict(state.student.named_parameters())
        names, params = list(named), list(named.values())
        f_mask = None
        if cfg.optim.frozen_layers:
            fm = optim_lib.freeze_mask_by_prefix(
                named, cfg.optim.frozen_layers, cfg.model.name)
            f_mask = [fm[n] for n in names]
        # The frozen layers' gradients are never read (their updates are
        # zero), so autograd skips them, as requires_grad=False would.
        trained = [i for i in range(len(params)) if not (f_mask and f_mask[i])]
        grads = [None] * len(params)
        if trained:
            with _span("backward"):
                got = torch.autograd.grad(loss, [params[i] for i in trained],
                                          allow_unused=True)
            for i, g in zip(trained, got):
                grads[i] = g
        # A pinned weight_g (norm_last_layer) gets no gradient: zeros, as
        # JAX's stop_gradient gives; so do the frozen layers.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        loss = loss.detach()
        sharded = [self.mesh.model > 1 and is_head_shard(n) for n in names]
        if self.mesh.distributed:
            with _span("all_reduce"):
                loss, grads = self._all_reduce(loss, grads, sharded)

        ll = optim_lib.last_layer_mask(named)
        ll_mask = [ll[n] for n in names]
        frozen = epoch < cfg.optim.freeze_last_layer_epochs
        decay = optim_lib.wd_mask(named,
                                  decay_scale_g=not cfg.head.norm_last_layer)
        teacher = dict(state.teacher.named_parameters())
        m = self.momentum_fn(step)
        lr, wd = self.lr_fn(step), self.wd_fn(step)
        common = dict(lr=lr, wd=wd, ema_m=m, clip=cfg.optim.clip_grad,
                      decay_mask=[decay[n] for n in names], ll_mask=ll_mask,
                      frozen=frozen, f_mask=f_mask, sharded=sharded,
                      mesh=self.mesh)
        with torch.no_grad(), _span("optimizer"):
            held = optim_lib.held_mask(ll_mask, frozen, f_mask)
            norms = optim_lib.global_norms(
                [g for g, h in zip(grads, held) if not h],
                [s for s, h in zip(sharded, held) if not h], self.mesh)
            grad_norm = (torch.linalg.vector_norm(torch.stack(norms))
                         if norms else torch.zeros((), device=self.device))
            if state.optimizer == "adamw":
                optim_lib.fused_adamw_ema_apply(
                    grads, params, [state.mu[n] for n in names],
                    [state.nu[n] for n in names], [teacher[n] for n in names],
                    count=state.adam_count, **common)
                state.adam_count += 1
            else:
                optim_lib.sgd_lars_ema_apply(
                    state.optimizer, grads, params,
                    [state.trace[n] for n in names],
                    [teacher[n] for n in names], **common)

        state.step += 1
        state.centers = new_centers
        metrics = {"loss": loss, "lr": lr, "wd": wd,
                   "teacher_momentum": m, "teacher_temp": t_temp,
                   "grad_norm": grad_norm}
        return state, metrics

    def _all_reduce(self, loss, grads, sharded):
        """(the loss's mean over the data ranks, the gradients of the
        global batch's mean loss): one all-reduce over the world, and over
        a grid a second one of the head shards over the data group
        (module docstring)."""
        mesh = self.mesh
        rep = [i for i, s in enumerate(sharded) if not s]
        shards = [i for i, s in enumerate(sharded) if s]
        out = list(grads)
        loss, *summed = mesh.all_reduce_sum([loss, *(grads[i] for i in rep)],
                                            over="world")
        for i, g in zip(rep, summed):
            out[i] = g / mesh.data
        if shards:
            for i, g in zip(shards, mesh.all_reduce_mean(
                    [grads[i] for i in shards], over="data")):
                out[i] = g
        return loss / mesh.world, out

    def _loss(self, state, s_out, t_out, t_temp, ncrops, B, targets_mixup):
        cfg = self.cfg
        if cfg.loss.use_dense_prediction and cfg.loss.streamed:
            s_cls_z, s_reg_z, s_fea, s_npatch, ws_cls, ws_dense = s_out
            t_cls_z, t_reg_z, t_fea, t_npatch, wt_cls, wt_dense = t_out
            loss, new_centers = losses.ddino_loss_streamed(
                s_cls_z, s_reg_z, s_fea, t_cls_z, t_reg_z, t_fea, ws_cls,
                state.centers, t_temp, ncrops=ncrops, batch_size=B,
                npatch=s_npatch, t_npatch=t_npatch[0], w_t=wt_cls,
                w_s_dense=ws_dense, w_t_dense=wt_dense,
                n_chunks=cfg.loss.stream_chunks,
                student_temp=cfg.loss.student_temp,
                center_momentum=cfg.loss.center_momentum, mesh=self.mesh)
        elif cfg.loss.use_dense_prediction:
            loss, new_centers = losses.ddino_loss(
                s_out, t_out, state.centers, t_temp, ncrops=ncrops,
                batch_size=B, student_temp=cfg.loss.student_temp,
                center_momentum=cfg.loss.center_momentum, mesh=self.mesh)
        else:
            loss, new_center = losses.dino_loss(
                s_out, t_out, state.centers.center, t_temp, ncrops=ncrops,
                student_temp=cfg.loss.student_temp,
                center_momentum=cfg.loss.center_momentum, mesh=self.mesh,
                targets_mixup=targets_mixup)
            new_centers = state.centers._replace(center=new_center)
        return loss, new_centers
