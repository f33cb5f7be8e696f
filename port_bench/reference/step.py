"""The reference EsViT pre-training step, in plain float32.

``ReferenceTrainer.step`` takes the crops of the whole global batch and
runs, for blocks of ``chunk`` images at a time so that it fits beside
nothing else on the card: the teacher's forward on the global views, the
student's on all views, the loss of those images and its gradient,
weighted by the block's share of the batch and summed. The loss is a mean
over images of per-image terms (the centers and temperatures are fixed
within a step), so the sum is the whole batch's gradient. Then the
centers' EMA over the batch, the clip, AdamW and the teacher's EMA
(optim.py). The step records what the benchmark compares: its loss and
each parameter's clipped gradient norm, the gradient that AdamW takes.
"""

from __future__ import annotations

import torch

from port_bench.reference import loss as loss_lib
from port_bench.reference import optim
from port_bench.reference.model import EsViT
from port_bench.reference.precision import FP32


def build(config: dict, dense: bool, device="meta") -> EsViT:
    """The model with uninitialised parameters on ``device``."""
    with torch.device("meta"):
        model = EsViT(config, dense)
    return model if str(device) == "meta" else model.to_empty(device=device)


def param_spec(config: dict, dense: bool) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, in the model's order."""
    return [(n, tuple(p.shape))
            for n, p in build(config, dense).named_parameters()]


def split_images(crops, b: int, lo: int, hi: int):
    """Images lo..hi of every view: crops are view-major groups."""
    out = []
    for x in crops:
        v = x.shape[0] // b
        out.append(x.reshape(v, b, *x.shape[1:])[:, lo:hi]
                   .reshape(v * (hi - lo), *x.shape[1:]))
    return tuple(out)


def forward_loss(student, teacher, crops, b, centers, temps, draws=None):
    """The loss of ``b`` images' crops and the teacher's raw logits; the
    student takes stochastic depth from ``draws`` (per crop group, see
    swin.py), the teacher none."""
    with torch.no_grad():
        t_cls, t_reg, t_fea = teacher(crops[:1], b)
    s_cls, s_reg, s_fea = student(crops, b, draws)
    value = loss_lib.loss(s_cls, t_cls, centers[0], temps[0], temps[1],
                          s_reg, s_fea, t_reg, t_fea, centers[1])
    return value, t_cls, t_reg


class ReferenceTrainer:
    def __init__(self, config: dict, dense: bool, weights: dict,
                 total_batch: int, start_step: int, device, prec=FP32):
        self.config, self.dense = config, dense
        self.total_batch, self.step_no = total_batch, start_step
        self.student = build(config, dense, device).set_precision(prec)
        self.teacher = build(config, dense, device).set_precision(prec)
        self.teacher.requires_grad_(False)
        with torch.no_grad():
            for model in (self.student, self.teacher):
                for n, p in model.named_parameters():
                    p.copy_(weights[n])
        self.params = dict(self.student.named_parameters())
        self.opt = optim.AdamW(self.params)
        K = config["head"]["out_dim"]
        self.centers = [torch.zeros(K, device=device),
                        torch.zeros(K, device=device)]

    def step(self, crops, b: int, chunk: int, total_b: int | None = None,
             all_reduce=None, draws=None) -> dict:
        """One step: ``crops`` hold ``b`` images of a global batch of
        ``total_b`` (default b); over several processes ``all_reduce``
        sums a list of tensors in place over them, each process passing
        its own images. ``draws``: the step's stochastic-depth uniforms,
        per crop group (blocks, 2, crops), or None."""
        total_b = total_b or b
        cfg = self.config
        s = optim.schedules(cfg, self.total_batch, self.step_no)
        temps = (s["teacher_temp"], cfg["loss"]["student_temp"])
        names = list(self.params)
        grads = {n: torch.zeros_like(p) for n, p in self.params.items()}
        total = 0.0
        sums = [torch.zeros_like(c) for c in self.centers]
        rows = [0, 0]
        for lo in range(0, b, chunk):
            hi = min(lo + chunk, b)
            part = split_images(crops, b, lo, hi)
            part_draws = None
            if draws is not None:
                part_draws = [d.transpose(0, 2) for d in split_images(
                    [d.transpose(0, 2) for d in draws], b, lo, hi)]
            value, t_cls, t_reg = forward_loss(
                self.student, self.teacher, part, hi - lo, self.centers,
                temps, part_draws)
            w = (hi - lo) / total_b
            got = torch.autograd.grad(value * w, [self.params[n]
                                                  for n in names],
                                      allow_unused=True)
            with torch.no_grad():
                for n, g in zip(names, got):
                    if g is not None:
                        grads[n] += g
                total = total + value.detach() * w
                for t in t_cls:
                    sums[0] += t.sum(dim=0)
                    rows[0] += t.shape[0]
                for t in t_reg or ():
                    sums[1] += t.reshape(-1, t.shape[-1]).sum(dim=0)
                    rows[1] += t.shape[0] * t.shape[1]
            del value, got, t_cls, t_reg
        total = torch.as_tensor(total, device=sums[0].device).reshape(1)
        count = torch.tensor(rows, dtype=torch.float64,
                             device=sums[0].device)
        if all_reduce is not None:
            all_reduce([total, count, *sums, *grads.values()])
        rows = count.tolist()
        m = cfg["loss"]["center_momentum"]
        self.centers = [loss_lib.update_centers(c, x, r, m) if r else c
                        for c, x, r in zip(self.centers, sums, rows)]
        held = set()
        if s["epoch"] < cfg["optim"]["freeze_last_layer_epochs"]:
            held = {n for n in names if optim.is_last_layer(n)}
            for n in held:
                grads[n].zero_()
        if cfg["optim"]["clip_grad"] > 0:
            optim.clip_(grads, cfg["optim"]["clip_grad"])
        grad_norms = torch.stack([torch.linalg.vector_norm(grads[n])
                                  for n in names]).cpu()
        self.opt.step(self.params, grads, s["lr"], s["wd"], held)
        optim.ema_(dict(self.teacher.named_parameters()), self.params,
                   s["momentum"])
        self.step_no += 1
        return {"loss": float(total), "grad_norms": dict(zip(names,
                                                      grad_norms.tolist()))}
