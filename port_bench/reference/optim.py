"""EsViT's schedules and update in plain float32 (utils.py:106-173,
main_esvit.py:540-590).

Schedules: the cosine scheduler with a linear warm-up from 0, per step
(learning rate, weight decay, teacher momentum), and the teacher
temperature's linear ramp per epoch. The update: each parameter's
gradient clipped to norm ``clip`` on its own; the DINO heads' last layers
get no gradient while ``epoch < freeze_last_layer``; AdamW as
``torch.optim.AdamW`` computes it, decay on every parameter but biases
and 1-D ones (``get_params_groups``); then the teacher's EMA toward the
student.
"""

from __future__ import annotations

import math

import torch


def cosine(step, base, final, total, warmup=0, start=0.0):
    if step < warmup:
        return start + (base - start) * step / max(warmup - 1, 1)
    i = step - warmup
    return final + 0.5 * (base - final) * (1 + math.cos(math.pi * i
                                                      / (total - warmup)))


def teacher_temp(epoch, warmup_temp, temp, warmup_epochs):
    if epoch >= warmup_epochs:
        return temp
    return warmup_temp + (temp - warmup_temp) * epoch / max(warmup_epochs - 1,
                                                            1)


def schedules(config: dict, total_batch: int, step: int) -> dict:
    o, lo = config["optim"], config["loss"]
    spe = config["steps_per_epoch"]
    total = o["epochs"] * spe
    epoch = step // spe
    return {
        "epoch": epoch,
        "lr": cosine(step, o["lr"] * total_batch / 256.0, o["min_lr"], total,
                     o["warmup_epochs"] * spe),
        "wd": cosine(step, o["weight_decay"], o["weight_decay_end"], total),
        "momentum": cosine(step, o["momentum_teacher"], 1.0, total),
        "teacher_temp": teacher_temp(epoch, lo["warmup_teacher_temp"],
                                     lo["teacher_temp"],
                                     lo["warmup_teacher_temp_epochs"]),
    }


def decayed(name: str, p: torch.Tensor) -> bool:
    return not (name.endswith(".bias") or p.ndim == 1)


def is_last_layer(name: str) -> bool:
    return "last_layer" in name.split(".")


class AdamW:
    """Per-name first and second moments; ``step`` updates in place."""

    def __init__(self, params: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float, wd: float,
             held=()):
        """``held``: names that take no step (a gradient of None in
        torch.optim: no decay, no moment update)."""
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for n, p in params.items():
            if n in held:
                continue
            g = grads[n]
            if decayed(n, p):
                p.mul_(1 - lr * wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[n].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)


def clip_(grads: dict, clip: float) -> None:
    for g in grads.values():
        coef = clip / (torch.linalg.vector_norm(g) + 1e-6)
        g.mul_(torch.clamp(coef, max=1.0))


@torch.no_grad()
def ema_(teacher: dict, student: dict, m: float) -> None:
    for n, t in teacher.items():
        t.mul_(m).add_(student[n], alpha=1 - m)
