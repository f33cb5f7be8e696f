"""Mixup / CutMix for SSL views (port of esvit_tpu/data/mixup.py; ref:
main_esvit.py:223-230, 515-538).

The reference applies timm's ``Mixup`` (batch mode) to the first
``num_mixup_views`` student views with ``targets = arange(B)``, giving a
(B, B) soft-matching matrix per view, while the other views carry
identity targets; DINOLoss then takes the matrix form of the CE
(main_esvit.py:639-641, losses.dino_loss ``targets_mixup``).

One Beta-drawn lambda per view (timm's 'batch' mode), pairing each sample
with the batch reversed (x + x[::-1]), CutMix in place of mixup with
probability ``switch_prob``, the whole gated by ``prob``; the targets get
the same convex combination, then label smoothing.

Drawing is separate from mixing: ``draw_view`` draws one view's
parameters (apply, switch, the two lambdas, the box centre) on the host
from a CPU ``torch.Generator``; ``mixup_view`` is a plain function of
(images, draws) and runs where the images are (the card). So the mixing
can be held to esvit_tpu's on the values ``jax.random`` drew, which torch
cannot reproduce from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class MixupConfig:
    enabled: bool = False
    num_mixup_views: int = 2
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.0


class MixupDraws(NamedTuple):
    """One view's draws: whether to mix at all, CutMix (else mixup), the
    mixup and CutMix lambdas, and the CutMix box centre (row, column)."""

    apply: bool
    use_cutmix: bool
    lam_mix: float
    lam_cut: float
    cy: int
    cx: int


def _beta(alpha: float, generator: torch.Generator) -> float:
    """Beta(alpha, alpha) as X / (X + Y), X and Y Gamma(alpha); 1.0 (no
    mixing) where alpha is not positive."""
    if alpha <= 0:
        return 1.0
    xy = torch._standard_gamma(torch.full((2,), float(alpha),
                                          dtype=torch.float64),
                               generator=generator)
    return float(xy[0] / (xy[0] + xy[1]))


def draw_view(generator: torch.Generator, cfg: MixupConfig, h: int,
              w: int) -> MixupDraws:
    """One view's draws for an (h, w) image, from a CPU generator, in
    esvit_tpu's order (apply, switch, lambda mixup, lambda CutMix, box
    centre); every draw is made whatever the others gave."""
    apply = float(torch.rand((), generator=generator)) < cfg.prob
    switch = float(torch.rand((), generator=generator)) < cfg.switch_prob
    lam_mix = _beta(cfg.mixup_alpha, generator)
    lam_cut = _beta(cfg.cutmix_alpha, generator)
    cy = int(torch.randint(0, h, (), generator=generator))
    cx = int(torch.randint(0, w, (), generator=generator))
    return MixupDraws(apply, switch and cfg.cutmix_alpha > 0, lam_mix,
                      lam_cut, cy, cx)


def draw_multicrop(generator: torch.Generator, cfg: MixupConfig,
                   sizes: list[tuple[int, int]]) -> list[MixupDraws]:
    """The draws of the first ``num_mixup_views`` views; sizes[v] is view
    v's (h, w)."""
    return [draw_view(generator, cfg, *sizes[v])
            for v in range(min(cfg.num_mixup_views, len(sizes)))]


def cutmix_box(h: int, w: int, lam: float, cy: int, cx: int
               ) -> tuple[int, int, int, int]:
    """(y1, y2, x1, x2) of the box for mix ratio 1 - lam around (cy, cx):
    timm's sqrt-area box, in float32 as esvit_tpu computes it."""
    cut_rat = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(h) * cut_rat)
    cut_w = int(np.float32(w) * cut_rat)
    return (min(max(cy - cut_h // 2, 0), h), min(max(cy + cut_h // 2, 0), h),
            min(max(cx - cut_w // 2, 0), w), min(max(cx + cut_w // 2, 0), w))


def mixup_view(x: torch.Tensor, cfg: MixupConfig, d: MixupDraws):
    """One view's batch (B, H, W, C) -> (mixed x, targets (B, B) fp32)."""
    B, H, W, _ = x.shape
    eye = torch.eye(B, dtype=torch.float32, device=x.device)
    if not d.apply:
        mixed, targets = x, eye
    else:
        flipped = x.flip(0)
        if d.use_cutmix:
            y1, y2, x1, x2 = cutmix_box(H, W, d.lam_cut, d.cy, d.cx)
            mixed = x.clone()
            mixed[:, y1:y2, x1:x2] = flipped[:, y1:y2, x1:x2]
            lam = float(np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1))
                        / np.float32(H * W))
        else:
            lam_x = torch.tensor(d.lam_mix, dtype=x.dtype, device=x.device)
            mixed = x * lam_x + flipped * (1.0 - lam_x)
            lam = d.lam_mix
        lam_t = torch.tensor(lam, dtype=torch.float32, device=x.device)
        targets = lam_t * eye + (1.0 - lam_t) * eye.flip(0)
    if cfg.label_smoothing > 0:
        s = cfg.label_smoothing
        targets = targets * (1.0 - s) + s / B
    return mixed, targets


def mixup_multicrop(global_crops: torch.Tensor, local_crops: torch.Tensor,
                    cfg: MixupConfig, draws: list[MixupDraws]):
    """Mix the first ``len(draws)`` views (ref :515-538).

    global_crops (2B, S, S, C) view-major; local_crops (L*B, s, s, C).
    Returns (global, local, targets (ncrops, B, B))."""
    B = global_crops.shape[0] // 2
    L = local_crops.shape[0] // B
    eye = torch.eye(B, dtype=torch.float32, device=global_crops.device)
    views = list(global_crops.reshape(2, B, *global_crops.shape[1:]))
    views += list(local_crops.reshape(L, B, *local_crops.shape[1:]))
    targets = []
    for v in range(len(views)):
        if v < len(draws):
            views[v], t = mixup_view(views[v], cfg, draws[v])
        else:
            t = eye
        targets.append(t)
    g = torch.cat(views[:2], dim=0)
    loc = torch.cat(views[2:], dim=0) if L else local_crops
    return g, loc, torch.stack(targets)
