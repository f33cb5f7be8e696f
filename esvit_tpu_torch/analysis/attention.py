"""Attention-map analysis (port of esvit_tpu/analysis/attention.py; ref:
analyze_models.py:139-239, 783-837).

- ``attention_maps``: per-head maps of the backbone's last (or every)
  block, through its ``forward_selfattention`` (Swin and ViT have one),
  on the device the backbone is on.
- ``attention_entropy``: mean per-head entropy of the attention rows
  (analyze_models.py:816-829).
- ``head_entropy_order`` + ``threshold_mask``: entropy-sorted heads and
  the top-p attention-mass masks of the reference's visualiser.
- ``save_attention_grid``: a PNG grid of the per-head maps (matplotlib,
  imported when called).

The last three are numpy, as in esvit_tpu.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def attention_maps(backbone, images: torch.Tensor, n: int = 1):
    """Attention probabilities of the last block (n=1), or a list of every
    block's: each (B*, nH, N, N). ``images`` (B, H, W, 3) on the
    backbone's device."""
    with torch.inference_mode():
        return backbone.forward_selfattention(images, n)


def attention_entropy(attn: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Mean entropy per head: attn (..., nH, N, N) -> (..., nH), averaged
    over the query positions."""
    a = np.asarray(attn, np.float64)
    ent = -(a * np.log(a + eps)).sum(-1)       # (..., nH, N)
    return ent.mean(-1)


def head_entropy_order(attn: np.ndarray) -> np.ndarray:
    """Head indices sorted by ascending entropy (sharpest first)."""
    return np.argsort(attention_entropy(attn).mean(axis=tuple(
        range(attn.ndim - 3))))


def threshold_mask(attn_row: np.ndarray, mass: float = 0.6) -> np.ndarray:
    """Boolean mask of the smallest token set holding >= ``mass`` of the
    attention row (ref: analyze_models.py th_attn)."""
    order = np.argsort(-attn_row)
    csum = np.cumsum(attn_row[order])
    keep = csum <= mass
    if not keep.all():
        keep[np.argmax(~keep)] = True          # the crossing token
    mask = np.zeros_like(attn_row, bool)
    mask[order[keep]] = True
    return mask


def save_attention_grid(attn: np.ndarray, out_path: str, *,
                        grid_hw: Optional[tuple[int, int]] = None,
                        image: Optional[np.ndarray] = None) -> None:
    """Per-head mean-query attention maps as a PNG grid, sharpest head
    first."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(attn)
    if a.ndim == 4:                            # (B, nH, N, N): first sample
        a = a[0]
    nH, N, _ = a.shape
    if grid_hw is None:
        s = int(np.sqrt(N))
        grid_hw = (s, s)
    cols = nH + (1 if image is not None else 0)
    fig, axes = plt.subplots(1, cols, figsize=(2.2 * cols, 2.4))
    axes = np.atleast_1d(axes)
    k = 0
    if image is not None:
        axes[0].imshow(image)
        axes[0].set_title("input")
        axes[0].axis("off")
        k = 1
    for j, h in enumerate(head_entropy_order(a[None])):
        axes[k + j].imshow(a[h].mean(0).reshape(grid_hw), cmap="viridis")
        axes[k + j].set_title(f"head {h}")
        axes[k + j].axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
