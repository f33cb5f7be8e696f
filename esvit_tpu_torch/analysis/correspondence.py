"""Region correspondence (port of esvit_tpu/analysis/correspondence.py;
ref: analyze_models.py:244-539).

Each region of view A matches its cosine-argmax region of view B, the
matching the region-level loss learns.

- ``match_regions``: the argmax matching (DDINOLoss's region_sim_matrix,
  main_esvit.py:735-738), numpy.
- ``correspondence_accuracy``: the flip protocol (analyze_models.py:
  244-354): view B is the horizontal flip of A, so grid cell (i, j)
  should match (i, W-1-j); top-1 accuracy and the mean grid distance of
  the matches. The backbone runs on its device; images are channels-last
  (B, H, W, 3), so the flip reverses axis 2.
- ``plot_correspondence``: the top-k matched pairs as lines between the
  two images (matplotlib, imported when called).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _l2n(x, axis=-1):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


def match_regions(fea_a: np.ndarray, fea_b: np.ndarray):
    """fea_* (N, C) -> (match_idx (N,), sim (N,)): the argmax cosine match
    of each A-region in B."""
    sim = _l2n(fea_a) @ _l2n(fea_b).T
    idx = sim.argmax(1)
    return idx, sim[np.arange(len(idx)), idx]


def flip_features(backbone, images) -> tuple[np.ndarray, np.ndarray]:
    """fp32 region features (B, N, C) of a batch and of its horizontal
    flip, from one forward each on the backbone's device."""
    dev = next(backbone.parameters()).device
    x = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
    with torch.inference_mode():
        fea = backbone.forward_features(x)[1]
        fea_f = backbone.forward_features(x.flip(2))[1]
    return (fea.float().cpu().numpy(), fea_f.float().cpu().numpy())


def correspondence_accuracy(backbone, images: np.ndarray,
                            patch_grid: Optional[tuple[int, int]] = None):
    """Flip correspondence over a batch (B, H, W, 3): (accuracy %, mean
    distance of the matches from the truth, in grid cells)."""
    fea, fea_f = flip_features(backbone, images)
    B, N, _ = fea.shape
    if patch_grid is None:
        s = int(np.sqrt(N))
        patch_grid = (s, s)
    H, W = patch_grid
    gt = np.arange(N).reshape(H, W)[:, ::-1].reshape(-1)   # (i,j)->(i,W-1-j)
    correct = 0
    dist_sum = 0.0
    for b in range(B):
        idx, _ = match_regions(fea[b], fea_f[b])
        correct += int((idx == gt).sum())
        yi, xi = np.divmod(idx, W)
        yg, xg = np.divmod(gt, W)
        dist_sum += float(np.sqrt((yi - yg) ** 2 + (xi - xg) ** 2).mean())
    return 100.0 * correct / (B * N), dist_sum / B


def plot_correspondence(img_a: np.ndarray, img_b: np.ndarray,
                        fea_a: np.ndarray, fea_b: np.ndarray,
                        out_path: str, *, top_k: int = 10,
                        grid: Optional[tuple[int, int]] = None) -> None:
    """The top-k most similar matched region pairs as lines between the
    two images (ref: analyze_models.py:358-539)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    N = fea_a.shape[0]
    if grid is None:
        s = int(np.sqrt(N))
        grid = (s, s)
    H, W = grid
    idx, sim = match_regions(fea_a, fea_b)
    best = np.argsort(-sim)[:top_k]
    cell = img_a.shape[0] / H
    canvas = np.concatenate([img_a, img_b], axis=1)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.imshow(canvas.astype(np.uint8) if canvas.dtype != np.uint8 else canvas)
    for r in best:
        ya, xa = divmod(int(r), W)
        yb, xb = divmod(int(idx[r]), W)
        ax.plot([(xa + 0.5) * cell, img_a.shape[1] + (xb + 0.5) * cell],
                [(ya + 0.5) * cell, (yb + 0.5) * cell],
                marker="o", markersize=3, linewidth=1)
    ax.axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
