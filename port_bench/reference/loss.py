"""EsViT's losses in plain float32 (main_esvit.py:603-770).

View level (DINOLoss): the teacher's softmax of (logits - center) / T_t
over the two global views, the student's log-softmax at T_s over every
view, cross-entropy summed over the pairs (teacher view iq, student view
v != iq) and averaged over the pairs. Region level (DDINOLoss): each
student region token is matched to the teacher region token of view iq
with the largest cosine similarity of their backbone features, and the
matched pair's cross-entropy is averaged over the student's tokens; the
view and region terms weigh 0.5 each. Both centers are EMAs of the
teacher's raw logits over the global batch (``update_centers``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def loss(s_cls, t_cls, center, t_temp, s_temp, s_reg=None, s_fea=None,
         t_reg=None, t_fea=None, center_grid=None):
    """The mean over the batch; the inputs are per-view lists (module
    docstring), the region ones None without the region task."""
    dense = s_reg is not None
    q_cls = [torch.softmax((t - center) / t_temp, dim=-1) for t in t_cls]
    if dense:
        q_reg = [torch.softmax((t - center_grid) / t_temp, dim=-1)
                 for t in t_reg]
        t_unit = [F.normalize(f, dim=-1) for f in t_fea]
    total, terms = 0.0, 0
    for iq in range(len(t_cls)):
        for v in range(len(s_cls)):
            if v == iq:
                continue
            term = torch.sum(-q_cls[iq] * F.log_softmax(s_cls[v] / s_temp,
                                                         dim=-1), dim=-1)
            if dense:
                sim = torch.matmul(F.normalize(s_fea[v], dim=-1),
                                   t_unit[iq].transpose(1, 2))   # (b, n, N)
                best = sim.argmax(dim=2)
                q = torch.gather(q_reg[iq], 1, best[..., None].expand(
                    -1, -1, q_reg[iq].shape[-1]))
                grid = torch.sum(-q * F.log_softmax(s_reg[v] / s_temp,
                                                    dim=-1), dim=-1)
                term = 0.5 * term + 0.5 * grid.mean(dim=-1)
            total = total + term.mean()
            terms += 1
    return total / terms


def update_centers(center, sums, rows, momentum):
    """center * m + (sum over the global batch's rows / rows) * (1 - m)."""
    return center * momentum + (sums / rows) * (1 - momentum)
