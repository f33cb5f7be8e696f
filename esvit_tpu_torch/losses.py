"""DINO / DDINO losses as functions on tensors (port of esvit_tpu/losses.py).

Teacher softmax((t - center)/temp) over the 2 global views, student
log-softmax at temp 0.1, CE summed over all (teacher view, student view)
pairs with v != iq; the dense task adds a region-level CE where each
student region is matched to its cosine-most-similar teacher region, 0.5 /
0.5 weighted (ref: main_esvit.py:603-770). Centers are explicit state:
each loss returns ``(loss, new_center(s))``. All math is fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DinoCenters(NamedTuple):
    """EMA centers (registered buffers in the reference)."""

    center: torch.Tensor            # (K,) view-level
    center_grid: torch.Tensor       # (K,) region-level (dense task only)

    @classmethod
    def zeros(cls, out_dim: int, device=None) -> "DinoCenters":
        return cls(center=torch.zeros(out_dim, device=device),
                   center_grid=torch.zeros(out_dim, device=device))


def _chunk_views(x: torch.Tensor, nviews: int) -> torch.Tensor:
    """(nviews*B, K) -> (nviews, B, K); rows are view-major like torch.chunk."""
    return x.reshape(nviews, -1, x.shape[-1])


def _update_centers(olds, batches, momentum: float, mesh=None):
    """Each center's EMA toward its batch's mean over the global batch
    (main_esvit.py:650-660, :760-766): under a mesh of several processes
    (parallel/mesh.py) the local sums are all-reduced in one collective
    and divided by the global row count; one process's batch is the
    global batch."""
    rows = [b.reshape(-1, b.shape[-1]).float() for b in batches]
    if mesh is None or mesh.world == 1:
        means = [r.mean(dim=0) for r in rows]
    else:
        sums = mesh.all_reduce_sum([r.sum(dim=0) for r in rows])
        means = [s / (r.shape[0] * mesh.world) for s, r in zip(sums, rows)]
    return [old * momentum + m * (1.0 - momentum)
            for old, m in zip(olds, means)]


def dino_loss(student_cls, teacher_cls, center, teacher_temp, *, ncrops: int,
              student_temp: float = 0.1, center_momentum: float = 0.9,
              mesh=None, targets_mixup=None):
    """View-level DINO loss (ref: main_esvit.py:620-648).
    student_cls: (ncrops*B, K) view-major; teacher_cls: (2*B, K).
    targets_mixup: optional (ncrops, B, B) matching targets (mixup-SSL,
    main_esvit.py:639-641, data/mixup.py): the CE of teacher row a
    against student row b weighted by T[a, b].
    Uses sum(-q * log_softmax(s)) = logsumexp(s) - q . s (sum q == 1).
    The loss is over this process's batch; the center moves toward the
    mean over ``mesh``'s global batch."""
    s = _chunk_views(student_cls.float() / student_temp, ncrops)
    t_logits = (teacher_cls.float() - center[None]) / teacher_temp
    q = _chunk_views(torch.softmax(t_logits, dim=-1).detach(), 2)
    lse = torch.logsumexp(s, dim=-1)                    # (ncrops, B)
    total, n_terms = 0.0, 0
    for iq in range(2):
        for v in range(ncrops):
            if v == iq:
                continue
            if targets_mixup is not None:
                # -sum_b T[a,b] (q[a] . logp[b]), logp = s - lse.
                qs = q[iq] @ s[v].T
                term = (-(targets_mixup[v] * qs).sum(-1)
                        + targets_mixup[v] @ lse[v])
            else:
                term = lse[v] - (q[iq] * s[v]).sum(-1)
            total = total + term.mean()
            n_terms += 1
    (new_center,) = _update_centers([center], [teacher_cls.detach()],
                                    center_momentum, mesh)
    return total / n_terms, new_center


def _l2n(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def ddino_loss(student_out, teacher_out, centers: DinoCenters, teacher_temp,
               *, ncrops: int, batch_size: int, student_temp: float = 0.1,
               center_momentum: float = 0.9, mesh=None):
    """View + region (dense) EsViT loss (ref: main_esvit.py:683-770).

    student_out / teacher_out: EsViTModel's ``(cls_logits, region_logits,
    region_fea, npatch)``; the teacher holds the 2 global views. Region
    tensors may be batch-major ``(B, S, K)`` (EsViTModel with batch_size,
    the training path) or the reference's flat view-major rows.
    Returns (scalar loss, new DinoCenters): the loss over this process's
    batch, the centers moved toward the means over ``mesh``'s global
    batch (both centers' sums in one collective)."""
    s_cls_out, s_region_out, s_fea, s_npatch = student_out
    t_cls_out, t_region_out, t_fea, t_npatch = teacher_out
    B = batch_size
    if len(s_npatch) == 1:
        view_patches = [s_npatch[0]] * ncrops
    else:
        view_patches = [s_npatch[0]] * 2 + [s_npatch[1]] * (ncrops - 2)
    N_t = t_npatch[0]

    def _to_batch_major(flat, patches):
        """(sum_v B*n_v, K) -> (B, sum_v n_v, K)."""
        groups = []
        for n in patches:
            if groups and groups[-1][1] == n:
                groups[-1][0] += 1
            else:
                groups.append([1, n])
        out, off = [], 0
        for nv, n in groups:
            rows = nv * n * B
            out.append(flat[off:off + rows].reshape(nv, B, n, -1)
                       .transpose(0, 1).reshape(B, nv * n, -1))
            off += rows
        return torch.cat(out, dim=1)

    if s_region_out.ndim == 2:
        s_region_out = _to_batch_major(s_region_out, view_patches)
        s_fea = _to_batch_major(s_fea, view_patches)
    if t_region_out.ndim == 2:
        t_region_out = _to_batch_major(t_region_out, [N_t, N_t])
        t_fea = _to_batch_major(t_fea, [N_t, N_t])
    S = s_region_out.shape[1]

    with torch.no_grad():
        t_cls = _chunk_views(torch.softmax(
            (t_cls_out.float() - centers.center[None]) / teacher_temp, dim=-1), 2)
        t_region = torch.softmax(
            (t_region_out.float() - centers.center_grid[None]) / teacher_temp,
            dim=-1)                                              # (B, 2Nt, K)
        t_fea_v = t_fea.float()                                  # (B, 2Nt, C)

    # Student logits are stored in the compute dtype; the upcast is exact
    # and the temperature applies after the contractions, as in JAX.
    s_cls = _chunk_views(s_cls_out, ncrops).float()
    s_reg = s_region_out.float()
    inv_t = 1.0 / student_temp
    lse_cls = torch.logsumexp(s_cls * inv_t, dim=-1)             # (ncrops, B)
    qs_cls = torch.einsum("qbk,vbk->qvb", t_cls, s_cls) * inv_t
    lse_reg = torch.logsumexp(s_reg * inv_t, dim=-1)             # (B, S)
    M = torch.einsum("bjk,btk->bjt", t_region, s_reg) * inv_t    # (B, 2Nt, S)
    sim = torch.einsum("bjc,btc->bjt", _l2n(t_fea_v), _l2n(s_fea.float()))
    # Per teacher view q: match each student patch t to its most similar
    # teacher patch j and read M there.
    sim4 = sim.reshape(B, 2, N_t, S)
    M4 = M.reshape(B, 2, N_t, S)
    best = sim4.argmax(dim=2, keepdim=True)                      # (B,2,1,S)
    qs_reg = torch.gather(M4, 2, best).squeeze(2)                # (B,2,S)
    ce_flat = lse_reg[:, None, :] - qs_reg

    total, n_terms, off = 0.0, 0, 0
    seg = []
    for v in range(ncrops):
        seg.append((off, off + view_patches[v]))
        off += view_patches[v]
    for iq in range(2):
        for v in range(ncrops):
            if v == iq:
                continue
            loss_v = 0.5 * (lse_cls[v] - qs_cls[iq, v])
            ce_v = ce_flat[:, iq, seg[v][0]:seg[v][1]].mean(dim=-1)
            total = total + (loss_v + 0.5 * ce_v).mean()
            n_terms += 1

    new_centers = DinoCenters(*_update_centers(
        [centers.center, centers.center_grid],
        [t_cls_out.detach(), t_region_out.detach()], center_momentum, mesh))
    return total / n_terms, new_centers
