"""DINO / DDINO losses as functions on tensors (port of esvit_tpu/losses.py).

Teacher softmax((t - center)/temp) over the 2 global views, student
log-softmax at temp 0.1, CE summed over all (teacher view, student view)
pairs with v != iq; the dense task adds a region-level CE where each
student region is matched to its cosine-most-similar teacher region, 0.5 /
0.5 weighted (ref: main_esvit.py:603-770). Centers are explicit state:
each loss returns ``(loss, new_center(s))``. All math is fp32.

``ddino_loss_streamed`` is the same DDINO loss with the DINO heads' last
layers folded in, walking the K outputs in chunks so that no (rows, K)
tensor outlives a chunk, in the forward or in what backward keeps
(esvit_tpu/losses.py:217-392).

Under the head's tensor parallelism (parallel/mesh.py, ``mesh.model`` >
1) each rank holds a K / model slice of every logit tensor and of the
centers, and every reduction over K is combined over the model group:
the teacher softmax's and the student's log-normalisers (each rank's
logsumexp over its slice, then the group's max and the sum of
exp(lse - max), ``_lse``), and the contractions over K (``_ksum``). Both
sums carry ``Mesh.model_sum``'s identity backward, so each rank's
logits get their gradient once. Everything after them is K-free and the
same on every model rank. The centers move toward their slice's mean
over the data group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from esvit_tpu_torch.parallel.mesh import Mesh

_ONE = Mesh()


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
    (main_esvit.py:650-660, :760-766): over several data ranks
    (parallel/mesh.py) the local sums are all-reduced over the data group
    in one collective and divided by the global row count; one data
    rank's batch is the global batch."""
    mesh = mesh or _ONE
    rows = [b.reshape(-1, b.shape[-1]).float() for b in batches]
    if mesh.data == 1:
        means = [r.mean(dim=0) for r in rows]
    else:
        sums = mesh.all_reduce_sum([r.sum(dim=0) for r in rows], over="data")
        means = [s / (r.shape[0] * mesh.data) for s, r in zip(sums, rows)]
    return [old * momentum + m * (1.0 - momentum)
            for old, m in zip(olds, means)]


def _lse(locals_, mesh):
    """The logsumexp over the whole K of each tensor whose logsumexp over
    this rank's K-slice is in ``locals_``: the model group's max (no
    gradient) m and sum of exp(lse - m), two collectives for the list."""
    tops = mesh.model_max(locals_)
    sums = mesh.model_sum([torch.exp(x - m) for x, m in zip(locals_, tops)])
    return [m + torch.log(s) for m, s in zip(tops, sums)]


def _softmax_lse(teacher, student, mesh):
    """(teacher softmaxes, student logsumexps) over the last axis, the
    whole K: on one model rank torch's own, else from ``_lse`` of every
    rank's slices (the teacher's without gradient)."""
    if mesh.model == 1:
        return ([torch.softmax(t, dim=-1) for t in teacher],
                [torch.logsumexp(s, dim=-1) for s in student])
    lses = _lse([torch.logsumexp(x, dim=-1) for x in (*teacher, *student)],
                mesh)
    n = len(teacher)
    q = [torch.exp(t - lse.detach()[..., None])
         for t, lse in zip(teacher, lses[:n])]
    return q, lses[n:]


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
    mean over ``mesh``'s global batch. Over a model axis the logits and
    the center are this rank's K-slice (module docstring)."""
    mesh = mesh or _ONE
    s = _chunk_views(student_cls.float() / student_temp, ncrops)
    t_logits = (teacher_cls.float() - center[None]) / teacher_temp
    (q,), (lse,) = _softmax_lse([t_logits.detach()], [s], mesh)
    q = _chunk_views(q.detach(), 2)                     # lse (ncrops, B)
    pairs = [(iq, v) for iq in range(2) for v in range(ncrops) if v != iq]
    # The contractions over K: q[a] . s[b] for every (a, b) of a pair's
    # rows under mixup, its matched rows' otherwise.
    if targets_mixup is not None:
        dots = [q[iq] @ s[v].T for iq, v in pairs]
    else:
        dots = [(q[iq] * s[v]).sum(-1) for iq, v in pairs]
    dots = mesh.model_sum(dots)
    total = 0.0
    for (iq, v), qs in zip(pairs, dots):
        if targets_mixup is not None:
            # -sum_b T[a,b] (q[a] . logp[b]), logp = s - lse.
            term = (-(targets_mixup[v] * qs).sum(-1)
                    + targets_mixup[v] @ lse[v])
        else:
            term = lse[v] - qs
        total = total + term.mean()
    (new_center,) = _update_centers([center], [teacher_cls.detach()],
                                    center_momentum, mesh)
    return total / len(pairs), new_center


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
    view_patches = _view_patches(s_npatch, ncrops)
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

    mesh = mesh or _ONE
    with torch.no_grad():
        t_cls_x = (t_cls_out.float() - centers.center[None]) / teacher_temp
        t_reg_x = ((t_region_out.float() - centers.center_grid[None])
                   / teacher_temp)                               # (B, 2Nt, K)
        t_fea_v = t_fea.float()                                  # (B, 2Nt, C)

    # Student logits are stored in the compute dtype; the upcast is exact
    # and the temperature applies after the contractions, as in JAX.
    s_cls = _chunk_views(s_cls_out, ncrops).float()
    s_reg = s_region_out.float()
    inv_t = 1.0 / student_temp
    (t_cls, t_region), (lse_cls, lse_reg) = _softmax_lse(
        [t_cls_x, t_reg_x], [s_cls * inv_t, s_reg * inv_t], mesh)
    t_cls = _chunk_views(t_cls.detach(), 2)           # lse_cls (ncrops, B)
    t_region = t_region.detach()                      # lse_reg (B, S)
    qs_cls, M = mesh.model_sum([
        torch.einsum("qbk,vbk->qvb", t_cls, s_cls) * inv_t,
        torch.einsum("bjk,btk->bjt", t_region, s_reg) * inv_t])  # M (B,2Nt,S)
    loss = _assemble(lse_cls, qs_cls, lse_reg, M, t_fea_v, s_fea, B, N_t,
                     ncrops, view_patches)
    new_centers = DinoCenters(*_update_centers(
        [centers.center, centers.center_grid],
        [t_cls_out.detach(), t_region_out.detach()], center_momentum, mesh))
    return loss, new_centers


def _view_patches(npatch, ncrops):
    """Each view's region-token count, the globals' first."""
    if len(npatch) == 1:
        return [npatch[0]] * ncrops
    return [npatch[0]] * 2 + [npatch[1]] * (ncrops - 2)


def _assemble(lse_cls, qs_cls, lse_reg, M, t_fea, s_fea, B, N_t, ncrops,
              view_patches):
    """The K-free end of the DDINO loss from the view-level log-normalisers
    lse_cls (ncrops, B) and teacher-weighted sums qs_cls (2, ncrops, B),
    the region ones lse_reg (B, S) and M (B, 2Nt, S), all at the student
    temperature: each student patch matched to its cosine-most-similar
    teacher patch per teacher view, and the CE terms over (teacher view,
    student view) pairs."""
    S = lse_reg.shape[1]
    sim = torch.einsum("bjc,btc->bjt", _l2n(t_fea.float()),
                       _l2n(s_fea.float()))
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
    return total / n_terms


def _logits(z, w):
    """(..., D) x (Kc, D) -> (..., Kc) fp32: the head's last-layer product
    in the compute dtype, as the dense path's, then upcast."""
    return torch.matmul(z, w.to(z.dtype).t()).float()


def _lse_update(m, l, chunk):
    """One chunk of an online logsumexp over the last axis: the running
    max m and the sum l of exp(x - m)."""
    m_new = torch.maximum(m, chunk.amax(dim=-1))
    l_new = (l * torch.exp(m - m_new)
             + torch.exp(chunk - m_new[..., None]).sum(dim=-1))
    return m_new, l_new


def ddino_loss_streamed(s_cls_z, s_reg_z, s_fea, t_cls_z, t_reg_z, t_fea,
                        w_s, centers: DinoCenters, teacher_temp, *,
                        ncrops: int, batch_size: int, npatch, t_npatch: int,
                        w_t=None, w_s_dense=None, w_t_dense=None,
                        n_chunks: int = 8, student_temp: float = 0.1,
                        center_momentum: float = 0.9, mesh=None):
    """``ddino_loss`` of the heads' logits without a (rows, K) tensor
    (port of esvit_tpu/losses.py:217-392).

    Inputs are EsViTModel's ``bottleneck_outputs``: s_cls_z (ncrops*B, D)
    view-major, s_reg_z (B, S, D) batch-major, t_cls_z (2B, D), t_reg_z
    (B, 2Nt, D), the L2-normalised bottlenecks; s_fea / t_fea the C-wide
    region features for the matching; w_s the student cls head's
    effective (K, D) last layer, w_t the teacher's (default w_s),
    w_s_dense / w_t_dense the dense heads' (default the cls ones). The
    teacher's inputs take no gradient.

    K is walked in ``n_chunks`` chunks, each chunk's logits recomputed
    from the bottleneck and that chunk of the weights:
      0. the teacher's online logsumexp per row and its centre sums (no
         autograd);
      1. the student's online logsumexp per row;
      2. the teacher-softmax-weighted contractions qs_cls and M.
    Passes 1 and 2 run each chunk under ``torch.utils.checkpoint``, so
    backward recomputes a chunk's logits instead of keeping them. The
    matching and CE assembly are the dense loss's. The centres move
    toward the global batch's means: over several data ranks the two sums
    go through ``mesh``'s all-reduce, as ``ddino_loss``'s do. Over a model
    axis the weights and centers are this rank's K-slice, walked in its
    chunks: the four online logsumexp states are combined over the model
    group between passes 1 and 2, and the contractions after pass 2
    (module docstring).
    Returns (loss, new DinoCenters)."""
    mesh = mesh or _ONE
    w_t = w_s if w_t is None else w_t
    w_s_dense = w_s if w_s_dense is None else w_s_dense
    w_t_dense = w_t if w_t_dense is None else w_t_dense
    B = batch_size
    K, D = w_s.shape
    if K % n_chunks:
        raise ValueError(f"K={K} is not a multiple of n_chunks={n_chunks}")
    Kc = K // n_chunks
    N_t = t_npatch
    S = s_reg_z.shape[1]
    inv_ts = 1.0 / student_temp
    inv_tt = 1.0 / teacher_temp
    dev = s_cls_z.device
    chunks = [slice(i * Kc, (i + 1) * Kc) for i in range(n_chunks)]
    s_cls3 = _chunk_views(s_cls_z, ncrops)                      # (v, B, D)
    t_cls_z, t_reg_z = t_cls_z.detach(), t_reg_z.detach()
    w_t, w_t_dense = w_t.detach(), w_t_dense.detach()
    c_cls, c_reg = centers.center, centers.center_grid

    def ml(*shape):
        return (torch.full(shape, -torch.inf, device=dev),
                torch.zeros(shape, device=dev))

    def lse(m, l):
        return m + torch.log(l)

    # Pass 0: the teacher's normalisers and centre sums.
    with torch.no_grad():
        (mtc, ltc), (mtr, ltr) = ml(2 * B), ml(B, 2 * N_t)
        sum_tc, sum_tr = [], []
        for c in chunks:
            raw_tc = _logits(t_cls_z, w_t[c])                    # (2B, Kc)
            raw_tr = _logits(t_reg_z, w_t_dense[c])              # (B,2Nt,Kc)
            mtc, ltc = _lse_update(mtc, ltc, (raw_tc - c_cls[c]) * inv_tt)
            mtr, ltr = _lse_update(mtr, ltr, (raw_tr - c_reg[c]) * inv_tt)
            sum_tc.append(raw_tc.sum(dim=0))
            sum_tr.append(raw_tr.sum(dim=(0, 1)))
            del raw_tc, raw_tr
        sum_tc, sum_tr = torch.cat(sum_tc), torch.cat(sum_tr)

    # Pass 1: the student's normalisers.
    def pass1(mc, lc, mr, lr, w, wd):
        mc, lc = _lse_update(mc, lc, _logits(s_cls3, w) * inv_ts)
        mr, lr = _lse_update(mr, lr, _logits(s_reg_z, wd) * inv_ts)
        return mc, lc, mr, lr

    (mc, lc), (mr, lr) = ml(ncrops, B), ml(B, S)
    for c in chunks:
        mc, lc, mr, lr = checkpoint(pass1, mc, lc, mr, lr, w_s[c],
                                    w_s_dense[c], use_reentrant=False)
    lse_tc, lse_tr = lse(mtc, ltc), lse(mtr, ltr)
    lse_cls, lse_reg = lse(mc, lc), lse(mr, lr)
    if mesh.model > 1:
        lse_tc, lse_tr, lse_cls, lse_reg = _lse(
            [lse_tc, lse_tr, lse_cls, lse_reg], mesh)
        lse_tc, lse_tr = lse_tc.detach(), lse_tr.detach()

    # Pass 2: the teacher-softmax-weighted contractions.
    def pass2(w, wd, wt, wtd, cc, cr):
        q_cls = torch.exp((_logits(t_cls_z, wt) - cc) * inv_tt
                          - lse_tc[:, None]).reshape(2, B, -1)
        q_reg = torch.exp((_logits(t_reg_z, wtd) - cr) * inv_tt
                          - lse_tr[..., None])
        qs = torch.einsum("qbk,vbk->qvb", q_cls, _logits(s_cls3, w))
        m = torch.einsum("bjk,btk->bjt", q_reg, _logits(s_reg_z, wd))
        return qs, m

    qs_cls = torch.zeros(2, ncrops, B, device=dev)
    M = torch.zeros(B, 2 * N_t, S, device=dev)
    for c in chunks:
        qs, m = checkpoint(pass2, w_s[c], w_s_dense[c], w_t[c], w_t_dense[c],
                           c_cls[c], c_reg[c], use_reentrant=False)
        qs_cls = qs_cls + qs
        M = M + m
    qs_cls, M = mesh.model_sum([qs_cls, M])
    qs_cls = qs_cls * inv_ts
    M = M * inv_ts

    loss = _assemble(lse_cls, qs_cls, lse_reg, M, t_fea.detach(), s_fea, B,
                     N_t, ncrops, _view_patches(npatch, ncrops))
    if mesh.data > 1:
        sum_tc, sum_tr = mesh.all_reduce_sum([sum_tc, sum_tr], over="data")
    data = mesh.data
    m = center_momentum
    new_centers = DinoCenters(
        center=c_cls * m + (sum_tc / (2 * B * data)) * (1.0 - m),
        center_grid=c_reg * m + (sum_tr / (2 * N_t * B * data)) * (1.0 - m))
    return loss, new_centers
