"""Vision-Longformer attentions (port of esvit_tpu/models/vil_layers.py;
ref: layers/).

- ``Long2DSCAttention``, the ViL sliding-chunk attention (ref
  longformer2d.py:11-330): local queries (the grid tokens) attend to
  their chunk neighbourhood and to the global tokens in one softmax; the
  global rows run vanilla MHA over all tokens with their own ``*_global``
  projections (or the local ones, ``share_w``). Options, as esvit_tpu's:
  the neighbour ``mode`` of each forward (0: all 8 neighbour chunks, -1:
  the chunk itself, 1-8: itself and one neighbour, the training-time
  memory saver of ref :147-155), the masks ``exact`` (0: blockwise zero
  padding, -1: cyclic, 1: the exact sliding window), ``rpe`` (a Swin-like
  ``(4W-1)^2 x H`` table over the 3 x 3 chunk neighbourhood, and the
  ``g2l`` / ``g2g`` biases between global and local tokens),
  ``add_pooled`` (keys pooled per chunk, ``mean`` or ``fc``, as extra keys
  with learned per-head scales and, under rpe, a cross-window table) and
  ``only_glo`` (local rows attend to the global tokens only). The
  canonical configuration (mode 0, exact 0, no rpe, no pooled keys, not
  only_glo, no active attention dropout) at a shape the kernel takes goes
  through ops/sliding_chunk.py's CUDA kernel pair (its plain twin for CPU
  tensors); every other one through the stacked-neighbourhood einsums of
  ops/sliding_chunk.py, as esvit_tpu's einsum path computes it.
- ``PerformerAttention``, FAVOR+ linear attention (ref performer.py): the
  orthogonal random projection is a buffer of each net,
  ``fast_attention.projection_matrix`` (the reference's FastAttention
  buffer; esvit_tpu keeps it in its ``performer`` collection). The
  reference's ``calls_since_last_redraw`` counter is not kept (esvit_tpu's
  importer drops it); :func:`redraw_performer_projection` redraws.
- ``LinformerAttention``, learned (seq_len x k) key / value projections
  (ref linformer.py), ``share_kv``.
- ``SRAttention``, a strided-conv spatial reduction of the keys and values
  with an instance norm (ref srformer.py).
- ``SELayerSeq`` / ``SELayerECA``, sequence squeeze-excitation and ECA
  channel attention (ref se_layer.py:21-70).

Parameter names are the reference checkpoint's, as esvit_tpu's importer
maps them (esvit_tpu/io/torch_import.py:231-279). Every softmax runs in
fp32 on fp32 scores.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esvit_tpu_torch.models.common import (Conv, Dense, Dropout, softmax_fp32,
                                           trunc_normal_)
from esvit_tpu_torch.ops import sliding_chunk as scops
from esvit_tpu_torch.ops.window import device_table, relative_position_index


def param_table(*shape, generator=None) -> nn.Parameter:
    """A trunc-normal (std 0.02) parameter of ``shape``: the position
    tables' and biases' init."""
    return nn.Parameter(trunc_normal_(torch.empty(*shape),
                                      generator=generator))


@functools.lru_cache(maxsize=None)
def vil_local_rpe_index(w: int) -> np.ndarray:
    """(w^2, 9w^2) index into the ((4w-1)^2, nH) table: relative positions
    of the centre chunk's queries against the 3x3 chunk neighbourhood, in
    the reference's chunk concat order (longformer2d.py:69-102)."""
    coords = np.stack(np.meshgrid(np.arange(-w, 2 * w), np.arange(-w, 2 * w),
                                  indexing="ij"))            # 2, 3w, 3w
    cu = coords.reshape(2, 3, w, 3, w).transpose(0, 1, 3, 2, 4).reshape(
        2, 3, 3, w * w)
    q = cu[:, 1, 1, :]                                       # 2, w^2
    rel = np.concatenate([q[:, :, None] - cu[:, a, b, :][:, None, :]
                          for a in range(3) for b in range(3)], axis=-1)
    rel = rel.transpose(1, 2, 0).astype(np.int64)            # w^2, 9w^2, 2
    rel[:, :, 0] += 2 * w - 1
    rel[:, :, 1] += 2 * w - 1
    rel[:, :, 0] *= 4 * w - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def rpe_index_for_mode(w: int, mode: int) -> np.ndarray:
    """The mode's columns of :func:`vil_local_rpe_index`."""
    return np.ascontiguousarray(
        scops._select_mode_columns(vil_local_rpe_index(w), w, mode))


def _heads(t: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """(B*H, ...) -> (B, H, ...)."""
    return t.reshape(B, H, *t.shape[1:])


class Long2DSCAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int, window: int, nglo: int = 1,
                 qkv_bias: bool = True, qk_scale: float | None = None,
                 fused_sc: str = "auto", dtype=torch.float32, generator=None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, *,
                 share_w: bool = False, only_glo: bool = False,
                 exact: int = 0, rpe: bool = False,
                 add_pooled: bool = False, pool_size: int = 0,
                 pool_method: str = "mean", wx: int | None = None,
                 wy: int | None = None):
        """``wx, wy``: the grid the cross-window table is sized for (only
        ``add_pooled`` with ``rpe`` has one)."""
        super().__init__()
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.num_heads = num_heads
        self.window = window
        self.nglo = nglo
        self.fused_sc = fused_sc
        self.dtype = dtype
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.only_glo, self.exact, self.rpe = only_glo, exact, rpe
        self.add_pooled, self.pool_method = add_pooled, pool_method
        self.pool_size = pool_size or window
        H, W = num_heads, window
        self.query = Dense(dim, dim, qkv_bias, dtype, generator)
        self.kv = Dense(dim, 2 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)
        self.share_w = share_w or nglo == 0
        if not self.share_w:
            self.query_global = Dense(dim, dim, qkv_bias, dtype, generator)
            self.kv_global = Dense(dim, 2 * dim, qkv_bias, dtype, generator)
            self.proj_global = Dense(dim, dim, True, dtype, generator)
        if rpe:
            self.local_relative_position_bias_table = param_table(
                (4 * W - 1) ** 2, H, generator=generator)
            if nglo >= 1:
                self.g2l_relative_position_bias = param_table(
                    2, H, nglo, generator=generator)
                self.g2g_relative_position_bias = param_table(
                    H, nglo, nglo, generator=generator)
        if add_pooled:
            if pool_method not in ("mean", "fc"):
                raise ValueError(f"unknown pool_method {pool_method!r}")
            self.pooled_k_scale = nn.Parameter(torch.ones(1, H))
            self.pooled_q_scale = nn.Parameter(torch.ones(1, H))
            if pool_method == "fc":
                self.pool_fc = Dense(W * W, 1, True, dtype, generator)
            if rpe:
                if wx is None or wy is None:
                    raise ValueError("add_pooled with rpe needs the grid "
                                     "(wx, wy) its cross-window table is "
                                     "sized for")
                px, py = self._pooled_grid(wx, wy)
                self.relative_position_bias_table_xwin = param_table(
                    (2 * px - 1) * (2 * py - 1), H, generator=generator)

    def _pooled_grid(self, nx: int, ny: int) -> tuple[int, int]:
        """The pooled keys' grid for an nx x ny input: one per chunk
        ('fc'), one per pool_size patch of the padded grid ('mean')."""
        ps = self.window if self.pool_method == "fc" else self.pool_size
        W = self.window
        return (nx + (-nx) % W) // ps, (ny + (-ny) % W) // ps

    def uses_kernel(self, dim: int, deterministic: bool = True,
                    mode: int = 0) -> bool:
        """The route (esvit_tpu/models/vil_layers.py:145-151): the kernel
        wrapper whenever fused_sc is not 'off' and ``scops.supports``
        takes this layer's configuration and shape; it runs the CUDA
        kernels for tensors on the card."""
        return self.fused_sc != "off" and scops.supports(
            self.window, dim // self.num_heads, self.nglo, mode=mode,
            exact=self.exact, rpe=self.rpe, add_pooled=self.add_pooled,
            only_glo=self.only_glo,
            attn_dropping=self.attn_drop.rate > 0.0 and not deterministic)

    def forward(self, x: torch.Tensor, nx: int, ny: int,
                deterministic: bool = True,
                generator: torch.Generator | None = None,
                mode: int = 0) -> torch.Tensor:
        B, N, C = x.shape
        H, G = self.num_heads, self.nglo
        M = C // H
        scale = torch.tensor(self.scale, dtype=self.dtype)

        q = (self.query(x[:, G:]) * scale).reshape(B, nx * ny, H, M)
        kv = self.kv(x).reshape(B, N, 2, H, M)
        if self.only_glo:
            attn = torch.einsum("bnhm,bghm->bhng", q.float(),
                                kv[:, :G, 0].float())
            probs = self.attn_drop(softmax_fp32(attn), deterministic,
                                   generator).to(self.dtype)
            x1 = torch.einsum("bhng,bghm->bnhm", probs, kv[:, :G, 1])
        else:
            grid = (B * H, nx, ny, M)
            q = q.permute(0, 2, 1, 3).reshape(grid)
            k, v = (kv[:, G:, i].permute(0, 2, 1, 3).reshape(grid)
                    for i in (0, 1))
            kg, vg = (kv[:, :G, i].permute(0, 2, 1, 3).reshape(B * H, G, M)
                      for i in (0, 1))
            if self.uses_kernel(C, deterministic, mode):
                x1 = scops.sliding_chunk_attention(
                    q.contiguous(), k.contiguous(), v.contiguous(),
                    kg.contiguous(), vg.contiguous(), nx=nx, ny=ny,
                    W=self.window)
            else:
                x1 = self._local(q, k, v, kg, vg, nx, ny, mode,
                                 lambda p: self.attn_drop(p, deterministic,
                                                          generator))
            x1 = x1.reshape(B, H, nx * ny, M).transpose(1, 2)
        x1 = self.proj_drop(self.proj(x1.reshape(B, nx * ny, C)),
                            deterministic, generator)
        if G == 0:
            return x1

        # Global rows: vanilla MHA over every token (vil_layers.py:296-312).
        query_g, kv_g, proj_g = ((self.query, self.kv, self.proj)
                                 if self.share_w else
                                 (self.query_global, self.kv_global,
                                  self.proj_global))
        qg = (query_g(x[:, :G]) * scale).reshape(B, G, H, M)
        kvg = kv_g(x).reshape(B, N, 2, H, M)
        attn0 = torch.einsum("bghm,bnhm->bhgn", qg.float(),
                             kvg[:, :, 0].float())
        if self.rpe:
            g2l, g2g = (self.g2l_relative_position_bias,
                        self.g2g_relative_position_bias)
            attn0 = attn0 + torch.cat(
                [g2g, g2l[0][:, :, None].expand(H, G, nx * ny)], dim=-1)
        probs0 = self.attn_drop(softmax_fp32(attn0), deterministic,
                                generator).to(self.dtype)
        x0 = torch.einsum("bhgn,bnhm->bghm", probs0, kvg[:, :, 1])
        x0 = self.proj_drop(proj_g(x0.reshape(B, G, C)),
                            deterministic, generator)
        return torch.cat([x0, x1], dim=1)

    def _local(self, q, k, v, kg, vg, nx, ny, mode, drop):
        """esvit_tpu's einsum path (vil_layers.py:170-287) on (BH, nx, ny,
        M) grids and (BH, G, M) globals: scores against the globals, the
        mode's chunk neighbourhood (with its rpe bias and invalid mask)
        and the pooled keys, one fp32 softmax, the products in the compute
        dtype. Returns (BH, nx, ny, M)."""
        W, G, dt = self.window, self.nglo, self.dtype
        BH, M = q.shape[0], q.shape[-1]
        H = self.num_heads
        B = BH // H
        W2 = W * W
        K = scops.neighbour_count(mode) * W2
        padx, pady = (-nx) % W, (-ny) % W
        mx, my = (nx + padx) // W, (ny + pady) // W
        qc, kc, vc = (scops._to_chunks(t, W, padx, pady) for t in (q, k, v))

        attn10 = torch.einsum("bcmnl,btc->bmnlt", qc.float(), kg.float())
        attn11 = scops.slidingchunk_qk(qc, kc, mode)
        if self.rpe:
            if G >= 1:
                bias_l2g = self.g2l_relative_position_bias[1]
                attn10 = (_heads(attn10, B, H)
                          + bias_l2g.reshape(1, H, 1, 1, 1, G)).reshape(
                    attn10.shape)
            idx = device_table(rpe_index_for_mode, (W, mode),
                               q.device).long()
            bias = self.local_relative_position_bias_table[idx.reshape(-1)]
            bias = bias.reshape(W2, K, H).permute(2, 0, 1)  # H, W2, K
            attn11 = (_heads(attn11, B, H)
                      + bias[None, :, None, None]).reshape(attn11.shape)
        attn11 = scops.apply_invalid_mask(attn11, mx, my, padx, pady, W,
                                          self.exact, mode)
        parts = [attn10, attn11]
        if self.add_pooled:
            pooled = self._pooled_keys(kc, k, padx, pady, B)
            attn12 = torch.einsum("bcmnl,bct->bmnlt", qc.float(),
                                  (pooled * self._head_scale(
                                      self.pooled_k_scale, B)).float())
            if self.rpe:
                attn12 = attn12 + self._xwin_bias(nx, ny, mx, my, B)
            parts.append(attn12)
        probs = drop(softmax_fp32(torch.cat(parts, dim=-1))).to(dt)

        x1 = scops.slidingchunk_av(probs[..., G:G + K], vc, mode)
        if G >= 1:
            x1 = x1 + torch.einsum("bmnlt,btc->bcmnl", probs[..., :G], vg)
        if self.add_pooled:
            # Reference quirk (longformer2d.py:219-222): the pooled values
            # are the pooled keys.
            x1 = x1 + torch.einsum(
                "bmnlt,bct->bcmnl", probs[..., G + K:],
                pooled * self._head_scale(self.pooled_q_scale, B))
        return scops._untile(x1.permute(0, 2, 3, 4, 1), nx, ny, W)

    def _head_scale(self, scale: torch.Tensor, B: int) -> torch.Tensor:
        """A (1, H) per-head scale as (B*H, 1, 1) in the compute dtype."""
        return scale.to(self.dtype).expand(B, -1).reshape(-1, 1, 1)

    def _pooled_keys(self, kc, k, padx, pady, B):
        """(BH, M, n_pooled) keys: 'fc' a learned Linear over each chunk's
        W^2 tokens (ref :111-117, 212-216), 'mean' the mean of each
        pool_size patch of the padded grid (ref :218-222)."""
        BH, M = kc.shape[:2]
        if self.pool_method == "fc":
            return self.pool_fc(kc).reshape(BH, M, -1)
        ps = self.pool_size
        img = F.pad(k.permute(0, 3, 1, 2), (0, pady, 0, padx))
        px, py = img.shape[2] // ps, img.shape[3] // ps
        return img.reshape(BH, M, px, ps, py, ps).mean((3, 5)).reshape(
            BH, M, -1)

    def _xwin_bias(self, nx, ny, mx, my, B):
        """The cross-window table's bias on the pooled-key scores, as
        (B*H, mx, my, 1, n_pooled): chunk (i, j)'s queries against each
        pooled key, by their relative grid position."""
        H = self.num_heads
        px, py = self._pooled_grid(nx, ny)
        table = self.relative_position_bias_table_xwin
        if table.shape[0] != (2 * px - 1) * (2 * py - 1):
            raise ValueError(f"the cross-window table is sized for another "
                             f"grid than {nx}x{ny}")
        idx = device_table(relative_position_index, (px, py),
                           table.device).long()
        n = px * py
        bias = table[idx.reshape(-1)].reshape(n, n, H).permute(2, 0, 1)
        bias = bias.reshape(1, H, px, py, 1, n).expand(B, H, mx, my, 1, n)
        return bias.reshape(B * H, mx, my, 1, n)


class FastAttention(nn.Module):
    """Holds the FAVOR+ projection ``projection_matrix`` (nb_features,
    head dim) as a buffer: each net keeps its own, and the teacher's EMA
    does not move it."""

    def __init__(self, nb_features: int, dim_heads: int, generator=None):
        super().__init__()
        self.register_buffer("projection_matrix", orthogonal_gaussian(
            nb_features, dim_heads, generator))


def orthogonal_gaussian(m: int, d: int, generator=None) -> torch.Tensor:
    """(m, d) block-orthogonal gaussian features with chi-distributed row
    norms (ref performer.py:77-103; esvit_tpu's ``_orthogonal_gaussian``
    draws the same law from jax.random)."""
    blocks = []
    n_full = m // d
    for i in range(n_full + 1):
        rows = d if i < n_full else m - n_full * d
        if rows == 0:
            continue
        qmat, _ = torch.linalg.qr(torch.randn(d, d, generator=generator))
        blocks.append(qmat[:rows])
    norms = torch.randn(m, d, generator=generator).square().sum(1).sqrt()
    return torch.cat(blocks) * norms[:, None]


def softmax_kernel(data: torch.Tensor, projection: torch.Tensor, *,
                   is_query: bool, eps: float = 1e-4) -> torch.Tensor:
    """FAVOR+ positive softmax features (ref performer.py:27-55). The
    keys' stabiliser is one max over the whole tensor, batch included, as
    esvit_tpu's ``jnp.max(dash)``: samples are coupled through it."""
    normalizer = data.shape[-1] ** -0.25
    ratio = projection.shape[0] ** -0.5
    dash = torch.einsum("bhnd,jd->bhnj", normalizer * data, projection)
    diag = data.square().sum(-1, keepdim=True) / 2.0 * normalizer ** 2
    stab = dash.amax(-1, keepdim=True) if is_query else dash.amax()
    return ratio * (torch.exp(dash - diag - stab) + eps)


def redraw_performer_projection(model: nn.Module,
                                generator: torch.Generator | None = None
                                ) -> nn.Module:
    """Redraw every Performer projection of ``model`` in place (ref
    performer.py:142-146; esvit_tpu's ``redraw_performer_projection``)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FastAttention):
                p = m.projection_matrix
                p.copy_(orthogonal_gaussian(*p.shape, generator))
    return model


class PerformerAttention(nn.Module):
    """FAVOR+ linear attention in fp32 (ref performer.py:27-204). Like
    esvit_tpu's, it applies no attention dropout."""

    def __init__(self, dim: int, num_heads: int, nb_features: int = 256,
                 qkv_bias: bool = True, dtype=torch.float32, generator=None,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)
        self.fast_attention = FastAttention(nb_features, dim // num_heads,
                                            generator)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, nx=None, ny=None, deterministic=True,
                generator=None):
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.float()
        proj = self.fast_attention.projection_matrix.float()
        qp = softmax_kernel(q, proj, is_query=True)
        kp = softmax_kernel(k, proj, is_query=False)
        d_inv = 1.0 / torch.einsum("bhnf,bhf->bhn", qp, kp.sum(2) + 1e-8)
        context = torch.einsum("bhnf,bhnm->bhfm", kp, v)
        out = torch.einsum("bhnf,bhfm->bhnm", qp, context) * d_inv[..., None]
        out = out.to(self.dtype).transpose(1, 2).reshape(B, N, C)
        return self.proj_drop(self.proj(out), deterministic, generator)


class LinformerAttention(nn.Module):
    """Low-rank key / value projection attention (ref linformer.py:15-71).
    ``proj_k`` / ``proj_v`` are stored as esvit_tpu's (uniform on [0,
    2/sqrt(k)) at init) and shifted by -1/sqrt(k) where they are used. The
    sequence length is fixed at construction: another raises."""

    def __init__(self, dim: int, seq_len: int, num_feats: int = 256,
                 num_heads: int = 8, qkv_bias: bool = True,
                 share_kv: bool = False, dtype=torch.float32, generator=None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.seq_len, self.num_feats = seq_len, num_feats
        self.num_heads, self.dtype, self.share_kv = num_heads, dtype, share_kv
        self.scale = (dim // num_heads) ** -0.5
        bound = 2.0 / math.sqrt(num_feats)
        self.proj_k = nn.Parameter(
            torch.rand(seq_len, num_feats, generator=generator) * bound)
        if not share_kv:
            self.proj_v = nn.Parameter(
                torch.rand(seq_len, num_feats, generator=generator) * bound)
        self.query = Dense(dim, dim, qkv_bias, dtype, generator)
        self.kv = Dense(dim, 2 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, nx=None, ny=None, deterministic=True,
                generator=None):
        B, N, C = x.shape
        H, kdim, dt = self.num_heads, self.num_feats, self.dtype
        if N != self.seq_len:
            raise ValueError(f"linformer needs seq_len={self.seq_len}, "
                             f"got {N}")
        shift = 1.0 / math.sqrt(kdim)
        proj_k = (self.proj_k - shift).to(dt)
        proj_v = proj_k if self.share_kv else (self.proj_v - shift).to(dt)
        q = (self.query(x) * torch.tensor(self.scale, dtype=dt)).reshape(
            B, N, H, C // H)
        kv = self.kv(x).reshape(B, N, 2, C)
        keys = torch.einsum("bnd,nk->bkd", kv[:, :, 0], proj_k).reshape(
            B, kdim, H, C // H)
        values = torch.einsum("bnd,nk->bkd", kv[:, :, 1], proj_v).reshape(
            B, kdim, H, C // H)
        attn = torch.einsum("bnhm,bkhm->bhnk", q.float(), keys.float())
        probs = self.attn_drop(softmax_fp32(attn), deterministic,
                               generator).to(dt)
        out = torch.einsum("bhnk,bkhm->bnhm", probs, values).reshape(B, N, C)
        return self.proj_drop(self.proj(out), deterministic, generator)


class SRAttention(nn.Module):
    """Spatial-reduction attention (ref srformer.py:5-58): the keys and
    values come from the global tokens and the grid reduced by a strided
    conv (no bias) and an instance norm (biased variance, eps 1e-5, no
    affine)."""

    def __init__(self, dim: int, rratio: int = 2, num_heads: int = 8,
                 qkv_bias: bool = True, dtype=torch.float32, generator=None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.scale = (dim // num_heads) ** -0.5
        self.query = Dense(dim, dim, qkv_bias, dtype, generator)
        self.proj_sr = Conv(dim, dim, rratio, rratio, bias=False, dtype=dtype,
                            generator=generator)
        self.kv = Dense(dim, 2 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, nx, ny, deterministic=True, generator=None):
        B, N, C = x.shape
        H, dt = self.num_heads, self.dtype
        G = N - nx * ny
        q = (self.query(x) * torch.tensor(self.scale, dtype=dt)).reshape(
            B, N, H, C // H)
        x_loc = self.proj_sr(x[:, G:].reshape(B, nx, ny, C))
        mean = x_loc.mean((1, 2), keepdim=True)
        var = x_loc.var((1, 2), keepdim=True, correction=0)
        x_loc = ((x_loc - mean) / torch.sqrt(var + 1e-5)).to(dt)
        x_red = torch.cat([x[:, :G].to(dt), x_loc.reshape(B, -1, C)], dim=1)
        kv = self.kv(x_red).reshape(B, x_red.shape[1], 2, H, C // H)
        attn = torch.einsum("bnhm,bkhm->bhnk", q.float(), kv[:, :, 0].float())
        probs = self.attn_drop(softmax_fp32(attn), deterministic,
                               generator).to(dt)
        out = torch.einsum("bhnk,bkhm->bnhm", probs, kv[:, :, 1])
        return self.proj_drop(self.proj(out.reshape(B, N, C)), deterministic,
                              generator)


class SELayerSeq(nn.Module):
    """Sequence squeeze-excitation on (B, N, C) (ref se_layer.py:21-38)."""

    def __init__(self, dim: int, mlp_ratio: float = 0.0625,
                 dtype=torch.float32, generator=None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden, False, dtype, generator)
        self.fc2 = Dense(hidden, dim, False, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc2(F.relu(self.fc1(x.mean(1))))
        return x * torch.sigmoid(y)[:, None, :]


class SELayerECA(nn.Module):
    """ECA channel attention on (B, N, C) (ref se_layer.py:41-70): a
    1-D conv of k_size taps, no bias, across the channels' means."""

    def __init__(self, dim: int, k_size: int = 3, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv1d(1, 1, k_size, padding=(k_size - 1) // 2,
                              bias=False)
        trunc_normal_(self.conv.weight, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(1).to(self.dtype)[:, None, :]               # (B, 1, C)
        y = F.conv1d(y, self.conv.weight.to(self.dtype),
                     padding=self.conv.padding)
        return x * torch.sigmoid(y[:, 0])[:, None, :]
