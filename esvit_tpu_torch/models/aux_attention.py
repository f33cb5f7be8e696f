"""Auxiliary attentions (port of esvit_tpu/models/aux_attention.py; ref:
layers/attention.py).

Standalone modules of the reference's experiments, never on the EsViT
main path; plain PyTorch, as they are plain XLA in esvit_tpu. Tokens are
(B, N, C), a CLS token first where there is one; the grid is square.

- ``AxialAttention`` (ref :24-152): attention along each row (or, with
  ``horizontal=False``, each column) with the CLS token repeated into
  every row; the CLS query attends to [cls, every grid token], its
  cls -> cls score taken from row 0.
- ``CrissCrossAttention`` (ref :193-310): each pixel attends to its
  column (CLS in front) and its row (self masked out, so it counts once)
  under one fp32 softmax; the CLS token attends to everything.
- ``ConvQKVAttention`` (ref ``Attention`` :355-662): q/k/v from one of
  the conv stems ('conv', 'conv_pw', the ``dw_*_pw`` and ``pw_glu_*``
  families) or the linear path; reduced q/k width (``qkv_ratio != 3``,
  dw stems only), the residual score carry ``prev`` (``res_score``),
  ``use_avg_att`` / ``use_avg_att_all``, ``add_v_res``, ``return_attn``.
- ``DownAttention`` (ref :664-1030): the dw stem at a strided
  resolution, 2x bilinear upsample, a full-resolution depthwise value
  branch ``v_full`` added before or after ``proj``.
- ``CrossScaleAttention`` (ref :1032-1405): full-resolution queries over
  strided keys and values, with the same ``v_full`` branch; heads split
  out of channel-major buffers by a raw view, which scrambles tokens and
  channels whenever T != C, kept for parity.

Down and CrossScale take only the ``dw_*_pw`` stems: every other branch
of the reference classes leaves ``v_full`` undefined. BatchNorm is flax's
(``models/batchnorm.py``: momentum 0.9, eps 1e-5, the biased running
variance, running statistics unless ``bn_train``), its output fp32. Layer
names are esvit_tpu's, so ``io/jax_params.py`` carries its weights
across.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from esvit_tpu_torch.models.batchnorm import BatchNorm
from esvit_tpu_torch.models.common import Conv, Dense, Dropout, gelu
from esvit_tpu_torch.ops.resample import bilinear_resize

_DW_METHODS = ("dw_glu_pw", "dw_bn_glu_pw", "dw_swish_pw", "dw_pw",
               "dw_bn_pw")
_PW_METHODS = ("pw_glu_conv_glu_pw", "pw_glu_conv_bn_glu_pw",
               "pw_glu_conv_swish_pw", "pw_glu_conv_bn_swish_pw",
               "pw_glu_dw_glu_pw", "pw_glu_conv_bn_pw")
METHODS = ("conv", "conv_pw") + _DW_METHODS + _PW_METHODS


def _swish(x):
    return x * torch.sigmoid(x)


def _activation(method: str):
    """A stem's activation: swish, else the erf GELU for a 'glu' stem,
    else none."""
    if "swish" in method:
        return _swish
    return gelu if "glu" in method else None


def _scores(q, k, scale):
    """fp32 q k^T * scale over the last two axes."""
    return q.float() @ k.float().transpose(-1, -2) * scale


def _split_cls(x):
    """(cls or None, grid tokens, H) for (B, N, C) with an optional leading
    CLS token (ref grid inference at layers/attention.py:466-473)."""
    N = x.shape[1]
    H = math.isqrt(N)
    if H * H == N:
        return None, x, H
    H = math.isqrt(N - 1)
    if H * H != N - 1:
        raise ValueError(f"token count {N} is not H*W or H*W+1")
    return x[:, :1], x[:, 1:], H


def _with_cls(cls, toks, dim):
    """[cls, toks] on the token axis; the raw CLS needs width dim (ref
    :488)."""
    if cls is None:
        return toks
    if cls.shape[-1] != dim:
        raise ValueError("the CLS passthrough needs an input width of dim")
    return torch.cat([cls.to(toks.dtype), toks], dim=1)


def _split_heads_tokens(tokens, nH, qkv_dim, ratio):
    """Token-major (B, T, F) -> per-head q, k, v (B, nH, T, hd), as the
    reference's channel-major reshapes (ref :527-537): F is (3, h, d) when
    ratio == 3, h-major [q | k | v] blocks otherwise."""
    B, T, F = tokens.shape
    if ratio != 3:
        hq = qkv_dim // nH
        t4 = tokens.reshape(B, T, nH, F // nH).transpose(1, 2)
        return t4[..., :hq], t4[..., hq:2 * hq], t4[..., 2 * hq:]
    return tokens.reshape(B, T, 3, nH, qkv_dim // nH).permute(
        2, 0, 3, 1, 4).unbind(0)


def _merge_heads(v):
    """(B, nH, T, hd) -> (B, T, nH*hd)."""
    B, nH, T, hd = v.shape
    return v.transpose(1, 2).reshape(B, T, nH * hd)


def _probs(q, k, prev, scale, res_score, attn_drop, deterministic,
           generator):
    """fp32 scores (plus the carried ``prev`` with ``res_score``), fp32
    softmax, dropout: (probabilities, the new prev)."""
    s = _scores(q, k, scale)
    if res_score:
        if prev is not None:
            s = s + prev
        prev = s
    return attn_drop(torch.softmax(s, dim=-1), deterministic, generator), prev


class AxialAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 qk_scale: float | None = None, horizontal: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim, self.num_heads, self.horizontal = dim, num_heads, horizontal
        self.dtype = dtype
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype,
                         generator=generator)
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """x (B, 1 + H*W, C), the CLS token first."""
        B, N, C = x.shape
        nH, dim = self.num_heads, self.dim
        hd = dim // nH
        H = W = math.isqrt(N - 1)
        cls, grid = x[:, :1], x[:, 1:].reshape(B, H, W, C)
        if not self.horizontal:                       # columns: swap axes
            grid = grid.transpose(1, 2)
        x_seq = torch.cat([cls, grid.reshape(B, H * W, C)], dim=1)
        q, k, v = self.qkv(x_seq).reshape(B, N, 3, nH, hd).permute(
            2, 0, 3, 1, 4).unbind(0)                  # (B, nH, N, hd)

        def rows(t):
            """(B, nH, 1+HW, hd) -> rows [cls, row tokens] (B*H, nH, 1+W,
            hd)."""
            t_cls = t[:, :, :1, None].expand(B, nH, H, 1, hd)
            t_grid = t[:, :, 1:].reshape(B, nH, H, W, hd)
            r = torch.cat([t_cls, t_grid], dim=3)
            return r.transpose(1, 2).reshape(B * H, nH, 1 + W, hd)

        v_r = rows(v)
        attn = _scores(rows(q), rows(k), self.scale)  # (B*H, nH, 1+W, 1+W)
        # The CLS query: cls -> cls from row 0, cls -> every grid token.
        cls_rows = attn.reshape(B, H, nH, 1 + W, 1 + W)[:, :, :, 0]
        cls_rows = cls_rows.transpose(1, 2)           # (B, nH, H, 1+W)
        cls_scores = torch.cat([cls_rows[:, :, 0, :1],
                                cls_rows[:, :, :, 1:].reshape(B, nH, H * W)],
                               dim=-1)
        p_cls = self.attn_drop(torch.softmax(cls_scores[:, :, None], dim=-1),
                               deterministic, generator)
        v_rows = v_r.reshape(B, H, nH, 1 + W, hd).transpose(1, 2)
        v_cls_full = torch.cat([v_rows[:, :, 0, :1], v_rows[:, :, :, 1:]
                                .reshape(B, nH, H * W, hd)], dim=2)
        out_cls = (p_cls.to(self.dtype) @ v_cls_full).transpose(1, 2)
        out_cls = out_cls.reshape(B, 1, dim)

        probs = self.attn_drop(torch.softmax(attn[:, :, 1:], dim=-1),
                               deterministic, generator)
        out = probs.to(self.dtype) @ v_r              # (B*H, nH, W, hd)
        out_grid = out.transpose(1, 2).reshape(B, H, W, dim)
        if not self.horizontal:
            out_grid = out_grid.transpose(1, 2)
        out = torch.cat([out_cls, out_grid.reshape(B, H * W, dim)], dim=1)
        return self.proj_drop(self.proj(out), deterministic, generator)


class CrissCrossAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 qk_scale: float | None = None, use_cls_token: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads, self.use_cls_token, self.dtype = (
            num_heads, use_cls_token, dtype)
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype,
                         generator=generator)
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, deterministic: bool = True,
                generator: torch.Generator | None = None):
        B, N, C = x.shape
        nH = self.num_heads
        hd = C // nH
        off = 1 if self.use_cls_token else 0
        H = W = math.isqrt(N - off)
        q, k, v = self.qkv(x).reshape(B, N, 3, nH, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        q_full, k_full, v_full = q, k, v
        qg, kg, vg = (t[:, :, off:].reshape(B, nH, H, W, hd)
                      for t in (q, k, v))

        def cols(t, t_all):
            """(B, nH, H, W, hd) -> columns (B, W, nH, [1+]H, hd), the CLS
            row of ``t_all`` in front."""
            c = t.permute(0, 3, 1, 2, 4)
            if not off:
                return c
            cc = t_all[:, None, :, :1].expand(B, W, nH, 1, hd)
            return torch.cat([cc, c], dim=3)

        v_h = cols(vg, v_full)
        score_h = _scores(cols(qg, q_full), cols(kg, k_full), self.scale)
        score_h_pix = score_h[:, :, :, off:].permute(0, 3, 2, 1, 4)
        # Rows (B, H, nH, W, W) without the diagonal (ref :271-273).
        score_w = _scores(qg, kg, self.scale).transpose(1, 2)
        eye = torch.eye(W, dtype=torch.bool, device=x.device)
        score_w = score_w.masked_fill(eye, float("-inf"))
        probs = self.attn_drop(torch.softmax(
            torch.cat([score_h_pix, score_w], dim=-1), dim=-1),
            deterministic, generator)
        p_h, p_w = probs[..., :H + off], probs[..., H + off:]
        x_h = p_h.permute(0, 3, 2, 1, 4).to(self.dtype) @ v_h
        x_h = x_h.permute(0, 3, 1, 2, 4).reshape(B, H, W, C)
        x_w = p_w.to(self.dtype) @ vg.transpose(1, 2)   # (B, H, nH, W, hd)
        x_w = x_w.transpose(2, 3).reshape(B, H, W, C)
        out = (x_h + x_w).reshape(B, H * W, C)
        if off:
            p_cls = self.attn_drop(torch.softmax(
                _scores(q_full[:, :, :1], k_full, self.scale), dim=-1),
                deterministic, generator)
            x_cls = (p_cls.to(self.dtype) @ v_full).transpose(1, 2)
            out = torch.cat([x_cls.reshape(B, 1, C), out], dim=1)
        return self.proj_drop(self.proj(out), deterministic, generator)


class ConvQKVAttention(nn.Module):
    """Conv-QKV attention (ref layers/attention.py:355-662 ``Attention``).
    ``forward`` returns (out, prev), or (out, prev, attn) with
    ``return_attn``; ``prev`` is the residual score carry."""

    def __init__(self, dim: int, in_dim: int | None = None,
                 num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: float | None = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, res_score: bool = False,
                 use_avg_att: bool = False, use_avg_att_all: bool = False,
                 use_qkvconv: bool = False, qkv_ratio: float = 3.0,
                 add_v_res: bool = False, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, method: str = "conv",
                 conv_reduce_ratio: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if method not in METHODS:
            raise ValueError(f"conv method {method} for qkv not supported")
        self.dim, self.num_heads, self.method = dim, num_heads, method
        self.res_score, self.use_avg_att = res_score, use_avg_att
        self.use_avg_att_all, self.use_qkvconv = use_avg_att_all, use_qkvconv
        self.qkv_ratio, self.add_v_res = qkv_ratio, add_v_res
        self.qkv_dim = int(dim * qkv_ratio) // 3
        self.scale = qk_scale or (self.qkv_dim // num_heads) ** -0.5
        cin = in_dim or dim
        wide = int(dim * qkv_ratio)
        # Only the dw stems size their pw layer for the reduced q/k layout
        # (ref :409-414); the others would scramble it.
        if qkv_ratio != 3 and not (use_qkvconv and method in _DW_METHODS):
            raise ValueError("qkv_ratio != 3 is only supported by the "
                             "dw_*_pw stems")
        f_out = self.qkv_dim * 2 + dim if qkv_ratio != 3 else wide
        kw = dict(dtype=dtype, generator=generator)
        conv = (kernel_size, stride, padding)
        if not use_qkvconv:
            self.qkv = Dense(cin, wide, bias=qkv_bias, **kw)
        elif method in _DW_METHODS:
            self.dw = Conv(cin, dim, *conv, groups=cin, bias=False, **kw)
            if "bn" in method:
                self.bn = BatchNorm(dim)
            self.pw = Dense(dim, f_out, bias=qkv_bias, **kw)
        elif method in _PW_METHODS:
            red = int(dim // conv_reduce_ratio)
            self.pw0 = Dense(cin, red, bias=False, **kw)
            if "dw" in method:
                self.dw = Conv(red, red, *conv, groups=red, bias=False, **kw)
            else:
                self.conv = Conv(red, red, *conv, bias=False, **kw)
            if "bn" in method:
                self.bn = BatchNorm(red)
            self.pw = Dense(red, f_out, bias=qkv_bias, **kw)
        elif method == "conv_pw":
            self.conv = Conv(cin, dim, *conv, bias=False, **kw)
            self.pw = Dense(dim, f_out, bias=qkv_bias, **kw)
        else:
            self.qkv = Conv(cin, wide, *conv, bias=qkv_bias, **kw)
        self.proj = Dense(dim, dim, **kw)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def _qkv_conv_tokens(self, x, bn_train):
        """The reference's ``forward_qkvconv`` stem (ref :465-539): the
        pre-split (B, T, F) qkv tokens."""
        m, dim = self.method, self.dim
        cls, grid, H = _split_cls(x)
        B, C = x.shape[0], x.shape[-1]
        xg = grid.reshape(B, H, H, C)
        if m in _DW_METHODS:
            xg = self.dw(xg)
            if "bn" in m:
                xg = self.bn(xg, bn_train, torch.float32)
            act = _activation(m)
            if act is not None:
                xg = act(xg)
            return self.pw(_with_cls(cls, xg.reshape(B, -1, dim), dim))
        if m in _PW_METHODS:
            t = gelu(self.pw0(grid))
            tg = t.reshape(B, H, H, -1)
            tg = self.dw(tg) if "dw" in m else self.conv(tg)
            if "bn" in m:
                tg = self.bn(tg, bn_train, torch.float32)
            if m != "pw_glu_conv_bn_pw":            # every other has 'glu'
                tg = _activation(m)(tg)
            toks = tg.reshape(B, -1, tg.shape[-1])
            if cls is not None:                     # CLS through pw0 alone
                toks = torch.cat([self.pw0(cls).to(toks.dtype), toks], dim=1)
            return self.pw(toks)
        if m == "conv_pw":
            xg = gelu(self.conv(xg))
            return self.pw(_with_cls(cls, xg.reshape(B, -1, dim), dim))
        toks = self.qkv(xg)
        toks = toks.reshape(B, -1, toks.shape[-1])
        if cls is not None:
            # ref :523: the CLS vector tiled to a 3x3 patch and convolved;
            # the flattened output at index 4 becomes CLS's qkv row.
            yc = self.qkv(cls.reshape(B, 1, 1, C).expand(B, 3, 3, C))
            toks = torch.cat([yc.reshape(B, -1, yc.shape[-1])[:, 4:5], toks],
                             dim=1)
        return toks

    def forward(self, x, prev=None, deterministic: bool = True,
                bn_train: bool = False, return_attn: bool = False,
                generator: torch.Generator | None = None):
        B, N = x.shape[:2]
        nH, dim = self.num_heads, self.dim
        if self.use_qkvconv:
            q, k, v = _split_heads_tokens(self._qkv_conv_tokens(x, bn_train),
                                          nH, self.qkv_dim, self.qkv_ratio)
        else:
            q, k, v = self.qkv(x).reshape(B, N, 3, nH, dim // nH).permute(
                2, 0, 3, 1, 4).unbind(0)
        attn = None
        vT = _merge_heads(v)                           # (B, T, dim)
        if self.use_avg_att:
            rest = vT[:, 1:]
            out = torch.cat([rest.mean(dim=1, keepdim=True), rest], dim=1)
            if self.qkv_ratio == 3:
                # ref :557-558: v's merge is a view for every ratio-3
                # layout, so the row write lands in the v add_v_res adds.
                vT = out
        elif self.use_avg_att_all:
            out = vT.mean(dim=1, keepdim=True).expand_as(vT)
        else:
            attn, prev = _probs(q, k, prev, self.scale, self.res_score,
                                self.attn_drop, deterministic, generator)
            out = _merge_heads(attn.to(vT.dtype) @ v)
        out = self.proj_drop(self.proj(out), deterministic, generator)
        if self.add_v_res:
            out = out + vT
        if return_attn:
            return out, prev, attn
        return out, prev


class _VFullAttention(nn.Module):
    """Down and CrossScale's shared parts: the full-resolution value branch
    (dw k3/s1/p1 -> BN -> pw) and the tail that adds it before or after
    ``proj``."""

    def __init__(self, *, dim: int, in_dim: int | None, num_heads: int,
                 qkv_bias: bool, attn_drop: float, proj_drop: float,
                 res_score: bool, add_v_res: bool, method: str,
                 add_v_full_after_proj: bool, dtype: torch.dtype,
                 generator: torch.Generator | None):
        super().__init__()
        if method not in _DW_METHODS:
            raise ValueError("only the dw_*_pw stems are reachable in the "
                             "reference")
        self.dim, self.num_heads, self.method = dim, num_heads, method
        self.res_score, self.add_v_res = res_score, add_v_res
        self.add_v_full_after_proj = add_v_full_after_proj
        kw = dict(dtype=dtype, generator=generator)
        cin = in_dim or dim
        self.v_dw = Conv(cin, dim, 3, 1, 1, groups=cin, bias=False, **kw)
        self.v_bn = BatchNorm(dim)
        self.v_pw = Dense(dim, dim, bias=qkv_bias, **kw)
        self.proj = Dense(dim, dim, **kw)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def _v_full(self, xg, bn_train):
        B, H = xg.shape[:2]
        vf = self.v_bn(self.v_dw(xg), bn_train, torch.float32)
        return self.v_pw(vf.reshape(B, H * H, self.dim))

    def _stem(self, dw, bn, xg, bn_train):
        """A dw stem's grid: dw conv, BN if the method has one, its
        activation."""
        y = dw(xg)
        if "bn" in self.method:
            y = bn(y, bn_train, torch.float32)
        act = _activation(self.method)
        return act(y) if act is not None else y

    def _tail(self, out, cls, v_full, vT, deterministic, generator):
        """Add v_full to the grid tokens before ``proj`` (ref :919-922,
        :1302-1303) or after it (ref :936-939, :1314-1317), and v with
        ``add_v_res``."""
        if not self.add_v_full_after_proj:
            out = out + v_full
        if cls is not None:
            out = torch.cat([cls, out], dim=1)
        out = self.proj_drop(self.proj(out), deterministic, generator)
        if self.add_v_res:
            out = out + vT
        if self.add_v_full_after_proj:
            rest = out[:, 1:1 + v_full.shape[1]] + v_full
            out = torch.cat([out[:, :1], rest], dim=1)
        return out


class DownAttention(_VFullAttention):
    """Strided conv-QKV attention, upsampled 2x (bilinear) and fused with
    the full-resolution value branch (ref layers/attention.py:664-1030).
    ``forward`` returns (out, prev)."""

    def __init__(self, dim: int, in_dim: int | None = None,
                 num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: float | None = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, res_score: bool = False,
                 qkv_ratio: float = 3.0, add_v_res: bool = False,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 method: str = "dw_bn_glu_pw",
                 add_v_full_after_proj: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(dim=dim, in_dim=in_dim, num_heads=num_heads,
                         qkv_bias=qkv_bias, attn_drop=attn_drop,
                         proj_drop=proj_drop, res_score=res_score,
                         add_v_res=add_v_res, method=method,
                         add_v_full_after_proj=add_v_full_after_proj,
                         dtype=dtype, generator=generator)
        kw = dict(dtype=dtype, generator=generator)
        cin = in_dim or dim
        self.qkv_ratio = qkv_ratio
        self.qkv_dim = int(dim * qkv_ratio) // 3
        self.scale = qk_scale or (self.qkv_dim // num_heads) ** -0.5
        f_out = (self.qkv_dim * 2 + dim if qkv_ratio != 3
                 else int(dim * qkv_ratio))
        self.dw = Conv(cin, dim, kernel_size, stride, padding, groups=cin,
                       bias=False, **kw)
        if "bn" in method:
            self.bn = BatchNorm(dim)
        self.pw = Dense(dim, f_out, bias=qkv_bias, **kw)

    def forward(self, x, prev=None, deterministic: bool = True,
                bn_train: bool = False,
                generator: torch.Generator | None = None):
        dim = self.dim
        cls, grid, H = _split_cls(x)
        B, C = x.shape[0], x.shape[-1]
        xg = grid.reshape(B, H, H, C)
        v_full = self._v_full(xg, bn_train)
        yg = self._stem(self.dw, getattr(self, "bn", None), xg, bn_train)
        toks = self.pw(_with_cls(cls, yg.reshape(B, -1, dim), dim))
        q, k, v = _split_heads_tokens(toks, self.num_heads, self.qkv_dim,
                                      self.qkv_ratio)
        p, prev = _probs(q, k, prev, self.scale, self.res_score,
                         self.attn_drop, deterministic, generator)
        vT = _merge_heads(v)
        out = _merge_heads(p.to(vT.dtype) @ v)
        x_cls = None
        if cls is not None:
            x_cls, out = out[:, :1], out[:, 1:]
        Hd = math.isqrt(out.shape[1])
        out = bilinear_resize(out.reshape(B, Hd, Hd, dim), 2 * Hd, 2 * Hd,
                              2.0, 2.0).reshape(B, -1, dim)
        return self._tail(out, x_cls, v_full, vT, deterministic,
                          generator), prev


class CrossScaleAttention(_VFullAttention):
    """Full-resolution queries over strided keys and values, with the
    v_full branch (ref layers/attention.py:1032-1405; the reference
    asserts qkv_ratio == 3, :1089). ``forward`` returns (out, prev)."""

    def __init__(self, dim: int, in_dim: int | None = None,
                 num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: float | None = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, res_score: bool = False,
                 add_v_res: bool = False, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1,
                 method: str = "dw_bn_glu_pw",
                 add_v_full_after_proj: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(dim=dim, in_dim=in_dim, num_heads=num_heads,
                         qkv_bias=qkv_bias, attn_drop=attn_drop,
                         proj_drop=proj_drop, res_score=res_score,
                         add_v_res=add_v_res, method=method,
                         add_v_full_after_proj=add_v_full_after_proj,
                         dtype=dtype, generator=generator)
        kw = dict(dtype=dtype, generator=generator)
        cin = in_dim or dim
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.q_dw = Conv(cin, dim, kernel_size, 1, padding, groups=cin,
                         bias=False, **kw)
        self.q_bn = BatchNorm(dim)
        self.q_pw = Dense(dim, dim, bias=qkv_bias, **kw)
        self.kv_dw = Conv(cin, dim, kernel_size, stride, padding, groups=cin,
                          bias=False, **kw)
        if "bn" in method:
            self.kv_bn = BatchNorm(dim)
        self.kv_pw = Dense(dim, 2 * dim, bias=qkv_bias, **kw)

    def _scramble(self, toks):
        """Token-major (B, T, C) -> (B, nH, T, hd) through the reference's
        raw view of the channel-major (B, C, T) buffer (ref :1238-1240)."""
        B, T, C = toks.shape
        nH = self.num_heads
        return toks.transpose(1, 2).reshape(B, T, nH, C // nH).transpose(1, 2)

    def forward(self, x, prev=None, deterministic: bool = True,
                bn_train: bool = False,
                generator: torch.Generator | None = None):
        dim = self.dim
        cls, grid, H = _split_cls(x)
        B, C = x.shape[0], x.shape[-1]
        xg = grid.reshape(B, H, H, C)
        v_full = self._v_full(xg, bn_train)
        qg = self.q_bn(self.q_dw(xg), bn_train, torch.float32)
        q_toks = self.q_pw(_with_cls(cls, qg.reshape(B, -1, dim), dim))
        kvg = self._stem(self.kv_dw, getattr(self, "kv_bn", None), xg,
                         bn_train)
        kv = self.kv_pw(_with_cls(cls, kvg.reshape(B, -1, dim), dim))
        q, k, v = (self._scramble(t) for t in
                   (q_toks, kv[..., :dim], kv[..., dim:]))
        p, prev = _probs(q, k, prev, self.scale, self.res_score,
                         self.attn_drop, deterministic, generator)
        vT = _merge_heads(v)
        out = _merge_heads(p.to(vT.dtype) @ v)
        x_cls = None
        if cls is not None:
            x_cls, out = out[:, :1], out[:, 1:]
        return self._tail(out, x_cls, v_full, vT, deterministic,
                          generator), prev
