"""Swin Transformer backbone in PyTorch (port of esvit_tpu/models/swin.py).

NHWC inputs, reference checkpoint names (``patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.qkv``, ``layers.{i}.downsample.reduction``,
``norm``), and the JAX package's stage routing
(esvit_tpu/models/swin.py:677-691, :745-799), chosen per stage by
:meth:`SwinStage.route`:

- a stage whose tokens form one spatially padded window per image
  (Hp == Wp == ws > H) takes the sub-window route: on the augmented window
  (H*W real tokens + 1 virtual pad token) through the block-fused kernel
  when the stage is in ``subwindow_fused_stages`` (None: follow
  ``fused_block_stages``) and the kernel takes the shape
  (``SwinStage._forward_fused_subwindow``), else each block's
  virtual-pad-column math in plain torch (``SwinBlock._subwindow``);
- a stage in ``fused_block_stages`` whose shape the kernel takes runs each
  block as one call of ``ops/fused_block.py`` in window-major order
  (``SwinStage._forward_fused``);
- every other stage runs window-major (``SwinStage._forward_window_major``,
  or the classic per-block partition with ``layout_opt=False``), and its
  windowed attention goes through ``ops/window_attention.py`` (the CUDA
  kernel pair for tensors on the card) when ``attention_impl='packed'``,
  through ``ops/pallas_window_attention.py`` (the forward-only kernel on
  the qkv layout with a dense bias + shift-mask operand) when
  ``attention_impl='pallas'``, and through the plain torch version when
  ``attention_impl='xla'``. Each kernel route asks its kernel's own
  ``supports()`` first and takes that kernel's plain version for a shape
  it refuses (``WindowAttention.kernel_takes``); both take Swin at W=14
  (N=196) on the large-window tile.

Capturing per-block outputs or attention maps (``SwinStage.forward``'s
``capture``, used by ``forward_return_n_last_blocks`` and
``forward_selfattention``) runs every stage block by block, as the
reference does (esvit_tpu/models/swin.py:667-702); an attention map is
computed on the plain path.

The fused kernel pair runs for CUDA tensors and its plain version for CPU
tensors; which route a stage takes depends on shapes and the config
alone, never on the device.

Dropout routes as esvit_tpu's (esvit_tpu/models/swin.py:231, :258, :753,
:773, :792): ``drop_rate`` or ``attn_drop_rate`` > 0 keeps a stage off
both fused routes; ``attn_drop_rate`` > 0 also keeps it off the
sub-window route (a single padded window then runs window-major) and
sends every attention call to the plain path, away from both
window-attention kernels. Masks come from the step's generator.
``remat='block'`` runs each block of the window-major and classic loops
under ``torch.utils.checkpoint`` (models/common.py ``remat``, which
rewinds the generator for the recompute, so the recomputed block draws
the forward's masks); the fused routes recompute in their own backward
and are left as they are.

The per-stage effective window follows the reference
(swin_transformer.py:206-210): if the construction-time resolution is at
most the window, the window shrinks to it and shift is off.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esvit_tpu_torch.config import SwinConfig
from esvit_tpu_torch.models.common import (Dense, DropPath, Dropout,
                                           LayerNorm, Mlp, PatchConv, remat,
                                           softmax_fp32, trunc_normal_)
from esvit_tpu_torch.ops import fused_block as fb
from esvit_tpu_torch.ops import pallas_window_attention as pwa
from esvit_tpu_torch.ops import window as wops
from esvit_tpu_torch.ops import window_attention as wa
from esvit_tpu_torch.ops.pallas_window_attention import (
    fused_window_attention, pallas_window_attention_plain)
from esvit_tpu_torch.ops.window_attention import (window_attention,
                                                  window_attention_plain)

CAPTURES = (None, "features", "attention")


@functools.lru_cache(maxsize=None)
def _subwindow_geometry(H, W, ws, ss):
    """Positions of the H*W real tokens in the (rolled, for shifted
    blocks) ws x ws window, the pad positions, and the reference shift
    mask or None. The reference's roll by -ss on the padded grid maps
    real row i to (i - ss) % ws."""
    N = ws * ws
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pos = (((ii - ss) % ws) * ws + ((jj - ss) % ws)).reshape(-1)
    pad_pos = np.setdiff1d(np.arange(N), pos)
    m = (np.asarray(wops.shifted_window_mask(H, W, ws, ss), np.float32)[0]
         if ss > 0 else None)
    return pos, pad_pos, m


def _subwindow_cols(H, W, ws, ss, part):
    pos, pad_pos, m = _subwindow_geometry(H, W, ws, ss)
    return pos, (pos if part == "real" else pad_pos), m


@functools.lru_cache(maxsize=None)
def _subwindow_index(H, W, ws, ss, part):
    """(L, K) rel-pos table rows of the (real query, ``part`` key) pairs,
    ``part`` being 'real' or 'pad'."""
    pos, cols, _ = _subwindow_cols(H, W, ws, ss, part)
    idx = wops.relative_position_index(ws, ws)[pos[:, None], cols[None, :]]
    return idx.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _subwindow_mask(H, W, ws, ss, part):
    """(L, K) additive shift mask of the same pairs (zeros if unshifted)."""
    pos, cols, m = _subwindow_cols(H, W, ws, ss, part)
    if m is None:
        return np.zeros((len(pos), len(cols)), np.float32)
    return m[pos[:, None], cols[None, :]]


def _subwindow_bias_parts(table, H, W, ws, ss):
    """(bias_real (L, L, nH), log_s (L, nH)) from the rel-pos table: the
    real-token bias (+shift mask) and the per-(query, head) logsumexp of
    the pad columns' bias (+mask), the virtual pad column's logit term."""
    parts = []
    for part in ("real", "pad"):
        args = (H, W, ws, ss, part)
        idx = wops.device_table(_subwindow_index, args, table.device)
        mask = wops.device_table(_subwindow_mask, args, table.device)
        parts.append(table[idx] + mask[..., None])
    bias_real, bias_pad = parts
    return bias_real, torch.logsumexp(bias_pad, dim=1)


@functools.lru_cache(maxsize=None)
def _augmented_pad(L):
    """(L+1,) row multiplier of the augmented window: 1 for the L real
    tokens, 0 for the virtual pad token."""
    pad = np.ones(L + 1, np.float32)
    pad[L] = 0.0
    return pad


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA with relative position bias
    (ref: models/swin_transformer.py:72-152). Input ``(B_, N, C)`` windows;
    ``shift`` is ``(H, W, shift_size)`` of a shifted block's token grid, or
    None when unshifted."""

    def __init__(self, dim, window_size, num_heads, qkv_bias=True,
                 qk_scale=None, attention_impl="packed",
                 dtype=torch.float32, generator=None, attn_drop=0.0,
                 proj_drop=0.0):
        super().__init__()
        ws = window_size
        self.window_size = ws
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attention_impl = attention_impl
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.relative_position_bias_table = nn.Parameter(trunc_normal_(
            torch.empty((2 * ws - 1) ** 2, num_heads), generator=generator))
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)

    def rel_bias(self) -> torch.Tensor:
        """(nH, N, N) fp32 relative-position bias."""
        ws = self.window_size
        table = self.relative_position_bias_table
        idx = wops.device_table(wops.relative_position_index, (ws, ws),
                                table.device).long()
        return table[idx].permute(2, 0, 1).contiguous()

    def dense_bias(self, shift, device) -> torch.Tensor:
        """(nWm, nH, N, N) fp32: the rel-pos bias plus, when shifted, the
        (nW, N, N) -100 shift mask (esvit_tpu/models/swin.py:252-255)."""
        bias = self.rel_bias()[None]
        if shift is None:
            return bias
        H, W, ss = shift
        mask = wops.device_table(wops.shifted_window_mask,
                                 (H, W, self.window_size, ss), device)
        return bias + mask[:, None]

    def kernel_takes(self, N: int, C: int) -> bool:
        """Whether this module's kernel route takes windows of N tokens at
        width C, by that kernel's own shape rule: the qkv-layout kernel's
        (``attention_impl='pallas'``), the packed pair's ('packed'); never
        under attention dropout or on the plain route ('xla')."""
        if self.attn_drop.rate > 0.0:
            return False
        if self.attention_impl == "pallas":
            return pwa.supports(N, C, self.num_heads)
        if self.attention_impl == "packed":
            return wa.supports(N, C, self.num_heads)
        return False

    def forward(self, x, shift=None, return_attention=False,
                deterministic=True, generator=None):
        """The projected attention output; with ``return_attention`` also
        the (B_, nH, N, N) fp32 probabilities, from the plain path.
        Attention dropout (``attn_drop`` > 0) takes the plain path
        whatever ``attention_impl`` says (esvit_tpu/models/swin.py:231,
        :258), deterministic or not. A kernel route whose kernel refuses
        the shape (:meth:`kernel_takes`) takes that kernel's plain
        version."""
        B_, N, C = x.shape
        qkv = self.qkv(x)
        plain_only = self.attn_drop.rate > 0.0
        kernel = self.kernel_takes(N, C)
        if (self.attention_impl == "pallas" and not return_attention
                and not plain_only):
            attend = (fused_window_attention if kernel
                      else pallas_window_attention_plain)
            out = attend(qkv, self.dense_bias(shift, x.device),
                         self.num_heads, self.scale)
            return self._project(out, deterministic, generator)
        qkv = qkv.reshape(B_ * N, 3 * C)
        q2, k2, v2 = (qkv[:, i * C:(i + 1) * C].contiguous() for i in range(3))
        drop = ((lambda p: self.attn_drop(p, deterministic, generator))
                if plain_only else None)
        if return_attention:
            out, probs = window_attention_plain(
                q2, k2, v2, self.dense_bias(shift, x.device), None, N,
                self.num_heads, self.scale, return_probs=True, drop=drop)
            return self._project(out.reshape(B_, N, C), deterministic,
                                 generator), probs
        region = shift_region(shift, self.window_size, x.device)
        if self.attention_impl == "packed" and kernel:
            out = window_attention(q2, k2, v2, self.rel_bias(), region, N,
                                   self.num_heads, self.scale)
        else:
            out = window_attention_plain(q2, k2, v2, self.rel_bias(), region,
                                         N, self.num_heads, self.scale,
                                         drop=drop)
        return self._project(out.reshape(B_, N, C), deterministic, generator)

    def _project(self, out, deterministic, generator):
        return self.proj_drop(self.proj(out), deterministic, generator)


def shift_region(shift, ws, device):
    """(nW, N) region ids of a shifted block's windows, ``shift`` being
    (H, W, shift_size); None when unshifted."""
    if shift is None:
        return None
    H, W, ss = shift
    return wops.device_table(wops.window_region_ids, (H, W, ws, ss), device)


class SwinBlock(nn.Module):
    """(S)W-MSA + MLP with pre-norm residuals
    (ref: models/swin_transformer.py:177-333)."""

    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio=4.0,
                 qkv_bias=True, qk_scale=None, drop_path=0.0, norm_eps=1e-6,
                 attention_impl="packed", subwindow_opt=True,
                 dtype=torch.float32, generator=None, drop=0.0,
                 attn_drop=0.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.num_heads = num_heads
        self.subwindow_opt = subwindow_opt
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, norm_eps, dtype)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    qk_scale, attention_impl, dtype, generator,
                                    attn_drop, drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, generator, drop)

    def _keep_scale(self, B, deterministic, generator, device):
        """(B,) fp32 drop-path scales {0, 1/keep}, drawn as DropPath draws
        its mask, or None when stochastic depth is off."""
        dp = self.drop_path
        if dp.rate == 0.0 or deterministic:
            return None
        keep = dp.keep_mask(B, generator, device)
        return keep.float() / (1.0 - dp.rate)

    def fused(self, x, bias, N, nW, region, pad, deterministic, generator):
        """The block as one call of the fused kernel pair on window-major
        rows (B, nW*N, C). The two drop-path masks are drawn in the classic
        path's order (attention branch, then MLP branch), so the route
        does not shift the random stream."""
        B, _, C = x.shape
        keep1 = self._keep_scale(B, deterministic, generator, x.device)
        keep2 = self._keep_scale(B, deterministic, generator, x.device)
        attn = self.attn
        w = attn.qkv.weight
        bqkv = (attn.qkv.bias if attn.qkv.bias is not None
                else torch.zeros(3 * C, device=x.device))
        params = dict(
            g1=self.norm1.weight, be1=self.norm1.bias,
            wq=w[:C].t(), bq=bqkv[:C], wk=w[C:2 * C].t(), bk=bqkv[C:2 * C],
            wv=w[2 * C:].t(), bv=bqkv[2 * C:], bias=bias,
            wp=attn.proj.weight.t(), bp=attn.proj.bias,
            g2=self.norm2.weight, be2=self.norm2.bias,
            w1=self.mlp.fc1.weight.t(), b1=self.mlp.fc1.bias,
            w2=self.mlp.fc2.weight.t(), b2=self.mlp.fc2.bias)
        return fb.fused_swin_block(x.to(self.dtype), params, keep1, keep2,
                                   N=N, nH=self.num_heads, nW=nW,
                                   scale=attn.scale, region=region, pad=pad,
                                   eps=self.norm1.eps)

    def _ffn(self, x, deterministic, generator):
        y = self.mlp(self.norm2(x), deterministic, generator)
        return x + self.drop_path(y, deterministic, generator)

    def takes_subwindow(self, L: int) -> bool:
        """Whether the classic loop runs this block's sub-window path on L
        tokens (esvit_tpu/models/swin.py:478-484): not under attention
        dropout."""
        return (self.subwindow_opt and self.attn.attn_drop.rate == 0.0
                and self.is_subwindow(L))

    def is_subwindow(self, L: int) -> bool:
        """One spatially padded window per image (Hp == Wp == ws > H)."""
        H = W = math.isqrt(L)
        Hp, Wp = wops.pad_to_window_multiple(H, W, self.window_size)
        return (Hp, Wp) == (self.window_size,) * 2 and (Hp, Wp) != (H, W)

    def _subwindow(self, x, H, W, deterministic, generator):
        """Single-padded-window block without materialized pad rows.

        Pad tokens enter the qkv projection as exact zeros, so their keys
        and values are the projection biases; for each (query, head) the
        pad columns collapse into one virtual column with logit
        q . b_k * scale + logsumexp_p(bias[q, p] + mask[q, p]) and value
        b_v (esvit_tpu/models/swin.py SwinBlock._subwindow)."""
        B, L, C = x.shape
        ws, ss, nH = self.window_size, self.shift_size, self.num_heads
        hd = C // nH
        cd = self.dtype
        attn_mod = self.attn
        bias_real, log_s = _subwindow_bias_parts(
            attn_mod.relative_position_bias_table, H, W, ws, ss)

        shortcut = x
        qkv = attn_mod.qkv(self.norm1(x)).reshape(B, L, 3, nH, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qs = q * torch.tensor(attn_mod.scale, dtype=cd)
        attn = torch.einsum("bnhd,bmhd->bhnm", qs.float(), k.float())
        attn = attn + bias_real.permute(2, 0, 1)[None]
        bqkv = (attn_mod.qkv.bias if attn_mod.qkv.bias is not None
                else torch.zeros(3 * C, device=x.device))
        b_k = bqkv[C:2 * C].reshape(nH, hd).to(cd)
        b_v = bqkv[2 * C:].reshape(nH, hd).to(cd)
        lv = torch.einsum("bnhd,hd->bhn", qs.float(), b_k.float())
        lv = lv + log_s.t()[None]                                # (B, nH, L)
        probs = softmax_fp32(torch.cat([attn, lv[..., None]], dim=-1))
        # (B, nH, L, L+1): the L real keys, then the virtual pad column
        out = torch.einsum("bhnm,bmhd->bnhd", probs[..., :L].to(cd), v)
        out = out + torch.einsum("bhn,hd->bnhd", probs[..., L].to(cd), b_v)
        out = attn_mod._project(out.reshape(B, L, C), deterministic, generator)
        x = shortcut + self.drop_path(out, deterministic, generator)
        return self._ffn(x, deterministic, generator)

    def forward(self, x, deterministic=True, generator=None,
                window_major: dict | None = None, return_attention=False):
        """Classic path: x is (B, H*W, C) spatial tokens. Window-major path
        (window_major = {'shift', 'pad_mask', 'n_windows', ...}): x is
        already in this block's window-major layout. With
        ``return_attention`` (classic path only) returns (x, attention
        probabilities); the sub-window path is then skipped, as in JAX."""
        B, L, C = x.shape
        ws, ss = self.window_size, self.shift_size
        if window_major is not None:
            shortcut = x
            y = self.norm1(x)
            if window_major["pad_mask"] is not None:
                y = y * window_major["pad_mask"].to(y.dtype)[None, :, None]
            windows = y.reshape(B * window_major["n_windows"], ws * ws, C)
            out = self.attn(windows, window_major["shift"],
                            deterministic=deterministic, generator=generator)
            x = shortcut + self.drop_path(out.reshape(B, L, C), deterministic,
                                          generator)
            return self._ffn(x, deterministic, generator)

        H = W = math.isqrt(L)
        if self.takes_subwindow(L) and not return_attention:
            return self._subwindow(x, H, W, deterministic, generator)

        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        Hp, Wp = wops.pad_to_window_multiple(H, W, ws)
        if (Hp, Wp) != (H, W):
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        shift = None
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
            shift = (H, W, ss)
        out = self.attn(wops.window_partition(x, ws), shift, return_attention,
                        deterministic, generator)
        if return_attention:
            out, probs = out
        x = wops.window_reverse(out, ws, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = x[:, :H, :W, :].reshape(B, L, C)
        x = shortcut + self.drop_path(x, deterministic, generator)
        x = self._ffn(x, deterministic, generator)
        return (x, probs) if return_attention else x


class PatchMerging(nn.Module):
    """2x2 patch merging: concat 4 neighbours -> LN -> linear 4C->2C
    (ref: models/swin_transformer.py:354-420, x0..x3 order kept)."""

    def __init__(self, dim, norm_eps=1e-6, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, norm_eps, dtype)
        self.reduction = Dense(4 * dim, 2 * dim, False, dtype, generator)

    def forward(self, x):
        B, L, C = x.shape
        H = W = math.isqrt(L)
        x = x.reshape(B, H, W, C)
        if H % 2 == 1 or W % 2 == 1:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], dim=-1).reshape(B, -1, 4 * C)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """Non-overlapping conv patch embedding (ref: swin_transformer.py:
    514-547), then LayerNorm."""

    def __init__(self, patch_size, in_chans, embed_dim, patch_norm=True,
                 norm_eps=1e-6, dtype=torch.float32, generator=None):
        super().__init__()
        self.proj = PatchConv(in_chans, embed_dim, patch_size, dtype,
                              generator)
        self.norm = (LayerNorm(embed_dim, norm_eps, dtype) if patch_norm
                     else None)

    def forward(self, x):
        x = self.proj(x)                                         # NHWC
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        return self.norm(x) if self.norm is not None else x


class SwinStage(nn.Module):
    """Swin blocks + optional patch merging (ref: BasicLayer,
    models/swin_transformer.py:433-499)."""

    def __init__(self, dim, depth, num_heads, window_size, shift_enabled,
                 mlp_ratio, qkv_bias, qk_scale, drop_path, norm_eps,
                 downsample, attention_impl="packed", subwindow_opt=True,
                 dtype=torch.float32, generator=None, fused=False,
                 subwindow_fused=False, drop=0.0, attn_drop=0.0,
                 remat="none"):
        super().__init__()
        if remat not in ("none", "block"):
            raise ValueError(f"unknown remat mode {remat!r}")
        self.window_size = window_size
        self.dim = dim
        self.num_heads = num_heads
        self.hidden = int(dim * mlp_ratio)
        self.fused = fused
        self.subwindow_fused = subwindow_fused
        # Any dropout keeps a stage off the fused kernel (JAX :773, :792).
        self.dropout = drop > 0.0 or attn_drop > 0.0
        self.remat = remat == "block"
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      window_size // 2 if (i % 2 == 1 and shift_enabled) else 0,
                      mlp_ratio, qkv_bias, qk_scale, drop_path[i], norm_eps,
                      attention_impl, subwindow_opt, dtype, generator, drop,
                      attn_drop)
            for i in range(depth)])
        self.downsample = (PatchMerging(dim, norm_eps, dtype, generator)
                           if downsample else None)

    def _fused_ok(self) -> bool:
        """Whether the fused kernel takes this stage's full windows."""
        return fb.supports(self.window_size ** 2, self.dim, self.num_heads,
                           self.hidden)

    def _subwindow_fused_ok(self, L: int) -> bool:
        """Whether the fused kernel takes the augmented window (L + 1)."""
        return fb.supports(L + 1, self.dim, self.num_heads, self.hidden)

    def subwindow_ok(self, L: int) -> bool:
        """Whether an input of L tokens takes the sub-window route
        (esvit_tpu SwinStage._subwindow_ok at its default ratio of 1.0):
        one spatially padded window per image, no attention dropout."""
        return self.blocks[0].takes_subwindow(L)

    def route(self, L: int, layout_opt: bool = True) -> str:
        """The path an input of L tokens takes: 'fused_subwindow',
        'fused', 'window_major' or 'classic' (block by block, each block
        choosing its sub-window or partitioned attention)."""
        if not layout_opt or len(self.blocks) == 0:
            return "classic"
        if self.subwindow_ok(L):
            if (self.subwindow_fused and not self.dropout
                    and self._subwindow_fused_ok(L)):
                return "fused_subwindow"
            return "classic"
        if self.fused and not self.dropout and self._fused_ok():
            return "fused"
        return "window_major"

    def forward(self, x, deterministic=True, generator=None, layout_opt=True,
                capture=None):
        """The stage's output; with ``capture`` ('features' or
        'attention') the pair (output, one entry per block: its output or
        its attention probabilities), from the classic block loop."""
        if capture not in CAPTURES:
            raise ValueError(f"capture must be one of {CAPTURES}, got "
                             f"{capture!r}")
        if capture is not None:
            aux = []
            for blk in self.blocks:
                if capture == "attention":
                    x, attn = blk(x, deterministic, generator,
                                  return_attention=True)
                    aux.append(attn)
                else:
                    x = blk(x, deterministic, generator)
                    aux.append(x)
            x = self.downsample(x) if self.downsample is not None else x
            return x, aux
        route = self.route(x.shape[1], layout_opt)
        if route == "fused_subwindow":
            x = self._forward_fused_subwindow(x, deterministic, generator)
        elif route == "fused":
            x = self._forward_fused(x, deterministic, generator)
        elif route == "window_major":
            x = self._forward_window_major(x, deterministic, generator)
        else:
            for blk in self.blocks:
                x = self._run(lambda x, blk=blk: blk(x, deterministic,
                                                     generator), x, generator)
        return self.downsample(x) if self.downsample is not None else x

    def _run(self, fn, x, generator):
        """One block: under ``remat='block'`` through models/common.py
        ``remat`` (recomputed in backward, the generator rewound), else
        as it is. The fused routes do not come here: their kernel's
        backward recomputes from the block input already."""
        return remat(fn, x, generator) if self.remat else fn(x)

    def _forward_fused_subwindow(self, x, deterministic, generator):
        """Each image is one augmented window of N = H*W + 1 tokens: the
        real tokens and one virtual token standing for every pad position
        (JAX SwinStage._forward_fused_subwindow). The kernel's pad
        multiplier zeroes the virtual row after LN1, so its key and value
        are the qkv biases; its bias column holds the pad columns'
        logsumexp, and the shift rides the bias (no region)."""
        B, L, C = x.shape
        H = W = math.isqrt(L)
        ws, N = self.window_size, L + 1
        x = F.pad(x, (0, 0, 0, 1))
        pad = wops.device_table(_augmented_pad, (L,), x.device)
        for blk in self.blocks:
            bias_real, log_s = _subwindow_bias_parts(
                blk.attn.relative_position_bias_table, H, W, ws,
                blk.shift_size)
            top = torch.cat([bias_real.permute(2, 0, 1),
                             log_s.t()[:, :, None]], dim=2)  # (nH, L, N)
            bias = F.pad(top, (0, 0, 0, 1))                  # (nH, N, N)
            x = blk.fused(x, bias, N, 1, None, pad, deterministic, generator)
        return x[:, :L]

    def _forward_fused(self, x, deterministic, generator):
        """The stage in window-major order (ops/window.py), each block one
        call of the fused kernel pair (JAX SwinStage._forward_fused, on the
        port's unpadded window-major layout)."""
        return self._window_major(x, lambda blk, x, wm: blk.fused(
            x, blk.attn.rel_bias(), self.window_size ** 2, wm["n_windows"],
            shift_region(wm["shift"], self.window_size, x.device),
            wm["pad_mask"], deterministic, generator))

    def _forward_window_major(self, x, deterministic, generator):
        return self._window_major(
            x, lambda blk, x, wm: self._run(
                lambda x: blk(x, deterministic, generator, wm), x, generator))

    def _window_major(self, x, run_block):
        """Pad to whole windows, run each block in its window-major layout
        (one index gather per layout change), and undo both."""
        B, L, C = x.shape
        H = W = math.isqrt(L)
        ws = self.window_size
        Hp, Wp = wops.pad_to_window_multiple(H, W, ws)
        padded = (Hp, Wp) != (H, W)
        if padded:
            x = F.pad(x.reshape(B, H, W, C), (0, 0, 0, Wp - W, 0, Hp - H))
            x = x.reshape(B, Hp * Wp, C)
        dev = x.device
        cur = None                                   # current layout shift
        for blk in self.blocks:
            t = blk.shift_size
            if cur is None:
                x = wops.to_window_major(x, Hp, Wp, ws, t)
            elif cur != t:
                x = wops.transition_window_major(x, Hp, Wp, ws, cur, t)
            cur = t
            wm = {
                "shift": (H, W, t) if t > 0 else None,
                "pad_mask": (wops.device_table(wops.pad_token_mask,
                                               (H, W, Hp, Wp, ws, t), dev)
                             if padded else None),
                "n_windows": (Hp // ws) * (Wp // ws),
            }
            x = run_block(blk, x, wm)
        x = wops.from_window_major(x, Hp, Wp, ws, cur)
        if padded:
            x = x.reshape(B, Hp, Wp, C)[:, :H, :W, :].reshape(B, L, C)
        return x


class SwinTransformer(nn.Module):
    """Hierarchical backbone (ref: models/swin_transformer.py:576-943).
    ``forward_features`` returns ``(cls, region)``: the avg-pooled feature
    and the final normed token map (swin_transformer.py:678-694)."""

    def __init__(self, cfg: SwinConfig, dtype=torch.float32, generator=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.patch_embed = PatchEmbed(c.patch_size, c.in_chans, c.embed_dim,
                                      c.patch_norm, c.norm_eps, dtype,
                                      generator)
        base_res = c.img_size // c.patch_size
        if c.ape:
            self.absolute_pos_embed = nn.Parameter(trunc_normal_(
                torch.empty(1, base_res * base_res, c.embed_dim),
                generator=generator))
        dpr = np.linspace(0, c.drop_path_rate, sum(c.depths))
        sub_fused = (c.subwindow_fused_stages
                     if c.subwindow_fused_stages is not None
                     else c.fused_block_stages)
        nstages = len(c.depths)
        stages = []
        for i in range(nstages):
            res = base_res // (2 ** i)
            eff_ws = min(c.window_size, res)
            lo, hi = sum(c.depths[:i]), sum(c.depths[:i + 1])
            stages.append(SwinStage(
                int(c.embed_dim * 2 ** i), c.depths[i], c.num_heads[i],
                eff_ws, res > eff_ws, c.mlp_ratio, c.qkv_bias, c.qk_scale,
                tuple(float(d) for d in dpr[lo:hi]), c.norm_eps,
                i < nstages - 1, c.attention_impl, c.subwindow_opt, dtype,
                generator, fused=i in c.fused_block_stages,
                subwindow_fused=i in sub_fused, drop=c.drop_rate,
                attn_drop=c.attn_drop_rate, remat=c.remat))
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNorm(c.num_features, c.norm_eps, dtype)
        self.pos_drop = Dropout(c.drop_rate)

    def _embed(self, x, deterministic=True, generator=None):
        x = self.patch_embed(x)
        if self.cfg.ape:
            x = x + self.absolute_pos_embed.to(x.dtype)
        return self.pos_drop(x, deterministic, generator)

    def forward_features(self, x, deterministic=True, generator=None,
                         bn_train=False):
        del bn_train                    # no BatchNorm
        x = self._embed(x, deterministic, generator)
        for stage in self.layers:
            x = stage(x, deterministic, generator, self.cfg.layout_opt)
        region = self.norm(x)                                # (B, L, C)
        return region.mean(dim=1), region

    def forward_selfattention(self, x, n: int = 1, deterministic=True,
                              generator=None):
        """n=1: the last block's attention probabilities (B*nW, nH, N, N);
        otherwise every block's, in order (ref: swin_transformer.py:
        766-796; esvit_tpu/models/swin.py:962-973)."""
        x = self._embed(x, deterministic, generator)
        attns = []
        for i, stage in enumerate(self.layers):
            if n != 1 or i == len(self.layers) - 1:
                x, aux = stage(x, deterministic, generator, capture="attention")
                attns.extend(aux)
            else:
                x = stage(x, deterministic, generator, self.cfg.layout_opt)
        return attns[-1] if n == 1 else attns

    def forward_return_n_last_blocks(self, x, n: int = 4, deterministic=True,
                                     generator=None):
        """Concat of the avg-pooled outputs of the n last blocks across
        stages, the final stage's through the last norm (ref:
        swin_transformer.py:799-837; esvit_tpu/models/swin.py:975-995).
        Every stage runs its classic block loop."""
        start = sum(self.cfg.depths) - n
        out, blk_id = [], 0
        x = self._embed(x, deterministic, generator)
        for i, stage in enumerate(self.layers):
            x, feats = stage(x, deterministic, generator, capture="features")
            for f in feats:
                if blk_id >= start:
                    if i == len(self.layers) - 1:
                        f = self.norm(f)
                    out.append(f.mean(dim=1))
                blk_id += 1
        return torch.cat(out, dim=-1)

    def _stage_routes(self, img_size: int, from_stage: int = 0):
        """(stage, tokens, route) for an img_size input, by the forward's
        rule, from stage ``from_stage`` on."""
        H = img_size // self.cfg.patch_size
        for i, stage in enumerate(self.layers):
            if i >= from_stage:
                yield stage, H * H, stage.route(H * H, self.cfg.layout_opt)
            if stage.downsample is not None:
                H = (H + 1) // 2

    def _attention_calls(self, img_size: int, capture: bool,
                         from_stage: int = 0) -> int:
        """Kernel launches of the WindowAttention route in one forward of
        an img_size input: every block of a stage on the window-major
        route, or on the classic route (every stage's, when capturing
        features) where the block does not take its sub-window path, and
        whose kernel takes the stage's windows
        (WindowAttention.kernel_takes)."""
        calls = 0
        for stage, L, route in self._stage_routes(img_size, from_stage):
            blk = stage.blocks[0] if len(stage.blocks) else None
            if blk is None or not blk.attn.kernel_takes(
                    stage.window_size ** 2, stage.dim):
                continue
            if route == "window_major" or (
                    (capture or route == "classic")
                    and not blk.takes_subwindow(L)):
                calls += len(stage.blocks)
        return calls

    def window_attention_calls(self, img_size: int, capture: bool = False,
                               from_stage: int = 0) -> int:
        """Launches of the window-attention kernel pair's forward in one
        forward of an img_size input on the card (its calls under
        attention_impl='packed'): ``forward_features``, or with ``capture``
        ``forward_return_n_last_blocks``; ``from_stage`` counts the stages
        from it on (a backward stops at stages whose parameters and input
        all are frozen)."""
        if self.cfg.attention_impl != "packed":
            return 0
        return self._attention_calls(img_size, capture, from_stage)

    def pallas_window_attention_calls(self, img_size: int,
                                      capture: bool = False,
                                      from_stage: int = 0) -> int:
        """Launches of the forward-only qkv-layout kernel in one forward of
        an img_size input on the card (its calls under
        attention_impl='pallas'): ``forward_features``, or with ``capture``
        ``forward_return_n_last_blocks``; ``from_stage`` as above."""
        if self.cfg.attention_impl != "pallas":
            return 0
        return self._attention_calls(img_size, capture, from_stage)

    def fused_block_calls(self, img_size: int, from_stage: int = 0) -> int:
        """Fused-block calls in one forward of an img_size input: every
        block of a stage on a fused route (each is a kernel launch on the
        card); ``from_stage`` as above."""
        return sum(len(stage.blocks)
                   for stage, _, route in self._stage_routes(img_size,
                                                             from_stage)
                   if route in ("fused", "fused_subwindow"))

    def frozen_stages(self, frozen: dict[str, bool]) -> int:
        """How many leading stages a backward never reaches: those whose
        parameters, and all before them (the patch embedding), are frozen
        (``frozen`` maps parameter names to train/optim.py's freeze
        mask)."""
        def all_frozen(prefix):
            names = [n for n in frozen if n.startswith(prefix)]
            return all(frozen[n] for n in names)
        if not (all_frozen("patch_embed.") and all_frozen("absolute_pos")):
            return 0
        k = 0
        while k < len(self.layers) and all_frozen(f"layers.{k}."):
            k += 1
        return k


def build_swin(cfg: SwinConfig, dtype=torch.float32, generator=None):
    return SwinTransformer(cfg, dtype=dtype, generator=generator)
