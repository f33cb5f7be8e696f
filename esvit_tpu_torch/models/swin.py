"""Swin Transformer backbone in PyTorch (port of esvit_tpu/models/swin.py).

NHWC inputs, reference checkpoint names (``patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.qkv``, ``layers.{i}.downsample.reduction``,
``norm``), and the JAX package's stage routing with no block-fused stages:

- a stage whose tokens form one spatially padded window per image
  (Hp == Wp == ws > H) runs each block's virtual-pad-column math
  (``SwinBlock._subwindow``), in plain torch;
- every other stage runs window-major (``SwinStage._forward_window_major``,
  or the classic per-block partition with ``layout_opt=False``), and its
  windowed attention goes through ``ops/window_attention.py``: the CUDA
  kernel pair when ``attention_impl='packed'`` and the tensors are on the
  card, the plain torch version when ``attention_impl='xla'``.

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
from esvit_tpu_torch.models.common import (Dense, DropPath, LayerNorm, Mlp,
                                           softmax_fp32, trunc_normal_)
from esvit_tpu_torch.ops import window as wops
from esvit_tpu_torch.ops.window_attention import (window_attention,
                                                  window_attention_plain)


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


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA with relative position bias
    (ref: models/swin_transformer.py:72-152). Input ``(B_, N, C)`` windows;
    ``region`` is the (nW, N) int32 shift-region table or None."""

    def __init__(self, dim, window_size, num_heads, qkv_bias=True,
                 qk_scale=None, attention_impl="packed",
                 dtype=torch.float32, generator=None):
        super().__init__()
        ws = window_size
        self.window_size = ws
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attention_impl = attention_impl
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

    def forward(self, x, region=None):
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_ * N, 3 * C)
        q2, k2, v2 = (qkv[:, i * C:(i + 1) * C].contiguous() for i in range(3))
        use_kernel = (self.attention_impl == "packed"
                      and N == self.window_size ** 2)
        attend = window_attention if use_kernel else window_attention_plain
        out = attend(q2, k2, v2, self.rel_bias(), region, N, self.num_heads,
                     self.scale)
        return self.proj(out.reshape(B_, N, C))


class SwinBlock(nn.Module):
    """(S)W-MSA + MLP with pre-norm residuals
    (ref: models/swin_transformer.py:177-333)."""

    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio=4.0,
                 qkv_bias=True, qk_scale=None, drop_path=0.0, norm_eps=1e-6,
                 attention_impl="packed", subwindow_opt=True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.num_heads = num_heads
        self.subwindow_opt = subwindow_opt
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, norm_eps, dtype)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    qk_scale, attention_impl, dtype, generator)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, generator)

    def _ffn(self, x, deterministic, generator):
        y = self.mlp(self.norm2(x))
        return x + self.drop_path(y, deterministic, generator)

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
        out = attn_mod.proj(out.reshape(B, L, C))
        x = shortcut + self.drop_path(out, deterministic, generator)
        return self._ffn(x, deterministic, generator)

    def forward(self, x, deterministic=True, generator=None,
                window_major: dict | None = None):
        """Classic path: x is (B, H*W, C) spatial tokens. Window-major path
        (window_major = {'region', 'pad_mask', 'n_windows'}): x is already
        in this block's window-major layout."""
        B, L, C = x.shape
        ws, ss = self.window_size, self.shift_size
        if window_major is not None:
            shortcut = x
            y = self.norm1(x)
            if window_major["pad_mask"] is not None:
                y = y * window_major["pad_mask"].to(y.dtype)[None, :, None]
            windows = y.reshape(B * window_major["n_windows"], ws * ws, C)
            out = self.attn(windows, window_major["region"])
            x = shortcut + self.drop_path(out.reshape(B, L, C), deterministic,
                                          generator)
            return self._ffn(x, deterministic, generator)

        H = W = math.isqrt(L)
        if self.subwindow_opt and self.is_subwindow(L):
            return self._subwindow(x, H, W, deterministic, generator)

        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        Hp, Wp = wops.pad_to_window_multiple(H, W, ws)
        if (Hp, Wp) != (H, W):
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        region = None
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
            region = wops.device_table(wops.window_region_ids, (H, W, ws, ss),
                                       x.device)
        out = self.attn(wops.window_partition(x, ws), region)
        x = wops.window_reverse(out, ws, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = x[:, :H, :W, :].reshape(B, L, C)
        x = shortcut + self.drop_path(x, deterministic, generator)
        return self._ffn(x, deterministic, generator)


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
    514-547). The conv weight is stored OIHW; with stride == kernel the
    conv is one product of each flattened patch with the flattened kernel,
    computed in the compute dtype like flax ``nn.Conv``."""

    def __init__(self, patch_size, in_chans, embed_dim, patch_norm=True,
                 norm_eps=1e-6, dtype=torch.float32, generator=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(trunc_normal_(
            torch.empty(embed_dim, in_chans, patch_size, patch_size),
            generator=generator))
        self.proj.bias = nn.Parameter(torch.zeros(embed_dim))
        self.norm = (LayerNorm(embed_dim, norm_eps, dtype) if patch_norm
                     else None)

    def forward(self, x):
        B, H, W, Cin = x.shape                                   # NHWC
        ps = self.patch_size
        Hp, Wp = H // ps, W // ps
        x = x[:, :Hp * ps, :Wp * ps, :].reshape(B, Hp, ps, Wp, ps, Cin)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(B, Hp * Wp, Cin * ps * ps)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        x = F.linear(x.to(self.dtype), w.to(self.dtype))
        x = x + self.proj.bias.to(self.dtype)
        return self.norm(x) if self.norm is not None else x


class SwinStage(nn.Module):
    """Swin blocks + optional patch merging (ref: BasicLayer,
    models/swin_transformer.py:433-499)."""

    def __init__(self, dim, depth, num_heads, window_size, shift_enabled,
                 mlp_ratio, qkv_bias, qk_scale, drop_path, norm_eps,
                 downsample, attention_impl="packed", subwindow_opt=True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.window_size = window_size
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      window_size // 2 if (i % 2 == 1 and shift_enabled) else 0,
                      mlp_ratio, qkv_bias, qk_scale, drop_path[i], norm_eps,
                      attention_impl, subwindow_opt, dtype, generator)
            for i in range(depth)])
        self.downsample = (PatchMerging(dim, norm_eps, dtype, generator)
                           if downsample else None)

    def subwindow_ok(self, L: int) -> bool:
        """Whether an input of L tokens takes the virtual-pad-column
        block path (esvit_tpu SwinStage._subwindow_ok, no fused stages)."""
        blk = self.blocks[0]
        return blk.subwindow_opt and blk.is_subwindow(L)

    def forward(self, x, deterministic=True, generator=None, layout_opt=True):
        if layout_opt and len(self.blocks) > 0 and not self.subwindow_ok(x.shape[1]):
            x = self._forward_window_major(x, deterministic, generator)
        else:
            for blk in self.blocks:
                x = blk(x, deterministic, generator)
        return self.downsample(x) if self.downsample is not None else x

    def _forward_window_major(self, x, deterministic, generator):
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
                "region": (wops.device_table(wops.window_region_ids,
                                             (H, W, ws, t), dev)
                           if t > 0 else None),
                "pad_mask": (wops.device_table(wops.pad_token_mask,
                                               (H, W, Hp, Wp, ws, t), dev)
                             if padded else None),
                "n_windows": (Hp // ws) * (Wp // ws),
            }
            x = blk(x, deterministic, generator, wm)
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
                generator))
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNorm(c.num_features, c.norm_eps, dtype)

    def forward_features(self, x, deterministic=True, generator=None):
        x = self.patch_embed(x)
        if self.cfg.ape:
            x = x + self.absolute_pos_embed.to(x.dtype)
        for stage in self.layers:
            x = stage(x, deterministic, generator, self.cfg.layout_opt)
        region = self.norm(x)                                # (B, L, C)
        return region.mean(dim=1), region

    def window_attention_calls(self, img_size: int) -> int:
        """WindowAttention calls in one forward of an img_size input, by
        the same routing rule as the forward: every block of a stage that
        is not a sub-window stage (each is a kernel launch under
        attention_impl='packed' on the card)."""
        H = img_size // self.cfg.patch_size
        calls = 0
        for stage in self.layers:
            if not stage.subwindow_ok(H * H):
                calls += len(stage.blocks)
            if stage.downsample is not None:
                H = (H + 1) // 2
        return calls


def build_swin(cfg: SwinConfig, dtype=torch.float32, generator=None):
    return SwinTransformer(cfg, dtype=dtype, generator=generator)
