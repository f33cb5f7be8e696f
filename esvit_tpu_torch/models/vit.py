"""Monolithic ViT/DeiT backbone in PyTorch (port of esvit_tpu/models/vit.py;
ref: models/vision_transformer.py:124-381).

A CLS token and a learned position embedding, resampled for other crop
sizes by ops/resample.py ``torch_interpolate_scale`` with scale
sqrt(npatch / N) (esvit_tpu/models/vit.py:116-132: 14 -> 6 at 96 px);
full multi-head attention with fp32 scores and softmax, plain PyTorch as
it is plain XLA in esvit_tpu. ``forward_features`` returns
``(cls_token, patch_tokens)``, the EsViT dense contract (ref :248-251).

Names are the reference's: ``patch_embed.proj``, ``blocks.{i}.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``norm``, ``cls_token``,
``pos_embed``. Dropout as esvit_tpu's (``drop_rate`` after the position
embedding, the attention projection and each MLP layer, ``attn_drop_rate``
on the probabilities), drawn from the step's generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from esvit_tpu_torch.config import ViTConfig
from esvit_tpu_torch.models.common import (Dense, DropPath, Dropout,
                                           LayerNorm, Mlp, PatchConv,
                                           softmax_fp32, trunc_normal_)
from esvit_tpu_torch.ops.resample import torch_interpolate_scale


class Attention(nn.Module):
    """Full MHA (ref: vision_transformer.py:71-95); returns the output and
    the fp32 attention probabilities."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: float | None = None, dtype=torch.float32,
                 generator=None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.num_heads = num_heads
        self.dtype = dtype
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)

    def forward(self, x, deterministic=True, generator=None):
        B, N, C = x.shape
        nH = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # (B, nH, N, hd)
        attn = torch.matmul((q * self.scale).float(),
                            k.float().transpose(-1, -2))
        probs = softmax_fp32(attn)
        kept = self.attn_drop(probs, deterministic, generator)
        out = torch.matmul(kept.to(self.dtype), v)
        out = self.proj(out.transpose(1, 2).reshape(B, N, C))
        return self.proj_drop(out, deterministic, generator), probs


class Block(nn.Module):

    def __init__(self, c: ViTConfig, drop_path: float, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.norm1 = LayerNorm(c.embed_dim, c.norm_eps, dtype)
        self.attn = Attention(c.embed_dim, c.num_heads, c.qkv_bias,
                              c.qk_scale, dtype, generator, c.attn_drop_rate,
                              c.drop_rate)
        self.norm2 = LayerNorm(c.embed_dim, c.norm_eps, dtype)
        self.mlp = Mlp(c.embed_dim, int(c.embed_dim * c.mlp_ratio), dtype,
                       generator, c.drop_rate)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, deterministic=True, generator=None):
        y, attn = self.attn(self.norm1(x), deterministic, generator)
        x = x + self.drop_path(y, deterministic, generator)
        y = self.mlp(self.norm2(x), deterministic, generator)
        return x + self.drop_path(y, deterministic, generator), attn


class PatchEmbed(nn.Module):
    def __init__(self, c: ViTConfig, dtype=torch.float32, generator=None):
        super().__init__()
        self.proj = PatchConv(c.in_chans, c.embed_dim, c.patch_size, dtype,
                              generator)

    def forward(self, x):
        x = self.proj(x)                                  # (B, Hp, Wp, C)
        return x.reshape(x.shape[0], -1, x.shape[-1])


class VisionTransformer(nn.Module):

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, generator=None):
        super().__init__()
        c = self.cfg = cfg
        n = (c.img_size // c.patch_size) ** 2
        self.patch_embed = PatchEmbed(c, dtype, generator)
        self.cls_token = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, c.embed_dim), generator=generator))
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, n + 1, c.embed_dim), generator=generator))
        dpr = np.linspace(0, c.drop_path_rate, c.depth)
        self.blocks = nn.ModuleList(
            Block(c, float(dpr[i]), dtype, generator) for i in range(c.depth))
        self.norm = LayerNorm(c.embed_dim, c.norm_eps, dtype)
        self.pos_drop = Dropout(c.drop_rate)

    def _pos_embed_for(self, npatch: int) -> torch.Tensor:
        """The position embedding of an ``npatch``-token grid: bicubic with
        torch's scale_factor semantics, scale sqrt(npatch / N), where the
        grid differs from the native one (ref :271-285)."""
        pe = self.pos_embed
        n = pe.shape[1] - 1
        if npatch == n:
            return pe
        s_old = math.isqrt(n)
        grid = torch_interpolate_scale(pe[:, 1:].reshape(1, s_old, s_old, -1),
                                       math.sqrt(npatch / n))
        flat = grid.reshape(1, -1, grid.shape[-1])
        if flat.shape[1] != npatch:
            raise AssertionError(f"pos-embed resample gave {flat.shape[1]} "
                                 f"tokens for {npatch}")
        return torch.cat([pe[:, :1], flat], dim=1)

    def _embed(self, x, deterministic=True, generator=None):
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self._pos_embed_for(x.shape[1] - 1).to(x.dtype)
        return self.pos_drop(x, deterministic, generator)

    def forward_features(self, x, deterministic=True, generator=None,
                         bn_train=False):
        """(cls, patch tokens) after the final norm; ``bn_train`` is
        ignored (no BatchNorm)."""
        x = self._embed(x, deterministic, generator)
        for blk in self.blocks:
            x, _ = blk(x, deterministic, generator)
        x = self.norm(x)
        return x[:, 0], x[:, 1:]

    def forward_selfattention(self, x, n: int = 1, deterministic=True,
                              generator=None):
        """n=1: the last block's attention probabilities (B, nH, N, N);
        otherwise every block's, in order."""
        x = self._embed(x, deterministic, generator)
        attns = []
        for blk in self.blocks:
            x, attn = blk(x, deterministic, generator)
            attns.append(attn)
        return attns[-1] if n == 1 else attns

    def forward_return_n_last_blocks(self, x, n: int = 4, avgpool=False,
                                     deterministic=True, generator=None):
        """Concat of the n last blocks' normed CLS tokens, and with
        ``avgpool`` the mean of the last block's normed patch tokens (ref
        :339-360)."""
        x = self._embed(x, deterministic, generator)
        out = []
        depth = len(self.blocks)
        for i, blk in enumerate(self.blocks):
            x, _ = blk(x, deterministic, generator)
            if i >= depth - n:
                out.append(self.norm(x)[:, 0])
        if avgpool:
            out.append(self.norm(x)[:, 1:].mean(dim=1))
        return torch.cat(out, dim=-1)


def build_vit(cfg: ViTConfig, dtype=torch.float32, generator=None):
    return VisionTransformer(cfg, dtype=dtype, generator=generator)
