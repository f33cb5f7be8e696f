"""Tokens-to-Token (T2T) encoding (port of esvit_tpu/models/t2t.py; ref:
layers/t2t.py).

Used by the reference's ``experiments/imagenet/vit/deit/t2t`` configs,
never by the EsViT main path. The 'transformer' tokens type:
unfold(7, s4, p2) -> TokenTransformer -> unfold(3, s2, p1) ->
TokenTransformer -> unfold(3, s2, p1) -> linear projection. The
reference's ``Token_transformer.forward`` ends in a debug ``sys.exit``
(t2t.py:174-176); esvit_tpu leaves it out, and so does this module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from esvit_tpu_torch.models.common import Dense, Dropout, LayerNorm, Mlp


def unfold(x: torch.Tensor, kernel: int, stride: int, padding: int
           ) -> torch.Tensor:
    """``torch.nn.Unfold`` of channels-last input: (B, H, W, C) ->
    (B, L, C*k*k), each patch in torch's (c, kh, kw) order."""
    return F.unfold(x.permute(0, 3, 1, 2), kernel, padding=padding,
                    stride=stride).transpose(1, 2)


class T2TAttention(nn.Module):
    """T2T attention with the v-residual skip (ref t2t.py:30-65): scale
    ``in_dim ** -0.5``, fp32 scores and softmax, ``v + proj(out)``. Only
    ``num_heads == 1`` is consistent in the reference (each "head" carries
    the full in_dim)."""

    def __init__(self, dim: int, in_dim: int, num_heads: int = 1,
                 qkv_bias: bool = False, qk_scale: float | None = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if num_heads != 1:
            raise ValueError("T2TAttention supports num_heads=1")
        self.in_dim, self.dtype = in_dim, dtype
        self.scale = qk_scale or in_dim ** -0.5
        self.qkv = Dense(dim, 3 * in_dim, bias=qkv_bias, dtype=dtype,
                         generator=generator)
        self.proj = Dense(in_dim, in_dim, dtype=dtype, generator=generator)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q, k, v = self.qkv(x).unflatten(-1, (3, self.in_dim)).unbind(2)
        scores = q.float() @ k.float().transpose(1, 2) * self.scale
        probs = self.attn_drop(torch.softmax(scores, dim=-1), deterministic,
                               generator)
        out = self.proj(probs.to(self.dtype) @ v)
        return v + self.proj_drop(out, deterministic, generator)


class TokenTransformer(nn.Module):
    """norm1 -> T2TAttention -> + mlp(norm2) (ref Token_transformer),
    LayerNorm eps 1e-5, the erf GELU."""

    def __init__(self, dim: int, in_dim: int, num_heads: int = 1,
                 mlp_ratio: float = 1.0, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, dtype)
        self.attn = T2TAttention(dim, in_dim, num_heads, dtype=dtype,
                                 generator=generator)
        self.norm2 = LayerNorm(in_dim, norm_eps, dtype)
        self.mlp = Mlp(in_dim, int(in_dim * mlp_ratio), dtype, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.attn(self.norm1(x), deterministic, generator)
        return x + self.mlp(self.norm2(x), deterministic, generator)


class T2TModule(nn.Module):
    """The 'transformer' tokens-type T2T encoding (ref T2T_module and its
    forward_transformer, :188-215, :310-335): (B, H, W, in_chans) ->
    (B, (H/16)*(W/16), embed_dim)."""

    def __init__(self, embed_dim: int = 768, token_dim: int = 64,
                 num_heads: int = 1, mlp_ratio: float = 1.0,
                 in_chans: int = 3, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.attention1 = TokenTransformer(in_chans * 7 * 7, token_dim,
                                           num_heads, mlp_ratio, dtype=dtype,
                                           generator=generator)
        self.attention2 = TokenTransformer(token_dim * 3 * 3, token_dim,
                                           num_heads, mlp_ratio, dtype=dtype,
                                           generator=generator)
        self.project = Dense(token_dim * 3 * 3, embed_dim, dtype=dtype,
                             generator=generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        def refold(t):                      # tokens back to a grid, unfolded
            s = math.isqrt(t.shape[1])
            return unfold(t.reshape(t.shape[0], s, s, -1), 3, 2, 1)

        x = self.attention1(unfold(x, 7, 4, 2), deterministic, generator)
        x = self.attention2(refold(x), deterministic, generator)
        return self.project(refold(x))
