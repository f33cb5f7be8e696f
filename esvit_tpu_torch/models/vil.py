"""Vision Longformer / MsViT backbone in PyTorch (port of
esvit_tpu/models/vil.py, ref: models/vision_longformer.py).

A multi-stage ViT configured by the reference arch string
(config.parse_vil_arch). Each stage is a patch embedding with global CLS
tokens and factorized x/y absolute position embeddings, then alternating
attention and MLP blocks: sliding-chunk attention (models/vil_layers.py)
in sparse stages, full attention otherwise. Stages chain through the
token grid, the previous stage's global tokens stripped; the final
LayerNorm follows, and the cls feature is global token 0, or the mean of
all tokens when the last stage has none.

Reference checkpoint names: stage i is ``layer{i+1}``, an indexed list
whose entry 0 is the patch embedding and entries 2j+1, 2j+2 block j's
attention and MLP blocks; the final norm is ``norm``.

Neighbour sampling (mode != 0), relative position biases and the other
attention types are refused by config.check_supported;
``forward_return_n_last_blocks`` waits for the evals (ROADMAP queue 1
items 9b and 10).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from esvit_tpu_torch.config import ViLConfig, ViLStageConfig
from esvit_tpu_torch.models.common import (Dense, DropPath, Dropout,
                                           LayerNorm, Mlp, PatchConv,
                                           softmax_fp32, trunc_normal_)
from esvit_tpu_torch.models.vil_layers import Long2DSCAttention
from esvit_tpu_torch.ops.resample import torch_interpolate_scale


class ViLPatchEmbed(nn.Module):
    """Patch embed + global CLS tokens + factorized x/y APE (ref
    vision_longformer.py:191-274). ``nx, ny`` is the construction-time
    grid the position tables are sized for."""

    def __init__(self, st: ViLStageConfig, in_chans: int, nx: int, ny: int,
                 norm_eps: float, dtype=torch.float32, generator=None,
                 drop: float = 0.0):
        super().__init__()
        self.drop = Dropout(drop)
        C, G = st.embed_dim, st.num_global
        self.nx, self.ny, self.nglo = nx, ny, G
        self.proj = PatchConv(in_chans, C, st.patch_size, dtype, generator)
        self.norm_embed = LayerNorm(C, norm_eps, dtype)

        def table(*shape):
            return nn.Parameter(trunc_normal_(torch.empty(*shape),
                                              generator=generator))

        if G >= 1:
            self.cls_token = table(1, G, C)
        self.cls_pos_embed = table(1, G, C)
        self.x_pos_embed = table(1, nx, C // 2)
        self.y_pos_embed = table(1, ny, C // 2)

    def position_table(self, nx: int, ny: int) -> torch.Tensor:
        """(1, nx*ny, C) fp32 grid position embedding for an nx x ny input.

        Reference quirk (vision_longformer.py:261-274): the resample
        trigger and scale count the global tokens, sqrt((nglo + nx*ny) /
        N0), so with nglo >= 1 the table is bicubic-resampled even at the
        native grid (esvit_tpu/models/vil.py:105-122)."""
        C = self.x_pos_embed.shape[-1] * 2
        n0x, n0y = self.nx, self.ny
        pe = torch.cat([self.x_pos_embed[:, :, None, :].expand(1, n0x, n0y, C // 2),
                        self.y_pos_embed[:, None, :, :].expand(1, n0x, n0y, C // 2)],
                       dim=-1)
        if self.nglo + nx * ny != n0x * n0y:
            pe = torch_interpolate_scale(
                pe, math.sqrt((self.nglo + nx * ny) / (n0x * n0y)))
        if pe.shape[1] * pe.shape[2] != nx * ny:
            raise AssertionError(f"APE resample produced {tuple(pe.shape[1:3])} "
                                 f"for a {nx}x{ny} grid")
        return pe.reshape(1, nx * ny, C)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None):
        x = self.proj(x)                                     # (B, nx, ny, C)
        B, nx, ny, C = x.shape
        x = self.norm_embed(x.reshape(B, nx * ny, C))
        pe = self.position_table(nx, ny)
        if self.nglo >= 1:
            x = torch.cat([self.cls_token.to(x.dtype).expand(B, -1, -1), x],
                          dim=1)
        x = x + torch.cat([self.cls_pos_embed, pe], dim=1).to(x.dtype)
        return self.drop(x, deterministic, generator), nx, ny


class ViLFullAttention(nn.Module):
    """Vanilla MHA over all tokens with fp32 scores and softmax (ref
    vision_longformer.py:38-131, the APE branch)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype=torch.float32, generator=None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.num_heads = num_heads
        self.dtype = dtype
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)

    def forward(self, x: torch.Tensor, nx: int, ny: int,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H)
        q = qkv[:, :, 0] * torch.tensor(self.scale, dtype=self.dtype)
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), qkv[:, :, 1].float())
        probs = self.attn_drop(softmax_fp32(attn), deterministic,
                               generator).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, qkv[:, :, 2])
        return self.proj_drop(self.proj(out.reshape(B, N, C)), deterministic,
                              generator)


class ViLAttnBlock(nn.Module):
    """norm -> attention -> drop-path residual (ref :295-379)."""

    def __init__(self, st: ViLStageConfig, cfg: ViLConfig, drop_path: float,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.norm = LayerNorm(st.embed_dim, cfg.norm_eps, dtype)
        if st.is_sparse:
            self.attn = Long2DSCAttention(
                st.embed_dim, st.num_heads, st.window_size, st.num_global,
                cfg.qkv_bias, fused_sc=cfg.fused_sc, dtype=dtype,
                generator=generator, attn_drop=cfg.attn_drop_rate,
                proj_drop=cfg.drop_rate)
        else:
            self.attn = ViLFullAttention(st.embed_dim, st.num_heads,
                                         cfg.qkv_bias, dtype, generator,
                                         cfg.attn_drop_rate, cfg.drop_rate)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, nx, ny, deterministic=True, generator=None):
        y = self.attn(self.norm(x), nx, ny, deterministic, generator)
        return x + self.drop_path(y, deterministic, generator)


class ViLMlpBlock(nn.Module):
    """norm -> MLP -> drop-path residual."""

    def __init__(self, dim: int, cfg: ViLConfig, drop_path: float,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.norm = LayerNorm(dim, cfg.norm_eps, dtype)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dtype, generator,
                       cfg.drop_rate)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, deterministic=True, generator=None):
        y = self.mlp(self.norm(x), deterministic, generator)
        return x + self.drop_path(y, deterministic, generator)


class MsViT(nn.Module):
    """``forward_features`` returns ``(cls, region)``: the cls feature and
    the final normed grid tokens (esvit_tpu/models/vil.py:320-328)."""

    def __init__(self, cfg: ViLConfig, dtype=torch.float32, generator=None):
        super().__init__()
        self.cfg = cfg
        dpr = np.linspace(0, cfg.drop_path_rate, sum(s.depth for s in cfg.stages))
        res, in_chans, acc = cfg.img_size, cfg.in_chans, 0
        for i, st in enumerate(cfg.stages):
            res //= st.patch_size
            layer = [ViLPatchEmbed(st, in_chans, res, res, cfg.norm_eps, dtype,
                                   generator, cfg.drop_rate)]
            for j in range(st.depth):
                rate = float(dpr[acc + j])
                layer += [ViLAttnBlock(st, cfg, rate, dtype, generator),
                          ViLMlpBlock(st.embed_dim, cfg, rate, dtype, generator)]
            self.add_module(f"layer{i + 1}", nn.ModuleList(layer))
            in_chans, acc = st.embed_dim, acc + st.depth
        self.norm = LayerNorm(cfg.num_features, cfg.norm_eps, dtype)

    def stages(self):
        return [getattr(self, f"layer{i + 1}") for i in range(len(self.cfg.stages))]

    def forward_features(self, x, deterministic=True, generator=None,
                         bn_train=False):
        del bn_train                    # no BatchNorm
        nx = ny = None
        for i, layer in enumerate(self.stages()):
            if i > 0:
                G = self.cfg.stages[i - 1].num_global
                x = x[:, G:].reshape(x.shape[0], nx, ny, -1)
            x, nx, ny = layer[0](x, deterministic, generator)
            for blk in layer[1:]:
                if isinstance(blk, ViLAttnBlock):
                    x = blk(x, nx, ny, deterministic, generator)
                else:
                    x = blk(x, deterministic, generator)
        x = self.norm(x)
        G = self.cfg.stages[-1].num_global
        return (x[:, 0] if G > 0 else x.mean(dim=1)), x[:, G:]

    def sliding_chunk_calls(self, img_size: int,
                            deterministic: bool = True) -> int:
        """Sliding-chunk kernel calls in one forward of an img_size input:
        every attention block of a sparse stage whose route is the kernel
        (each is a kernel launch on the card). The route depends on the
        stage's widths and, under attention dropout, on ``deterministic``
        alone, so every input size gives the same count."""
        del img_size
        return sum(1 for st, layer in zip(self.cfg.stages, self.stages())
                   for blk in layer[1::2]
                   if isinstance(blk.attn, Long2DSCAttention)
                   and blk.attn.uses_kernel(st.embed_dim, deterministic))


def build_vil(cfg: ViLConfig, dtype=torch.float32, generator=None):
    return MsViT(cfg, dtype=dtype, generator=generator)
