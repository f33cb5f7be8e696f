"""Vision Longformer / MsViT backbone in PyTorch (port of
esvit_tpu/models/vil.py, ref: models/vision_longformer.py).

A multi-stage ViT configured by the reference arch string
(config.parse_vil_arch). Each stage is a patch embedding with global CLS
tokens and, where the stage has ``a1``, factorized x/y absolute position
embeddings, then alternating attention and MLP blocks. A sparse stage's
attention is ``ViLConfig.attn_type``'s: sliding-chunk attention (the
longformer family), Performer, Linformer or SRFormer
(models/vil_layers.py); a dense stage runs full attention. A stage
without APE (``a0``) gives its attention relative position biases. Stages
chain through the token grid, the previous stage's global tokens
stripped; the final LayerNorm follows, and the cls feature is global
token 0, or the mean of all tokens when the last stage has none.

Neighbour sampling: ``forward_features(..., mode=)`` gives every
sliding-chunk layer the mode (0: all 8 neighbours; 1-8: the chunk and one
neighbour), or, with ``PER_LAYER_MODE``, each layer draws its own
neighbour in 1-8 from the forward's generator, as the reference does
(longformer2d.py:151).

Reference checkpoint names: stage i is ``layer{i+1}``, an indexed list
whose entry 0 is the patch embedding and entries 2j+1, 2j+2 block j's
attention and MLP blocks; the final norm is ``norm``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from esvit_tpu_torch.config import ViLConfig, ViLStageConfig
from esvit_tpu_torch.models.common import (Dense, DropPath, Dropout,
                                           LayerNorm, Mlp, PatchConv,
                                           softmax_fp32)
from esvit_tpu_torch.models.vil_layers import (LinformerAttention,
                                               Long2DSCAttention,
                                               PerformerAttention,
                                               SRAttention, param_table)
from esvit_tpu_torch.ops.resample import torch_interpolate_scale
from esvit_tpu_torch.ops.window import device_table, relative_position_index

# The mode that asks every sliding-chunk layer for its own neighbour draw.
PER_LAYER_MODE = 9
_LONGFORMER = ("longformer", "longformerhand", "longformerauto")


def draw_neighbour_mode(generator: torch.Generator | None) -> int:
    """One layer's neighbour mode under ``PER_LAYER_MODE``: uniform on
    1-8, drawn on the generator's device (a CUDA generator's draw costs
    the host a wait for the card)."""
    dev = generator.device if generator is not None else "cpu"
    return int(torch.randint(1, 9, (1,), generator=generator,
                             device=dev).item())


class ViLPatchEmbed(nn.Module):
    """Patch embed + global CLS tokens + factorized x/y APE where the
    stage has one (ref vision_longformer.py:191-274). ``nx, ny`` is the
    construction-time grid the position tables are sized for."""

    def __init__(self, st: ViLStageConfig, in_chans: int, nx: int, ny: int,
                 norm_eps: float, dtype=torch.float32, generator=None,
                 drop: float = 0.0):
        super().__init__()
        self.drop = Dropout(drop)
        C, G = st.embed_dim, st.num_global
        self.nx, self.ny, self.nglo, self.ape = nx, ny, G, st.ape
        self.proj = PatchConv(in_chans, C, st.patch_size, dtype, generator)
        self.norm_embed = LayerNorm(C, norm_eps, dtype)

        def table(*shape):
            return param_table(*shape, generator=generator)

        if G >= 1:
            self.cls_token = table(1, G, C)
        if st.ape:
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
        if self.nglo >= 1:
            x = torch.cat([self.cls_token.to(x.dtype).expand(B, -1, -1), x],
                          dim=1)
        if self.ape:
            pe = torch.cat([self.cls_pos_embed, self.position_table(nx, ny)],
                           dim=1)
            x = x + pe.to(x.dtype)
        return self.drop(x, deterministic, generator), nx, ny


class ViLFullAttention(nn.Module):
    """Vanilla MHA over all tokens with fp32 scores and softmax (ref
    vision_longformer.py:38-131). With ``rpe`` a Swin-like table over the
    construction grid ``wx x wy`` and the global tokens' ``g2l`` / ``g2g``
    biases; it runs at that grid only (esvit_tpu/models/vil.py:158-185)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype=torch.float32, generator=None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, rpe: bool = False, wx: int = 14,
                 wy: int = 14, nglo: int = 1):
        super().__init__()
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.num_heads = num_heads
        self.dtype = dtype
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)
        self.rpe, self.wx, self.wy, self.nglo = rpe, wx, wy, nglo
        if rpe:
            def table(*shape):
                return param_table(*shape, generator=generator)
            self.local_relative_position_bias_table = table(
                (2 * wx - 1) * (2 * wy - 1), num_heads)
            if nglo > 0:
                self.g2l_relative_position_bias = table(2, num_heads, nglo)
                self.g2g_relative_position_bias = table(num_heads, nglo, nglo)

    def _bias(self, N: int) -> torch.Tensor:
        """(H, N, N) relative position bias, global rows and columns
        included."""
        H, G = self.num_heads, self.nglo
        nloc = self.wx * self.wy
        if N - G != nloc:
            raise ValueError("ViL full-attention rpe only supports the "
                             f"native grid ({self.wx}x{self.wy}), got "
                             f"{N - G} tokens")
        table = self.local_relative_position_bias_table
        idx = device_table(relative_position_index, (self.wx, self.wy),
                           table.device).long()
        bias = table[idx.reshape(-1)].reshape(nloc, nloc, H).permute(2, 0, 1)
        if G == 0:
            return bias
        g2l, g2g = (self.g2l_relative_position_bias,
                    self.g2g_relative_position_bias)
        top = torch.cat([g2g, g2l[0][:, :, None].expand(H, G, nloc)], dim=-1)
        bottom = torch.cat([g2l[1][:, None, :].expand(H, nloc, G), bias],
                           dim=-1)
        return torch.cat([top, bottom], dim=1)

    def forward(self, x: torch.Tensor, nx: int, ny: int,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H)
        q = qkv[:, :, 0] * torch.tensor(self.scale, dtype=self.dtype)
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), qkv[:, :, 1].float())
        if self.rpe:
            attn = attn + self._bias(N)
        probs = self.attn_drop(softmax_fp32(attn), deterministic,
                               generator).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, qkv[:, :, 2])
        return self.proj_drop(self.proj(out.reshape(B, N, C)), deterministic,
                              generator)


class ViLAttnBlock(nn.Module):
    """norm -> attention -> drop-path residual (ref :295-379). A sparse
    stage's attention is ``cfg.attn_type``'s: Performer with window^2
    features, Linformer with 256 over the stage's construction sequence,
    SRFormer with reduction 2 (esvit_tpu/models/vil.py:194-246)."""

    def __init__(self, st: ViLStageConfig, cfg: ViLConfig, drop_path: float,
                 res: int, dtype=torch.float32, generator=None):
        super().__init__()
        self.norm = LayerNorm(st.embed_dim, cfg.norm_eps, dtype)
        common = dict(qkv_bias=cfg.qkv_bias, dtype=dtype, generator=generator,
                      proj_drop=cfg.drop_rate)
        D, H = st.embed_dim, st.num_heads
        if not st.is_sparse:
            self.attn = ViLFullAttention(
                D, H, attn_drop=cfg.attn_drop_rate, rpe=not st.ape, wx=res,
                wy=res, nglo=st.num_global, **common)
        elif cfg.attn_type in _LONGFORMER:
            self.attn = Long2DSCAttention(
                D, H, st.window_size, st.num_global, fused_sc=cfg.fused_sc,
                attn_drop=cfg.attn_drop_rate, rpe=not st.ape, **common)
        elif cfg.attn_type == "performer":
            self.attn = PerformerAttention(
                D, H, nb_features=st.window_size ** 2, **common)
        elif cfg.attn_type == "linformer":
            self.attn = LinformerAttention(
                D, res * res + st.num_global, num_feats=256, num_heads=H,
                attn_drop=cfg.attn_drop_rate, **common)
        elif cfg.attn_type == "srformer":
            self.attn = SRAttention(D, rratio=2, num_heads=H,
                                    attn_drop=cfg.attn_drop_rate, **common)
        else:
            raise ValueError(f"unknown attn_type {cfg.attn_type!r}")
        self.drop_path = DropPath(drop_path)

    def forward(self, x, nx, ny, deterministic=True, generator=None,
                mode: int = 0):
        y = self.norm(x)
        if isinstance(self.attn, Long2DSCAttention):
            if mode == PER_LAYER_MODE:
                mode = draw_neighbour_mode(generator)
            y = self.attn(y, nx, ny, deterministic, generator, mode=mode)
        else:
            y = self.attn(y, nx, ny, deterministic, generator)
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
                layer += [ViLAttnBlock(st, cfg, rate, res, dtype, generator),
                          ViLMlpBlock(st.embed_dim, cfg, rate, dtype, generator)]
            self.add_module(f"layer{i + 1}", nn.ModuleList(layer))
            in_chans, acc = st.embed_dim, acc + st.depth
        self.norm = LayerNorm(cfg.num_features, cfg.norm_eps, dtype)

    def stages(self):
        return [getattr(self, f"layer{i + 1}") for i in range(len(self.cfg.stages))]

    def _run(self, x, deterministic, generator, mode, capture=False):
        """The stages; with ``capture`` also every MLP block's output."""
        nx = ny = None
        feats = []
        for i, layer in enumerate(self.stages()):
            if i > 0:
                G = self.cfg.stages[i - 1].num_global
                x = x[:, G:].reshape(x.shape[0], nx, ny, -1)
            x, nx, ny = layer[0](x, deterministic, generator)
            for blk in layer[1:]:
                if isinstance(blk, ViLAttnBlock):
                    x = blk(x, nx, ny, deterministic, generator, mode)
                else:
                    x = blk(x, deterministic, generator)
                    if capture:
                        feats.append(x)
        return x, feats

    def forward_features(self, x, deterministic=True, generator=None,
                         bn_train=False, mode: int = 0):
        del bn_train                    # no BatchNorm
        x, _ = self._run(x, deterministic, generator, mode)
        x = self.norm(x)
        G = self.cfg.stages[-1].num_global
        return (x[:, 0] if G > 0 else x.mean(dim=1)), x[:, G:]

    def forward_return_n_last_blocks(self, x, n: int = 4,
                                     deterministic: bool = True):
        """The token means of the last ``n`` blocks' outputs, concatenated;
        the final norm applies to the last stage's blocks only
        (esvit_tpu/models/vil.py:330-341)."""
        depths = [s.depth for s in self.cfg.stages]
        _, feats = self._run(x, deterministic, None, 0, capture=True)
        last_stage = sum(depths) - depths[-1]
        return torch.cat([(self.norm(f) if i >= last_stage else f).mean(dim=1)
                          for i, f in enumerate(feats)
                          if i >= sum(depths) - n], dim=-1)

    def sliding_chunk_calls(self, img_size: int, deterministic: bool = True,
                            mode: int = 0) -> int:
        """Sliding-chunk kernel calls in one forward of an img_size input
        at neighbour mode ``mode``: every sliding-chunk attention block
        whose route is the kernel (each is a kernel launch on the card).
        The route depends on the layer's configuration, the mode (only 0
        takes the kernel) and, under attention dropout, on
        ``deterministic``, so every input size gives the same count."""
        del img_size
        return sum(1 for st, layer in zip(self.cfg.stages, self.stages())
                   for blk in layer[1::2]
                   if isinstance(blk.attn, Long2DSCAttention)
                   and blk.attn.uses_kernel(st.embed_dim, deterministic, mode))


def build_vil(cfg: ViLConfig, dtype=torch.float32, generator=None):
    return MsViT(cfg, dtype=dtype, generator=generator)
