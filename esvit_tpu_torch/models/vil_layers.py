"""Vision-Longformer sliding-chunk attention (port of
esvit_tpu/models/vil_layers.py ``Long2DSCAttention``, ref:
layers/longformer2d.py:11-330).

The canonical EsViT ViL configuration only: mode 0 (all 8 neighbour
chunks), blockwise zero padding (``exact=0``), no relative position bias,
no pooled keys, separate global projections. Local queries (the grid
tokens) attend to their 3 x 3 chunk neighbourhood and to the global
tokens in one softmax, through ops/sliding_chunk.py: the CUDA kernel pair
for tensors on the card when ``fused_sc='auto'`` and its shape rule takes
the shape, its plain version otherwise, and always while attention
dropout is active (not deterministic, ``attn_drop`` > 0;
esvit_tpu/models/vil_layers.py:149). The global rows run vanilla MHA
over all tokens with their own ``*_global`` projections. Performer,
Linformer, SRFormer and SE are not ported (ROADMAP queue 1 item 9b).
"""

from __future__ import annotations

import torch
from torch import nn

from esvit_tpu_torch.models.common import Dense, Dropout, softmax_fp32
from esvit_tpu_torch.ops import sliding_chunk as scops


class Long2DSCAttention(nn.Module):

    def __init__(self, dim: int, num_heads: int, window: int, nglo: int = 1,
                 qkv_bias: bool = True, qk_scale: float | None = None,
                 fused_sc: str = "auto", dtype=torch.float32, generator=None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.num_heads = num_heads
        self.window = window
        self.nglo = nglo
        self.fused_sc = fused_sc
        self.dtype = dtype
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.query = Dense(dim, dim, qkv_bias, dtype, generator)
        self.kv = Dense(dim, 2 * dim, qkv_bias, dtype, generator)
        self.proj = Dense(dim, dim, True, dtype, generator)
        if nglo >= 1:
            self.query_global = Dense(dim, dim, qkv_bias, dtype, generator)
            self.kv_global = Dense(dim, 2 * dim, qkv_bias, dtype, generator)
            self.proj_global = Dense(dim, dim, True, dtype, generator)

    def uses_kernel(self, dim: int, deterministic: bool = True) -> bool:
        """The route (vil_layers.py:145-151): the kernel wrapper whenever
        fused_sc is not 'off', attention dropout is not active and its
        shape rule takes the shape; it runs the CUDA kernels for tensors
        on the card."""
        return (self.fused_sc != "off"
                and not (self.attn_drop.rate > 0.0 and not deterministic)
                and scops.supports(self.window, dim // self.num_heads,
                                   self.nglo))

    def forward(self, x: torch.Tensor, nx: int, ny: int,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, C = x.shape
        H, G = self.num_heads, self.nglo
        M = C // H
        scale = torch.tensor(self.scale, dtype=self.dtype)

        q = (self.query(x[:, G:]) * scale).reshape(B, nx * ny, H, M)
        kv = self.kv(x).reshape(B, N, 2, H, M)
        grid = (B * H, nx, ny, M)
        q = q.permute(0, 2, 1, 3).reshape(grid)
        k, v = (kv[:, G:, i].permute(0, 2, 1, 3).reshape(grid) for i in (0, 1))
        kg, vg = (kv[:, :G, i].permute(0, 2, 1, 3).reshape(B * H, G, M)
                  for i in (0, 1))
        args = (q.contiguous(), k.contiguous(), v.contiguous(),
                kg.contiguous(), vg.contiguous())
        if self.uses_kernel(C, deterministic):
            x1 = scops.sliding_chunk_attention(*args, nx=nx, ny=ny,
                                               W=self.window)
        else:
            x1 = scops.sliding_chunk_attention_plain(
                *args, nx=nx, ny=ny, W=self.window,
                drop=lambda p: self.attn_drop(p, deterministic, generator))
        x1 = x1.reshape(B, H, nx * ny, M).permute(0, 2, 1, 3).reshape(
            B, nx * ny, C)
        x1 = self.proj_drop(self.proj(x1), deterministic, generator)
        if G == 0:
            return x1

        # Global rows: vanilla MHA over every token (vil_layers.py:296-312).
        qg = (self.query_global(x[:, :G]) * scale).reshape(B, G, H, M)
        kvg = self.kv_global(x).reshape(B, N, 2, H, M)
        attn0 = torch.einsum("bghm,bnhm->bhgn", qg.float(),
                             kvg[:, :, 0].float())
        probs0 = self.attn_drop(softmax_fp32(attn0), deterministic,
                                generator).to(self.dtype)
        x0 = torch.einsum("bhgn,bnhm->bghm", probs0, kvg[:, :, 1])
        x0 = self.proj_drop(self.proj_global(x0.reshape(B, G, C)),
                            deterministic, generator)
        return torch.cat([x0, x1], dim=1)
