"""CvT-v4 backbone in PyTorch (port of esvit_tpu/models/cvt.py; ref:
models/cvt_v4_transformer.py:434-707).

Each stage is an overlapping strided conv patch embedding (``ConvEmbed``)
and transformer blocks whose q/k/v projection is a depthwise conv,
BatchNorm and a pointwise conv (``DepthWiseConvQKV``), with windowed
attention over the stage's grid. Channels-last throughout; the k x k
convs run on an NCHW view of it (channels-last memory), the 1 x 1 convs
as products over the channels. Every conv takes its input and fp32
weight in the compute dtype, as flax's ``nn.Conv`` does. The window
attention is plain PyTorch, as it is plain XLA in esvit_tpu (no Pallas
kernel lies on this path).

The reference's quirks, kept exactly:
- the attention scale is ``dim ** -0.5`` over the full embed dim;
- QuickGELU (x * sigmoid(1.702 x)) and LayerNorm eps 1e-5;
- the window shrinks to ``min(w, H, W)``, but a shifted block's mask is
  built from the stage's window and applied with no cyclic roll;
- q/k/v are zero-padded to the window multiple after the projection, and
  the padded keys are not masked: they take part in the softmax with
  logit 0 and value 0;
- drop-path rates are a linspace over the total depth up to stage 0's
  rate; one DropPath is drawn twice per block, once for each residual.

BatchNorm (models/batchnorm.py) has its own ``bn_train`` flag beside
``deterministic``. Module and buffer names are the reference torch
model's: ``stage{i}.0`` the ConvEmbed, ``stage{i}.1.layers.{j}.0`` the
PreNorm attention (``norm``, ``fn.qkv.{dw,bn,pw}``, ``fn.proj_out``),
``stage{i}.1.layers.{j}.1`` the PreNorm feed-forward (``norm``,
``fn.net.{0,2}``), and ``norm``; the 1 x 1 convs keep their conv weights'
(out, in, 1, 1) shapes. So io/torch_checkpoint.py loads a released EsViT
CvT checkpoint strictly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esvit_tpu_torch.config import CvTConfig, CvTStageConfig
from esvit_tpu_torch.models.batchnorm import BatchNorm
from esvit_tpu_torch.models.common import (Conv, DropPath, LayerNorm,
                                           softmax_fp32)
from esvit_tpu_torch.ops import window as wops


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


class DepthWiseConvQKV(nn.Module):
    """depthwise conv -> BatchNorm -> pointwise conv (ref :75-105)."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int, padding: int,
                 bias: bool = True, dtype=torch.float32, generator=None):
        super().__init__()
        self.dw = Conv(dim_in, dim_in, kernel, 1, padding, groups=dim_in,
                       bias=False, dtype=dtype, generator=generator)
        self.bn = BatchNorm(dim_in)
        self.pw = Conv(dim_in, dim_out, bias=bias, dtype=dtype,
                       generator=generator)

    def forward(self, x, bn_train: bool):
        return self.pw(self.bn(self.dw(x), bn_train))


class CvTAttention(nn.Module):
    """Windowed attention with the conv q/k/v projection (ref :108-220)."""

    def __init__(self, st: CvTStageConfig, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dim, self.num_heads = st.embed_dim, st.num_heads
        self.window_size = st.window_size
        self.dtype = dtype
        self.qkv = DepthWiseConvQKV(st.embed_dim, 3 * st.embed_dim,
                                    st.kernel_qkv, st.padding_qkv,
                                    st.qkv_bias, dtype, generator)
        self.proj_out = Conv(st.embed_dim, st.embed_dim, dtype=dtype,
                             generator=generator)

    def forward(self, x, mask: torch.Tensor | None, bn_train: bool):
        B, H, W, C = x.shape
        h, dim = self.num_heads, self.dim
        scale = dim ** -0.5                  # the full dim (ref :126)
        w = min(self.window_size, H, W)
        qkv = self.qkv(x, bn_train)                        # (B, H, W, 3dim)
        Hp, Wp = wops.pad_to_window_multiple(H, W, w)
        if (Hp, Wp) != (H, W):
            # Zero rows and columns after the projection: the padded keys
            # are not masked (the reference's softmax sees them).
            qkv = F.pad(qkv, (0, 0, 0, Wp - W, 0, Hp - H))
        win = wops.window_partition(qkv, w)                # (Bw, N, 3dim)
        Bw, N, _ = win.shape
        win = win.reshape(Bw, N, 3, h, dim // h).permute(2, 0, 3, 1, 4)
        q, k, v = win[0], win[1], win[2]                   # (Bw, h, N, hd)
        dots = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        if mask is not None:
            nW = mask.shape[0]
            dots = (dots.reshape(Bw // nW, nW, h, N, N)
                    + mask[None, :, None]).reshape(Bw, h, N, N)
        probs = softmax_fp32(dots, out_dtype=self.dtype)
        out = torch.matmul(probs, v)
        out = out.transpose(1, 2).reshape(Bw, N, dim)
        out = wops.window_reverse(out, w, Hp, Wp)
        if (Hp, Wp) != (H, W):
            out = out[:, :H, :W, :]
        return self.proj_out(out)


class _PreNorm(nn.Module):
    """The reference's PreNorm(norm, fn): ``norm`` and ``fn`` by name."""

    def __init__(self, norm: nn.Module, fn: nn.Module):
        super().__init__()
        self.norm, self.fn = norm, fn


class CvTFeedForward(nn.Module):
    """1 x 1 conv -> QuickGELU -> 1 x 1 conv, as ``net.{0,1,2}``."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.net = nn.Sequential(
            Conv(dim, hidden, dtype=dtype, generator=generator), QuickGELU(),
            Conv(hidden, dim, dtype=dtype, generator=generator))

    def forward(self, x):
        return self.net(x)


class CvTBlock(nn.Module):
    """PreNorm(attn) + PreNorm(ff), one DropPath for both residuals (ref
    :262-286, :331-336); children ``0`` and ``1`` as the reference's."""

    def __init__(self, st: CvTStageConfig, drop_path: float, norm_eps: float,
                 shift: bool, dtype=torch.float32, generator=None):
        super().__init__()
        self.window_size, self.shift = st.window_size, shift
        self.add_module("0", _PreNorm(LayerNorm(st.embed_dim, norm_eps, dtype),
                                      CvTAttention(st, dtype, generator)))
        self.add_module("1", _PreNorm(
            LayerNorm(st.embed_dim, norm_eps, dtype),
            CvTFeedForward(st.embed_dim, int(st.embed_dim * st.mlp_ratio),
                           dtype, generator)))
        self.drop_path = DropPath(drop_path)

    def mask(self, H: int, W: int, device) -> torch.Tensor | None:
        """The shift mask, from the stage's window even where the window
        shrinks (build_attn_mask, ref :291-329); None unshifted."""
        if not (self.shift and self.window_size > 0):
            return None
        ss = self.window_size // 2
        if not 0 < ss < min(H, W):
            return None
        return wops.device_table(wops.shifted_window_mask,
                                 (H, W, self.window_size, ss), device)

    def forward(self, x, deterministic=True, generator=None, bn_train=False):
        B, H, W, C = x.shape
        attn, ff = getattr(self, "0"), getattr(self, "1")
        dp = self.drop_path
        y = attn.fn(attn.norm(x), self.mask(H, W, x.device), bn_train)
        x = dp(y, deterministic, generator) + x
        y = ff.fn(ff.norm(x))
        return dp(y, deterministic, generator) + x


class ConvEmbed(nn.Module):
    """Overlapping strided conv patch embedding + LayerNorm (ref
    :349-382)."""

    def __init__(self, st: CvTStageConfig, in_chans: int, norm_eps: float,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.proj = Conv(in_chans, st.embed_dim, st.patch_size,
                         st.patch_stride, st.patch_padding, dtype=dtype,
                         generator=generator)
        self.norm = LayerNorm(st.embed_dim, norm_eps, dtype)

    def forward(self, x):
        return self.norm(self.proj(x))


class _Blocks(nn.Module):
    """The reference's Transformer: its blocks as ``layers``."""

    def __init__(self, blocks):
        super().__init__()
        self.layers = nn.ModuleList(blocks)


class CvT(nn.Module):
    """``forward_features`` returns ``(cls, region)``: the mean of the
    final normed tokens and the tokens (esvit_tpu/models/cvt.py:220-226)."""

    def __init__(self, cfg: CvTConfig, dtype=torch.float32, generator=None):
        super().__init__()
        self.cfg = cfg
        total = sum(st.depth for st in cfg.stages)
        dpr = np.linspace(0, cfg.stages[0].drop_path_rate, total)
        in_chans, acc = cfg.in_chans, 0
        for i, st in enumerate(cfg.stages):
            blocks = [CvTBlock(st, float(dpr[acc + j]), cfg.norm_eps,
                               shift=st.shift and j % 2 == 1, dtype=dtype,
                               generator=generator)
                      for j in range(st.depth)]
            self.add_module(f"stage{i}", nn.ModuleList([
                ConvEmbed(st, in_chans, cfg.norm_eps, dtype, generator),
                _Blocks(blocks)]))
            in_chans, acc = st.embed_dim, acc + st.depth
        self.norm = LayerNorm(cfg.num_features, cfg.norm_eps, dtype)

    def _run(self, x, deterministic, generator, bn_train, capture=False):
        feats = []
        for i in range(len(self.cfg.stages)):
            embed, blocks = getattr(self, f"stage{i}")
            x = embed(x)
            for blk in blocks.layers:
                x = blk(x, deterministic, generator, bn_train)
                if capture:
                    feats.append(x)
        return x, feats

    def _final(self, x):
        B, H, W, C = x.shape
        return self.norm(x.reshape(B, H * W, C))

    def forward_features(self, x, deterministic=True, generator=None,
                         bn_train=False):
        x, _ = self._run(x, deterministic, generator, bn_train)
        region = self._final(x)
        return region.mean(dim=1), region

    def forward_return_n_last_blocks(self, x, n: int = 4, deterministic=True,
                                     generator=None, bn_train=False):
        """Concat of the n last blocks' mean features, the final stage's
        through the last norm (esvit_tpu/models/cvt.py:228-244)."""
        depths = [st.depth for st in self.cfg.stages]
        start, last_stage = sum(depths) - n, sum(depths[:-1])
        _, feats = self._run(x, deterministic, generator, bn_train,
                             capture=True)
        out = []
        for i, f in enumerate(feats):
            if i >= start:
                out.append(self._final(f).mean(dim=1) if i >= last_stage
                           else f.mean(dim=(1, 2)))
        return torch.cat(out, dim=-1)


def build_cvt(cfg: CvTConfig, dtype=torch.float32, generator=None):
    return CvT(cfg, dtype=dtype, generator=generator)
