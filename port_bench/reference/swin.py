"""Plain float32 Swin Transformer, as EsViT's ``swin_transformer.py``
defines it (Liu et al. 2021; EsViT, Li et al. 2022).

Shifted windows with the -100 region mask computed on the padded grid,
the relative-position bias, zero padding after ``norm1`` to whole
windows, 2x2 patch merging (x0, x1, x2, x3 order) and a final LayerNorm.
Stochastic depth as timm's ``DropPath``: block k of n has the rate
``linspace(0, drop_path_rate, n)[k]``; a crop keeps a branch with
probability 1 - rate, scaled by 1 / (1 - rate). Its uniforms are an input
(``forward_features``'s ``draws``): without them the blocks keep every
branch, as in the teacher.
A stage whose construction-time resolution is at most the window takes
the resolution as its window and no shift (swin_transformer.py:206-210).
Inputs are NHWC crops; ``forward_features`` returns the average-pooled
feature and the normed token map. Parameter names and shapes are those
of EsViT's checkpoints. Every product goes through the module's
``prec`` (precision.py). No kernel, fusion or layout trick: each block
partitions, attends and reverses as the paper writes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.precision import FP32


class Linear(nn.Module):
    def __init__(self, din, dout, bias=True):
        super().__init__()
        self.prec = FP32
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.empty(dout)) if bias else None

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias,
                            self.eps)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def relative_position_index(ws: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws, device=device),
                                        torch.arange(ws, device=device),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]            # (N, N)


def shift_mask(Hp: int, Wp: int, ws: int, ss: int, device) -> torch.Tensor:
    """(nW, N, N): 0 within a shifted region, -100 across."""
    img = torch.zeros(Hp, Wp, device=device)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for w in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(Hp // ws, ws, Wp // ws, ws).permute(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def partition(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def reverse(windows, ws, H, W):
    C = windows.shape[-1]
    x = windows.reshape(-1, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim, ws, num_heads):
        super().__init__()
        self.prec = FP32
        self.ws, self.num_heads = ws, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, num_heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask):
        B_, N, C = x.shape
        nH = self.num_heads
        qkv = self.qkv(x).reshape(B_, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = self.prec.matmul(q, k.transpose(-2, -1))          # (B_,nH,N,N)
        idx = relative_position_index(self.ws, x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(N, N, nH)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nH, N, N)
                    + mask[None, :, None]).reshape(B_, nH, N, N)
        attn = torch.softmax(attn, dim=-1)
        out = self.prec.matmul(attn, v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


def drop_path_rates(m: dict) -> list[float]:
    """Each block's stochastic-depth rate, in block order."""
    return [float(r) for r in np.linspace(0, m["drop_path_rate"],
                                          sum(m["depths"]))]


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, ws, shift, mlp_ratio, eps, rate):
        super().__init__()
        self.ws, self.shift, self.rate = ws, shift, rate
        self.norm1 = LayerNorm(dim, eps)
        self.attn = WindowAttention(dim, ws, num_heads)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _drop(self, y, u):
        """The branch y of each crop kept where its uniform lies under
        1 - rate, and scaled by 1 / (1 - rate)."""
        if u is None or self.rate == 0.0:
            return y
        keep = (u < 1.0 - self.rate).float() / (1.0 - self.rate)
        return y * keep[:, None, None]

    def forward(self, x, H, W, u=None):
        """u: (2, B) uniforms for the attention and the MLP branch, or
        None."""
        B, L, C = x.shape
        ws, ss = self.ws, self.shift
        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        Hp, Wp = math.ceil(H / ws) * ws, math.ceil(W / ws) * ws
        x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
            mask = shift_mask(Hp, Wp, ws, ss, x.device)
        x = reverse(self.attn(partition(x, ws), mask), ws, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = x[:, :H, :W].reshape(B, L, C)
        x = shortcut + self._drop(x, None if u is None else u[0])
        return x + self._drop(self.mlp(self.norm2(x)),
                              None if u is None else u[1])


class PatchMerging(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H, W):
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(B, -1, 4 * C)
        return self.reduction(self.norm(x)), (H + 1) // 2, (W + 1) // 2


class PatchEmbed(nn.Module):
    def __init__(self, patch, in_chans, dim, eps):
        super().__init__()
        self.prec = FP32
        self.patch = patch
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(dim, in_chans, patch,
                                                    patch))
        self.proj.bias = nn.Parameter(torch.empty(dim))
        self.norm = LayerNorm(dim, eps)

    def forward(self, x):
        """(B, S, S, 3) NHWC -> (B, (S/p)^2, dim): the stride-p convolution
        as a product of each flattened (c, i, j) patch with the kernel."""
        B, H, W, Cin = x.shape
        p = self.patch
        x = x.reshape(B, H // p, p, W // p, p, Cin).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, (H // p) * (W // p), Cin * p * p)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return self.norm(self.prec.linear(x, w, self.proj.bias))


class SwinStage(nn.Module):
    def __init__(self, dim, depth, num_heads, ws, shift_on, mlp_ratio, eps,
                 downsample, rates):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, ws,
                      ws // 2 if (i % 2 == 1 and shift_on) else 0,
                      mlp_ratio, eps, rates[i]) for i in range(depth)])
        self.downsample = PatchMerging(dim, eps) if downsample else None

    def forward(self, x, H, W, draws=None):
        """draws: (depth, 2, B) uniforms of this stage's blocks, or None."""
        for i, blk in enumerate(self.blocks):
            x = blk(x, H, W, None if draws is None else draws[i])
        if self.downsample is not None:
            x, H, W = self.downsample(x, H, W)
        return x, H, W


class Swin(nn.Module):
    """The backbone of a configuration file's ``model`` group."""

    def __init__(self, m: dict):
        super().__init__()
        eps = m["norm_eps"]
        self.patch = m["patch_size"]
        self.patch_embed = PatchEmbed(m["patch_size"], m["in_chans"],
                                      m["embed_dim"], eps)
        res = m["img_size"] // m["patch_size"]
        n = len(m["depths"])
        rates = drop_path_rates(m)
        self.depths = m["depths"]
        stages = []
        for i in range(n):
            r = res // 2 ** i
            ws = min(m["window_size"], r)
            lo = sum(m["depths"][:i])
            stages.append(SwinStage(
                m["embed_dim"] * 2 ** i, m["depths"][i], m["num_heads"][i],
                ws, r > ws, m["mlp_ratio"], eps, i < n - 1,
                rates[lo:lo + m["depths"][i]]))
        self.layers = nn.ModuleList(stages)
        self.num_features = m["embed_dim"] * 2 ** (n - 1)
        self.norm = LayerNorm(self.num_features, eps)

    def forward_features(self, x, draws=None):
        """draws: (blocks, 2, B) stochastic-depth uniforms (inputs.py
        ``make_drop_draws``), or None for no stochastic depth."""
        H = W = x.shape[1] // self.patch
        x = self.patch_embed(x)
        parts = (draws.split(self.depths) if draws is not None
                 else [None] * len(self.layers))
        for stage, d in zip(self.layers, parts):
            x, H, W = stage(x, H, W, d)
        region = self.norm(x)
        return region.mean(dim=1), region


Backbone = Swin
