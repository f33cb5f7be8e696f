"""ResNet backbone in PyTorch (port of esvit_tpu/models/resnet.py; ref:
torchvision resnet + utils.py:560-665 ResNetWrapper).

torchvision's v1 layout: a 7x7/2 stem, a 3x3/2 max-pool with padding 1,
then bottleneck blocks (1x1, 3x3 carrying the stride, 1x1 to 4x the
width) with a downsample on block 0 of each layer. ``forward_features``
returns ``(mean of the final grid, the grid's tokens)``: at 224 px the
7 x 7 grid gives 49 region tokens, at 96 px 3 x 3 gives 9, as the
reference's ResNetWrapper hands ``forward_feature_map``'s grid to the
dense task.

Inputs are NHWC, as everywhere in the port. Each convolution is
models/common.py's ``Conv`` (a cuDNN call on the channels-last view, a
GEMM for the unstrided 1x1s), in the compute dtype as flax's
``nn.Conv(dtype=...)`` runs it; each BatchNorm is
models/batchnorm.py's (fp32, momentum 0.9, eps 1e-5, statistics global
over the process group) with ``bn_train`` apart from ``deterministic``,
as CvT has it. esvit_tpu runs these convolutions as plain XLA, so no TPU
kernel lies on this path; an fp32 run keeps cuDNN's TF32 off
(models/common.py ``exact_fp32_convolutions``).

Names are torchvision's, the ones the reference's ResNetWrapper
checkpoints carry: ``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}`` /
``bn{k}``, ``layer{i}.0.downsample.0`` (conv) / ``.1`` (BatchNorm).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from esvit_tpu_torch.config import ResNetConfig
from esvit_tpu_torch.models.batchnorm import BatchNorm
from esvit_tpu_torch.models.common import Conv

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_MOMENTUM = 0.9
# flax's he_normal draws a unit normal truncated to [-2, 2], whose std is
# this, and divides it out.
_TRUNC_STD = 0.87962566103423978


def conv(din: int, dout: int, kernel: int, stride: int = 1,
         dtype=torch.float32, generator=None) -> Conv:
    """esvit_tpu's ConvBN convolution: bias-free, padding kernel // 2,
    he-normal weights."""
    std = math.sqrt(2.0 / (din * kernel * kernel)) / _TRUNC_STD
    return Conv(din, dout, kernel, stride, kernel // 2, bias=False,
                dtype=dtype, generator=generator, std=std)


class Bottleneck(nn.Module):

    def __init__(self, din: int, width: int, stride: int, downsample: bool,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.conv1 = conv(din, width, 1, 1, dtype, generator)
        self.bn1 = BatchNorm(width, momentum=BN_MOMENTUM)
        self.conv2 = conv(width, width, 3, stride, dtype, generator)
        self.bn2 = BatchNorm(width, momentum=BN_MOMENTUM)
        self.conv3 = conv(width, 4 * width, 1, 1, dtype, generator)
        self.bn3 = BatchNorm(4 * width, momentum=BN_MOMENTUM)
        self.downsample = (nn.ModuleList([
            conv(din, 4 * width, 1, stride, dtype, generator),
            BatchNorm(4 * width, momentum=BN_MOMENTUM)])
            if downsample else None)

    def forward(self, x, bn_train: bool):
        y = F.relu(self.bn1(self.conv1(x), bn_train))
        y = F.relu(self.bn2(self.conv2(y), bn_train))
        y = self.bn3(self.conv3(y), bn_train)
        identity = x
        if self.downsample is not None:
            down_conv, down_bn = self.downsample
            identity = down_bn(down_conv(x), bn_train)
        return F.relu(y + identity.to(y.dtype))


class ResNet(nn.Module):

    def __init__(self, cfg: ResNetConfig, dtype=torch.float32, generator=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = conv(cfg.in_chans, 64, 7, 2, dtype, generator)
        self.bn1 = BatchNorm(64, momentum=BN_MOMENTUM)
        din = 64
        for i, depth in enumerate(DEPTHS[cfg.depth]):
            width = 64 * 2 ** i
            blocks = []
            for j in range(depth):
                blocks.append(Bottleneck(din, width,
                                         2 if (j == 0 and i > 0) else 1,
                                         j == 0, dtype, generator))
                din = 4 * width
            self.add_module(f"layer{i + 1}", nn.ModuleList(blocks))

    def layers(self):
        return [getattr(self, f"layer{i + 1}")
                for i in range(len(DEPTHS[self.cfg.depth]))]

    def feature_map(self, x, bn_train: bool = False) -> torch.Tensor:
        """(B, H/32, W/32, num_features) in the compute dtype."""
        x = F.relu(self.bn1(self.conv1(x), bn_train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for layer in self.layers():
            for blk in layer:
                x = blk(x, bn_train)
        return x

    def forward_features(self, x, deterministic=True, generator=None,
                         bn_train=False):
        """(mean of the grid tokens, grid tokens (B, H*W, C)); dropout and
        drop-path do not exist here, so ``deterministic`` and
        ``generator`` are unused."""
        del deterministic, generator
        fmap = self.feature_map(x, bn_train)
        B, H, W, C = fmap.shape
        region = fmap.reshape(B, H * W, C)
        return region.mean(dim=1), region

    def forward_return_n_last_blocks(self, x, n: int = 1, deterministic=True,
                                     generator=None, bn_train=False):
        """The pooled feature alone, whatever ``n``: the reference's linear
        eval takes ResNets through avgpool only (eval_linear.py:168-176;
        esvit_tpu/models/resnet.py:106-113)."""
        del n
        return self.forward_features(x, deterministic, generator,
                                     bn_train)[0]


def build_resnet(cfg: ResNetConfig, dtype=torch.float32, generator=None):
    return ResNet(cfg, dtype=dtype, generator=generator)
