"""The EsViT model in plain float32: a backbone, the DINO head on the
pooled feature and, for the region-level task, a second DINO head on
every region token (main_esvit.py:239-254).

The DINO head (DINO's vision_transformer.py:384-418): three linears with
exact GELUs (hidden 2048) to a 256-wide bottleneck, L2-normalised, then
a weight-normalised linear to ``out_dim`` without bias,
``g * v / ||v||`` per output row. Names follow EsViT's checkpoints: the
backbone's at the root, ``head.*`` and ``head_dense.*`` beside them.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.precision import FP32, Precision
from port_bench.reference.swin import Linear


class WeightNormLinear(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.prec = FP32
        self.weight_v = nn.Parameter(torch.empty(dout, din))
        self.weight_g = nn.Parameter(torch.empty(dout, 1))

    def forward(self, x):
        v = self.weight_v
        w = self.weight_g * v / torch.linalg.vector_norm(v, dim=1,
                                                         keepdim=True)
        return self.prec.linear(x, w)


class DINOHead(nn.Module):
    def __init__(self, h: dict, in_dim: int):
        super().__init__()
        if h["nlayers"] != 3:
            raise ValueError("the reference head has three linears")
        self.mlp = nn.Sequential(
            Linear(in_dim, h["hidden_dim"]), nn.GELU(),
            Linear(h["hidden_dim"], h["hidden_dim"]), nn.GELU(),
            Linear(h["hidden_dim"], h["bottleneck_dim"]))
        self.last_layer = WeightNormLinear(h["bottleneck_dim"], h["out_dim"])

    def forward(self, x):
        return self.last_layer(F.normalize(self.mlp(x), dim=-1, eps=1e-12))


class EsViT(nn.Module):
    """``forward(crops)``, crops a tuple of NHWC groups ``(v_r * b, S_r,
    S_r, 3)`` (view-major rows), gives per view: the view-level logits
    (b, K), and with the region task the region logits (b, n_v, K) and
    the region features (b, n_v, C)."""

    def __init__(self, config: dict, dense: bool):
        super().__init__()
        # the backbone of model kind k is reference/<k>.py's ``Backbone``
        kind = importlib.import_module(
            f"port_bench.reference.{config['model']['kind']}")
        backbone = kind.Backbone(config["model"])
        for name, child in backbone.named_children():
            self.add_module(name, child)
        self.__dict__["backbone"] = backbone
        self.dense = dense
        self.head = DINOHead(config["head"], backbone.num_features)
        if dense:
            self.head_dense = DINOHead(config["head"], backbone.num_features)

    def set_precision(self, prec: Precision) -> "EsViT":
        for m in self.modules():
            if hasattr(m, "prec"):
                m.prec = prec
        return self

    def forward(self, crops, b: int, draws=None):
        """draws: per crop group the backbone's stochastic-depth uniforms
        (blocks, 2, crops), or None."""
        cls, fea = [], []
        for i, x in enumerate(crops):
            c, f = self.backbone.forward_features(
                x, None if draws is None else draws[i])
            v = x.shape[0] // b
            cls += list(c.reshape(v, b, -1))
            fea += list(f.reshape(v, b, f.shape[1], f.shape[2]))
        logits = self.head(torch.cat(cls)).reshape(len(cls), b, -1)
        if not self.dense:
            return list(logits), None, None
        sizes = [f.shape[1] for f in fea]
        rows = torch.cat([f.reshape(b * f.shape[1], -1) for f in fea])
        region = self.head_dense(rows)
        region = [r.reshape(b, n, -1)
                  for r, n in zip(region.split([b * n for n in sizes]),
                                  sizes)]
        return list(logits), region, fea
