"""Composite EsViT model: backbone + DINO head + dense head
(port of esvit_tpu/models/esvit.py).

The reference attaches ``head`` and ``head_dense`` to the backbone
(main_esvit.py:239-254), so its checkpoints name backbone parameters at
the root (``layers.0.blocks.1.attn.qkv.weight``) beside ``head.*`` and
``head_dense.*``. This module registers the backbone's children at its own
root to keep exactly those names; ``self.backbone`` is the same backbone,
kept unregistered, for calling its forward.

Dense output contract (swin_transformer.py:734-751), ``crops`` being a
tuple of per-resolution batches ``(n_r*B, S_r, S_r, 3)``:
    cls_logits    (ncrops*B, K)
    region_logits (sum_r n_r*B*N_r, K), or (B, S, K) batch-major with
                  S = sum_r n_r*N_r when ``batch_size`` is given
    region_fea    the same layouts with C features
    npatch        tuple of N_r per resolution group
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from esvit_tpu_torch.config import HeadConfig
from esvit_tpu_torch.models.heads import DINOHead
from esvit_tpu_torch.models.registry import build_backbone


class EsViTModel(nn.Module):

    def __init__(self, backbone_cfg, head_cfg: HeadConfig,
                 use_dense_prediction: bool = True, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        backbone = build_backbone(backbone_cfg, dtype=dtype,
                                  generator=generator)
        for name, child in backbone.named_children():
            self.add_module(name, child)
        for name, param in backbone.named_parameters(recurse=False):
            self.register_parameter(name, param)
        self.__dict__["backbone"] = backbone
        self.use_dense_prediction = use_dense_prediction
        in_dim = backbone_cfg.num_features
        self.head = DINOHead(head_cfg, in_dim, dtype, generator)
        if use_dense_prediction:
            self.head_dense = DINOHead(head_cfg, in_dim, dtype, generator)

    def forward(self, crops: Sequence[torch.Tensor], deterministic=True,
                generator: torch.Generator | None = None,
                batch_size: int | None = None):
        cls_list, fea_list, npatch = [], [], []
        for x in crops:
            cls, fea = self.backbone.forward_features(x, deterministic,
                                                      generator)
            cls_list.append(cls)
            fea_list.append(fea)
            npatch.append(fea.shape[1])
        cls_logits = self.head(torch.cat(cls_list, dim=0))
        if not self.use_dense_prediction:
            return cls_logits
        if batch_size is None:
            fea_cat = torch.cat([f.reshape(-1, f.shape[-1]) for f in fea_list],
                                dim=0)
        else:
            # (v*B, N, C) -> (B, v*N, C) per resolution group, on the
            # C-wide features before the K-wide dense head.
            B = batch_size
            fea_cat = torch.cat(
                [f.reshape(-1, B, f.shape[1], f.shape[-1]).transpose(0, 1)
                  .reshape(B, -1, f.shape[-1]) for f in fea_list], dim=1)
        region_logits = self.head_dense(fea_cat)
        return cls_logits, region_logits, fea_cat, tuple(npatch)
