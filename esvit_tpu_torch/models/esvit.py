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

With ``bottleneck_outputs`` (the K-streamed loss, esvit_tpu/models/
esvit.py:55-107) the heads stop before their last layer: ``(cls_z,
region_z, region_fea, npatch, w_cls, w_dense)``, the L2-normalised
bottleneck features and the two heads' effective (K, D) last-layer
matrices, so no K-wide tensor is made here.

``head_shard = (index, count)`` builds both heads' last layers with that
slice of their rows (models/heads.py; the head's tensor parallelism,
parallel/mesh.py): every K above is then K / count, this rank's slice.
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
                 generator: torch.Generator | None = None,
                 head_shard: tuple[int, int] = (0, 1)):
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
        self.head = DINOHead(head_cfg, in_dim, dtype, generator, head_shard)
        if use_dense_prediction:
            self.head_dense = DINOHead(head_cfg, in_dim, dtype, generator,
                                       head_shard)

    def forward(self, crops: Sequence[torch.Tensor], deterministic=True,
                generator: torch.Generator | None = None,
                batch_size: int | None = None, bn_train: bool | None = None,
                bottleneck_outputs: bool = False, mode: int = 0):
        """bn_train: BatchNorm's mode in BN backbones (CvT, ResNet), by
        default ``not deterministic``; the teacher runs deterministic with
        True, as the reference's always-train-mode teacher does
        (esvit_tpu/models/esvit.py:53-80). Other backbones ignore it. A
        BatchNorm head follows ``deterministic`` instead (models/heads.py).
        bottleneck_outputs: the dense path's bottleneck form (above).
        mode: a ViL backbone's sliding-chunk neighbour mode
        (models/vil.py; other backbones take none). A crop group without
        images (no local crops) is skipped, where esvit_tpu forwards the
        empty batch: that changes no output, and lets a backbone whose
        sequence length is fixed (Linformer) train on the global crops
        alone."""
        if bn_train is None:
            bn_train = not deterministic
        extra = {"mode": mode} if self.backbone.cfg.name == "vil" else {}
        cls_list, fea_list, npatch = [], [], []
        for x in crops:
            if x.shape[0] == 0:
                continue
            cls, fea = self.backbone.forward_features(
                x, deterministic, generator, bn_train=bn_train, **extra)
            cls_list.append(cls)
            fea_list.append(fea)
            npatch.append(fea.shape[1])
        cls_cat = torch.cat(cls_list, dim=0)
        if bottleneck_outputs:
            if not self.use_dense_prediction:
                raise ValueError("bottleneck_outputs is the dense path's")
            cls_z = self.head.bottleneck(cls_cat, deterministic)
        else:
            cls_logits = self.head(cls_cat, deterministic)
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
        if bottleneck_outputs:
            return (cls_z, self.head_dense.bottleneck(fea_cat, deterministic),
                    fea_cat, tuple(npatch), self.head.last_weight(),
                    self.head_dense.last_weight())
        region_logits = self.head_dense(fea_cat, deterministic)
        return cls_logits, region_logits, fea_cat, tuple(npatch)
