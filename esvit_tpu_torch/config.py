"""Configuration tree for the port: a torch mirror of esvit_tpu/config.py.

Same dataclasses, field names and defaults as the reference
(``esvit_tpu/config.py:49-412``) minus the TPU tiling knobs (packed_*,
fused_tw_mm / fused_hg_max / fused_g_step, fused_block_interpret and
sub-fp32 score storage): the Hopper kernels choose their own tiling, and
attention scores are always fp32.

Fields whose reference behaviour the port does not run yet keep their
names and are refused by :func:`check_supported`, which names the ROADMAP
item that ports them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class SwinConfig:
    """Swin backbone spec (ref: models/swin_transformer.py:601-646)."""

    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    ape: bool = False
    patch_norm: bool = True
    norm_eps: float = 1e-6
    # 'packed' (default): windowed attention through the hand-written CUDA
    # kernel pair (ops/window_attention.py) on every full-window call.
    # 'xla': the plain torch path. Both are explicit; neither falls back.
    attention_impl: str = "packed"
    # Window-major stage layout (ops/window.py): per-block pad/roll/
    # partition copies become one index gather per layout change.
    layout_opt: bool = True
    remat: str = "none"
    # Stages run through the block-fused kernel (esvit_tpu/ops/
    # fused_block.py). Not ported yet, so the port's default is ().
    fused_block_stages: tuple[int, ...] = ()
    # Virtual-pad-column path for single-padded-window shapes
    # (SwinBlock._subwindow).
    subwindow_opt: bool = True
    subwindow_fused_stages: tuple[int, ...] | None = None
    name: str = "swin"

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


@dataclass(frozen=True)
class HeadConfig:
    """DINO projection head (ref: models/vision_transformer.py:384-418)."""

    out_dim: int = 65536
    hidden_dim: int = 2048
    bottleneck_dim: int = 256
    nlayers: int = 3
    use_bn: bool = False
    norm_last_layer: bool = False


@dataclass(frozen=True)
class LossConfig:
    """DINO/DDINO loss knobs (ref: main_esvit.py:603-770)."""

    out_dim: int = 65536
    use_dense_prediction: bool = True
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.07
    warmup_teacher_temp_epochs: int = 30
    student_temp: float = 0.1
    center_momentum: float = 0.9
    streamed: bool = False


@dataclass(frozen=True)
class CropConfig:
    """Multi-crop geometry (ref: datasets/build.py:203-261)."""

    global_size: int = 224
    local_size: int = 96
    local_crops_number: int = 8

    @property
    def ncrops(self) -> int:
        return 2 + self.local_crops_number


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedules (ref: main_esvit.py:96-140, utils.py:161-173)."""

    optimizer: str = "adamw"
    lr: float = 5e-4                # scaled by total_batch/256 at runtime
    min_lr: float = 1e-6
    warmup_epochs: int = 10
    weight_decay: float = 0.04
    weight_decay_end: float = 0.4
    momentum_teacher: float = 0.996
    clip_grad: float = 3.0          # per-parameter norm clip; 0 disables
    freeze_last_layer_epochs: int = 1
    epochs: int = 300
    batch_size_per_device: int = 32
    frozen_layers: tuple = ()


@dataclass(frozen=True)
class TrainConfig:
    model: Any = field(default_factory=SwinConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    crops: CropConfig = field(default_factory=CropConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    seed: int = 0
    dtype: torch.dtype = torch.bfloat16   # compute dtype; params stay fp32
    steps_per_epoch: int = 1251
    output_dir: str = "./output"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def swin_tiny(window_size: int = 7, **kw) -> SwinConfig:
    """experiments/imagenet/swin/swin_tiny_patch4_window7_224.yaml"""
    return SwinConfig(embed_dim=96, depths=(2, 2, 6, 2),
                      num_heads=(3, 6, 12, 24), window_size=window_size, **kw)


def swin_femto(**kw) -> SwinConfig:
    """Tiny CPU-testable Swin: 2 stages, dim 16, 32px native."""
    kw.setdefault("img_size", 32)
    kw.setdefault("embed_dim", 16)
    kw.setdefault("depths", (2, 2))
    kw.setdefault("num_heads", (2, 2))
    kw.setdefault("window_size", 4)
    return SwinConfig(**kw)


def swin_tiny_multicrop(batch_size: int = 32, **kw) -> TrainConfig:
    """The step bench.py times: Swin-T W=7, 2x224 + 8x96 crops, DINO heads
    of 65536 outputs, DDINO, bf16, at the reference recipe's per-card
    batch (16 GPUs x 32, esvit README)."""
    return TrainConfig(model=swin_tiny(), head=HeadConfig(),
                       loss=LossConfig(),
                       optim=OptimConfig(batch_size_per_device=batch_size),
                       steps_per_epoch=1251, dtype=torch.bfloat16, **kw)


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def check_supported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for reference options the port lacks."""
    m = cfg.model
    if getattr(m, "name", None) != "swin":
        _refuse(f"backbone {getattr(m, 'name', m)!r}",
                "queue 1 items 9 and 11")
    if m.attention_impl not in ("packed", "xla"):
        _refuse(f"attention_impl={m.attention_impl!r}", "queue 2 item 7")
    if m.fused_block_stages or m.subwindow_fused_stages:
        _refuse("the block-fused Swin kernel", "queue 2 items 1-3")
    if m.remat != "none":
        _refuse(f"remat={m.remat!r}", "queue 1 item 12")
    if m.drop_rate or m.attn_drop_rate:
        _refuse("dropout inside the backbone", "queue 1 item 12")
    if cfg.head.use_bn:
        _refuse("BatchNorm in the DINO head", "queue 1 item 11")
    if cfg.loss.streamed:
        _refuse("the K-streamed loss", "queue 1 item 12")
    if cfg.optim.optimizer != "adamw":
        _refuse(f"optimizer={cfg.optim.optimizer!r}", "queue 1 item 11")
    if cfg.optim.frozen_layers:
        _refuse("frozen_layers", "queue 1 item 12")
