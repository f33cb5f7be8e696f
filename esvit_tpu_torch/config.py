"""Configuration tree for the port: a torch mirror of esvit_tpu/config.py.

Same dataclasses, field names and defaults as the reference
(``esvit_tpu/config.py:49-412``) minus the TPU tuning knobs (packed_*,
fused_tw_mm / fused_hg_max / fused_g_step, fused_block_interpret,
sub-fp32 score storage and the subwindow_ratio crossover): the Hopper
kernels choose their own tiling, attention scores are always fp32, and a
single padded window always takes the sub-window route, as the
reference's default ratio of 1.0 has it. The routing knobs keep the
reference's defaults: Swin stages 0-2 run block-fused
(``fused_block_stages``), and a single-padded-window stage among them runs
the fused kernel on its augmented window (``subwindow_fused_stages=None``
follows ``fused_block_stages``).

The ViL (Vision Longformer) configs mirror ``esvit_tpu/config.py:233-279,
464-491`` with the reference arch-string parser
(``esvit_tpu/models/vil.py:47-59``). ``fused_sc`` keeps two of the
reference's values: 'auto' sends every sparse stage that the sliding-chunk
kernel's shape rule takes to it (ops/sliding_chunk.py, the CUDA kernel
for tensors on the card), 'off' runs the plain stacked-neighbourhood
version everywhere; the TPU's 'interpret' and 'on' are not ported.

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
    # 'pallas': the forward-only CUDA kernel on the qkv layout with a dense
    # bias + shift-mask operand (ops/pallas_window_attention.py; backward
    # by autograd of its plain version). 'xla': the plain torch path. All
    # are explicit; none falls back.
    attention_impl: str = "packed"
    # Window-major stage layout (ops/window.py): per-block pad/roll/
    # partition copies become one index gather per layout change.
    layout_opt: bool = True
    remat: str = "none"
    # Stages whose blocks each run as one call of the block-fused kernel
    # pair (ops/fused_block.py, csrc/fused_block.cu) where its shape rule
    # takes them; other stages run block by block. () disables.
    fused_block_stages: tuple[int, ...] = (0, 1, 2)
    # Virtual-pad-column path for single-padded-window shapes
    # (SwinBlock._subwindow).
    subwindow_opt: bool = True
    # Stages whose single-padded-window shapes run the fused kernel on the
    # augmented window (H*W real tokens + 1 virtual pad token,
    # SwinStage._forward_fused_subwindow). None follows fused_block_stages.
    subwindow_fused_stages: tuple[int, ...] | None = None
    name: str = "swin"

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


@dataclass(frozen=True)
class ViLStageConfig:
    """One Vision-Longformer stage, decoded from the reference arch string
    'l1,h3,d96,n2,s1,g1,p4,f7,a1' (ref: models/vision_longformer.py:474-482)."""

    num_heads: int = 3
    embed_dim: int = 96
    depth: int = 2
    is_sparse: bool = True          # s: sliding-chunk attention vs full
    num_global: int = 1             # g: global CLS tokens
    patch_size: int = 4             # p: downsample factor entering the stage
    window_size: int = 7            # f: chunk/window size
    ape: bool = False               # a: absolute (factorized x/y) pos embed


@dataclass(frozen=True)
class ViLConfig:
    """MsViT / Vision Longformer backbone spec (ref:
    models/vision_longformer.py)."""

    img_size: int = 224
    in_chans: int = 3
    stages: tuple[ViLStageConfig, ...] = ()
    attn_type: str = "longformer"   # longformer | full | performer | ...
    # Sliding-chunk neighbour sampling (ref longformer2d.py:135-155);
    # only mode 0 (all 8 neighbours) is ported.
    mode: int = 0
    per_layer_mode: bool = False
    # 'auto': sparse stages the kernel's shape rule takes go through
    # ops/sliding_chunk.py (the CUDA kernel for tensors on the card);
    # 'off': the plain stacked-neighbourhood version everywhere.
    fused_sc: str = "auto"
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    norm_eps: float = 1e-6
    name: str = "vil"

    @property
    def num_features(self) -> int:
        return self.stages[-1].embed_dim


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
    global_scale: tuple[float, float] = (0.4, 1.0)
    local_size: int = 96
    local_scale: tuple[float, float] = (0.05, 0.4)
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


def swin_small(window_size: int = 7, **kw) -> SwinConfig:
    return SwinConfig(embed_dim=96, depths=(2, 2, 18, 2),
                      num_heads=(3, 6, 12, 24), window_size=window_size, **kw)


def swin_base(window_size: int = 7, **kw) -> SwinConfig:
    return SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                      num_heads=(4, 8, 16, 32), window_size=window_size, **kw)


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


def parse_vil_arch(arch: str) -> tuple[ViLStageConfig, ...]:
    """'l1,h3,d96,n2,s1,g1,p4,f7,a1_l2,...' -> stage configs (ref
    vision_longformer.py:474-482; attributes left out take the reference's
    defaults)."""
    stages = []
    for layer in arch.split("_"):
        cfg = {"l": 1, "h": 3, "d": 192, "n": 1, "s": 1, "g": 1,
               "p": 2, "f": 7, "a": 1, "r": 0}
        for attr in layer.split(","):
            cfg[attr[0]] = int(attr[1:])
        stages.append(ViLStageConfig(
            num_heads=cfg["h"], embed_dim=cfg["d"], depth=cfg["n"],
            is_sparse=bool(cfg["s"]), num_global=cfg["g"],
            patch_size=cfg["p"], window_size=cfg["f"], ape=bool(cfg["a"])))
    return tuple(stages)


def vil_from_arch(arch: str, **kw) -> ViLConfig:
    """Build from the reference MSVIT.ARCH string."""
    return ViLConfig(stages=parse_vil_arch(arch), **kw)


VIL_TINY_ARCH = ("l1,h1,d48,n1,s1,g1,p4,f7_l2,h3,d96,n1,s1,g1,p2,f7_"
                 "l3,h3,d192,n9,s0,g1,p2,f7_l4,h6,d384,n1,s0,g0,p2,f7")
VIL_SMALL_ARCH = ("l1,h3,d96,n2,s1,g1,p4,f7_l2,h3,d192,n2,s1,g1,p2,f7_"
                  "l3,h6,d384,n8,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7")


def vil_tiny(**kw) -> ViLConfig:
    """experiments/imagenet/vil/vil_tiny/base.yaml MSVIT.ARCH."""
    return vil_from_arch(VIL_TINY_ARCH, **kw)


def vil_small(**kw) -> ViLConfig:
    """experiments/imagenet/vil/vil_small/base.yaml MSVIT.ARCH."""
    return vil_from_arch(VIL_SMALL_ARCH, **kw)


def vil_femto(**kw) -> ViLConfig:
    """Tiny CPU-testable ViL: a sparse stage and a full stage with global
    tokens, 32px native."""
    kw.setdefault("img_size", 32)
    return vil_from_arch("l1,h2,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s0,g1,p2,f2",
                         **kw)


def vil_tiny_multicrop(batch_size: int = 32, **kw) -> TrainConfig:
    """The ViL-T step bench.py's vil_tiny preset times: 2x224 + 8x96
    crops, DINO heads of 65536 outputs, DDINO, bf16, at the Swin cell's
    per-card batch (the reference's V+R recipe is 16 GPUs x 64)."""
    return TrainConfig(model=vil_tiny(), head=HeadConfig(),
                       loss=LossConfig(),
                       optim=OptimConfig(batch_size_per_device=batch_size),
                       steps_per_epoch=1251, dtype=torch.bfloat16, **kw)


PRESETS = {
    "swin_femto": swin_femto,
    "swin_tiny": swin_tiny,
    "swin_small": swin_small,
    "swin_base": swin_base,
    "vil_femto": vil_femto,
    "vil_tiny": vil_tiny,
    "vil_small": vil_small,
}
# The reference's other presets (esvit_tpu/config.py:505-518): families the
# port does not build yet.
_NOT_PORTED_PRESETS = ("cvt_femto", "cvt_tiny", "deit_tiny", "deit_small",
                       "vit_base")


def get_model_config(name: str, **kw):
    """The backbone config of a preset name (esvit_tpu/config.py:521)."""
    if name in _NOT_PORTED_PRESETS:
        _refuse(f"model preset {name!r}", "queue 1 item 11")
    if name not in PRESETS:
        raise ValueError(f"unknown model preset {name!r}; have "
                         f"{sorted(PRESETS)}")
    return PRESETS[name](**kw)


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def check_supported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for reference options the port lacks."""
    m = cfg.model
    name = getattr(m, "name", None)
    if name == "swin":
        if m.attention_impl not in ("packed", "pallas", "xla"):
            raise ValueError(f"unknown attention_impl {m.attention_impl!r}")
        if m.remat != "none":
            _refuse(f"remat={m.remat!r}", "queue 1 item 12")
    elif name == "vil":
        _check_vil(m)
    else:
        _refuse(f"backbone {getattr(m, 'name', m)!r}", "queue 1 item 11")
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


def _check_vil(m: ViLConfig) -> None:
    """The port runs the canonical EsViT ViL: mode 0, the longformer
    attention family, absolute position embeddings everywhere."""
    if m.mode != 0 or m.per_layer_mode:
        _refuse(f"ViL neighbour sampling (mode={m.mode}, per_layer_mode="
                f"{m.per_layer_mode})", "queue 1 item 9b")
    if m.attn_type not in ("longformer", "longformerhand", "longformerauto"):
        _refuse(f"ViL attn_type={m.attn_type!r}", "queue 1 item 9b")
    if not all(st.ape for st in m.stages):
        _refuse("ViL relative position bias (a stage with ape=False)",
                "queue 1 item 9b")
    if m.fused_sc not in ("auto", "off"):
        _refuse(f"fused_sc={m.fused_sc!r} (the port has 'auto' and 'off')",
                "queue 1 item 9b")
