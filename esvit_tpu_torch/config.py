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

The ViT/DeiT and CvT configs mirror ``esvit_tpu/config.py:175-230,
429-462`` with no field left out. The ViL (Vision Longformer) configs
mirror ``esvit_tpu/config.py:233-279, 464-491`` with the reference arch-string parser
(``esvit_tpu/models/vil.py:47-59``). ``fused_sc`` 'auto' (and 'on', which
takes the same route) sends every sliding-chunk layer that the kernel
takes (ops/sliding_chunk.py ``supports``: its configuration and shape) to
it, the CUDA kernel for tensors on the card; 'off' runs the plain
stacked-neighbourhood version everywhere. 'interpret', Pallas's CPU
interpreter, is TPU machinery that the port's plain CPU route replaces.

The ResNet config mirrors ``esvit_tpu/config.py:283-292``; as there, no
preset names it: ``TrainConfig(model=ResNetConfig(depth=50))`` reaches it.

Fields whose reference behaviour the port does not run yet keep their
names and are refused by :func:`check_supported`, which names the ROADMAP
item that ports them: the DINO head's tensor parallelism (``mesh.model >
1``).
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
    # 'block': each block of the window-major and classic loops runs under
    # torch.utils.checkpoint, so backward recomputes its activations from
    # its input (the fused routes recompute in their own backward).
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
class ViTConfig:
    """Monolithic ViT/DeiT spec (ref: models/vision_transformer.py:124-381)."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    norm_eps: float = 1e-6
    name: str = "vit"

    @property
    def num_features(self) -> int:
        return self.embed_dim


@dataclass(frozen=True)
class CvTStageConfig:
    """One CvT-v4 stage (ref: models/cvt_v4_transformer.py:457-507 SPEC
    arrays: PATCH_SIZE/STRIDE/PADDING, DIM_EMBED, DEPTH, NUM_HEADS,
    MLP_RATIO, QKV_BIAS, KERNEL_QKV, PADDING_QKV, WINDOW_SIZE, SHIFT)."""

    patch_size: int = 7
    patch_stride: int = 4
    patch_padding: int = 2
    embed_dim: int = 64
    depth: int = 1
    num_heads: int = 1
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    kernel_qkv: int = 3
    padding_qkv: int = 1
    window_size: int = 7
    shift: bool = False


@dataclass(frozen=True)
class CvTConfig:
    """CvT-v4 backbone spec (ref: models/cvt_v4_transformer.py:434-707)."""

    img_size: int = 224
    in_chans: int = 3
    stages: tuple[CvTStageConfig, ...] = ()
    norm_eps: float = 1e-5
    name: str = "cvt"

    @property
    def num_features(self) -> int:
        return self.stages[-1].embed_dim


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
    # Sparse stages' attention: longformer (also longformerhand,
    # longformerauto) | performer | linformer | srformer.
    attn_type: str = "longformer"
    # Sliding-chunk neighbour sampling (ref longformer2d.py:135-155 and
    # VIL_MODE_SWITCH): with mode > 0, each step of the first mode_switch
    # fraction of training draws one neighbour chunk per net (train.py's
    # schedule), full 8-neighbour attention after it; per_layer_mode: each
    # layer draws its own neighbour every forward instead.
    mode: int = 0
    mode_switch: float = 0.5
    per_layer_mode: bool = False
    # 'auto' / 'on': the sliding-chunk layers the kernel takes go through
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
class ResNetConfig:
    """torchvision-layout ResNet v1 (ref: utils.py:621-665 ResNetWrapper)."""

    depth: int = 50
    in_chans: int = 3
    name: str = "resnet"

    @property
    def num_features(self) -> int:
        return 2048 if self.depth >= 50 else 512


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
    # K-streamed DDINO loss (losses.ddino_loss_streamed): the DINO heads'
    # last layers fold into the loss, which walks out_dim in
    # stream_chunks chunks, so no (rows, out_dim) tensor outlives a chunk.
    streamed: bool = False
    stream_chunks: int = 8


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

    optimizer: str = "adamw"        # adamw | sgd | lars
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
    # Parameter subtrees frozen for the whole run (the finetune recipes'
    # FINETUNE.FROZEN_LAYERS): esvit_tpu's keys ('patch_embed', 'layers_0',
    # 'layers_0/blocks_1', dotted 'layers.0') or '*' (train/optim.py
    # freeze_mask_by_prefix).
    frozen_layers: tuple = ()


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) process grid (parallel/mesh.py): ``model`` > 1
    splits the DINO heads' last layers over that many processes (the
    head's tensor parallelism); the data axis spans the rest, world =
    data x model."""

    data: int = -1                  # -1: all processes
    model: int = 1


@dataclass(frozen=True)
class TrainConfig:
    model: Any = field(default_factory=SwinConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    crops: CropConfig = field(default_factory=CropConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    mixup: Any = None               # data.mixup.MixupConfig | None
    seed: int = 0
    dtype: torch.dtype = torch.bfloat16   # compute dtype; params stay fp32
    steps_per_epoch: int = 1251
    output_dir: str = "./output"
    save_every_epochs: int = 5

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


def deit_tiny(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=192, depth=12, num_heads=3, **kw)


def deit_small(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=768, depth=12, num_heads=12, **kw)


def cvt_tiny(**kw) -> CvTConfig:
    """experiments/imagenet/cvt_v4/s1.yaml: 4 stages, dims 64/192/384/768,
    heads 1/3/6/12, depths 2/2/6/2, window 7, no shift, no rel-pos."""
    dims = (64, 192, 384, 768)
    heads = (1, 3, 6, 12)
    depths = (2, 2, 6, 2)
    patches = ((7, 4, 2), (3, 2, 1), (3, 2, 1), (3, 2, 1))
    return CvTConfig(stages=tuple(
        CvTStageConfig(patch_size=p, patch_stride=s, patch_padding=pd,
                       embed_dim=d, depth=n, num_heads=h, drop_path_rate=0.1)
        for (p, s, pd), d, h, n in zip(patches, dims, heads, depths)), **kw)


def cvt_femto(**kw) -> CvTConfig:
    """Tiny CPU-testable CvT: 2 stages."""
    return CvTConfig(stages=(
        CvTStageConfig(patch_size=3, patch_stride=2, patch_padding=1,
                       embed_dim=16, depth=1, num_heads=2, window_size=4),
        CvTStageConfig(patch_size=3, patch_stride=2, patch_padding=1,
                       embed_dim=32, depth=1, num_heads=2, window_size=4),
    ), **kw)


def cvt_tiny_multicrop(batch_size: int = 32, **kw) -> TrainConfig:
    """CvT-T (cvt_tiny) on the Swin-T step's recipe: 2x224 + 8x96 crops,
    DINO heads of 65536 outputs, DDINO, bf16, B=32 per card."""
    return TrainConfig(model=cvt_tiny(), head=HeadConfig(),
                       loss=LossConfig(),
                       optim=OptimConfig(batch_size_per_device=batch_size),
                       steps_per_epoch=1251, dtype=torch.bfloat16, **kw)


def deit_small_multicrop(batch_size: int = 32, **kw) -> TrainConfig:
    """DeiT-S/16 on the Swin-T step's recipe: 2x224 + 8x96 crops, DINO
    heads of 65536 outputs, DDINO, bf16, B=32 per card."""
    return TrainConfig(model=deit_small(), head=HeadConfig(),
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
    "cvt_femto": cvt_femto,
    "swin_tiny": swin_tiny,
    "swin_small": swin_small,
    "swin_base": swin_base,
    "deit_tiny": deit_tiny,
    "deit_small": deit_small,
    "vit_base": vit_base,
    "cvt_tiny": cvt_tiny,
    "vil_femto": vil_femto,
    "vil_tiny": vil_tiny,
    "vil_small": vil_small,
}


def get_model_config(name: str, **kw):
    """The backbone config of a preset name (esvit_tpu/config.py:521)."""
    if name not in PRESETS:
        raise ValueError(f"unknown model preset {name!r}; have "
                         f"{sorted(PRESETS)}")
    return PRESETS[name](**kw)


def check_mesh(mesh: MeshConfig, world: int) -> None:
    """ValueError unless ``world`` processes make the (data, model) grid:
    the model axis divides the world, and a data axis that is given
    (> 0) times the model axis is the world (esvit_tpu/parallel/mesh.py
    make_mesh's rule over devices)."""
    model = max(mesh.model, 1)
    if world % model:
        raise ValueError(
            f"mesh model axis {model} does not divide the {world} "
            "processes: run data x model processes (--mesh_model divides "
            "the world size)")
    if mesh.data > 0 and mesh.data * model != world:
        raise ValueError(f"mesh data axis {mesh.data} x model axis {model} "
                         f"= {mesh.data * model} != {world} processes")


def check_supported(cfg: TrainConfig, world: int | None = None) -> None:
    """Raise NotImplementedError for reference options the port lacks
    (ViL's Pallas interpreter), ValueError for values no package takes;
    with ``world``, the process grid's (``check_mesh``)."""
    m = cfg.model
    name = getattr(m, "name", None)
    if name == "swin":
        if m.attention_impl not in ("packed", "pallas", "xla"):
            raise ValueError(f"unknown attention_impl {m.attention_impl!r}")
        if m.remat not in ("none", "block"):
            raise ValueError(f"unknown remat mode {m.remat!r}")
    elif name == "vil":
        _check_vil(m)
    elif name == "resnet":
        if m.depth not in (50, 101, 152):
            raise ValueError(f"ResNet depth {m.depth}: have 50, 101, 152")
    elif name not in ("vit", "cvt"):
        raise ValueError(f"no backbone for {name!r}")
    if cfg.optim.optimizer not in ("adamw", "sgd", "lars"):
        raise ValueError(f"unknown optimizer {cfg.optim.optimizer!r}")
    model = max(cfg.mesh.model, 1)
    if cfg.head.out_dim % model:
        raise ValueError(f"out_dim {cfg.head.out_dim} does not split over "
                         f"the mesh model axis {model}")
    if world is not None:
        check_mesh(cfg.mesh, world)


VIL_ATTN_TYPES = ("longformer", "longformerhand", "longformerauto",
                  "performer", "linformer", "srformer")


def _check_vil(m: ViLConfig) -> None:
    """Every option of esvit_tpu's ViL runs; 'interpret' is Pallas's CPU
    interpreter, which the port's plain CPU route replaces."""
    if m.attn_type not in VIL_ATTN_TYPES:
        raise ValueError(f"unknown ViL attn_type {m.attn_type!r}")
    if m.fused_sc == "interpret":
        raise NotImplementedError(
            "fused_sc='interpret' is Pallas's CPU interpreter, TPU "
            "machinery the port replaces: 'auto' runs the plain version "
            "for tensors on the CPU")
    if m.fused_sc not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_sc {m.fused_sc!r}")
