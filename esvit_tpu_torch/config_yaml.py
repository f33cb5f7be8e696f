"""The reference's experiment YAMLs as the port's backbone configs (port of
esvit_tpu/config_yaml.py).

The reference defines model shapes in YACS YAMLs with recursive ``BASE:``
includes (ref: config/default.py:266-299), e.g.
``experiments/imagenet/swin/swin_tiny_patch4_window7_224.yaml``.
``load_reference_yaml(path)`` reads such a file and returns the backbone
config, with the field values esvit_tpu gives; the trainer's knobs stay on
the CLI / ``TrainConfig``, as the reference splits them. ``yaml`` is
imported when a file is read, so the package imports without it.
"""

from __future__ import annotations

import os
from typing import Any

from esvit_tpu_torch import config as config_lib


def _load_with_base(path: str) -> dict:
    """The YAML at ``path`` over its ``BASE:`` files, each resolved the same
    way (config/default.py:266-278)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    base_paths = cfg.pop("BASE", [""])
    merged: dict = {}
    for bp in base_paths if isinstance(base_paths, list) else [base_paths]:
        if bp:
            _deep_update(merged, _load_with_base(
                os.path.join(os.path.dirname(path), bp)))
    return _deep_update(merged, cfg)


def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def model_config_from_tree(tree: dict) -> Any:
    """MODEL.NAME + MODEL.SPEC (+ TRAIN.IMAGE_SIZE) -> the backbone config:
    ``swin_transformer``, ``cvt_v4_transformer``, or the ViL names
    (``vision_longformer``, ``cls_vil``, ``msvit``)."""
    model = tree.get("MODEL", {})
    name = model.get("NAME", "")
    spec = model.get("SPEC", {})
    img_size = tree.get("TRAIN", {}).get("IMAGE_SIZE", [224])[0]

    if name == "swin_transformer":
        return config_lib.SwinConfig(
            img_size=img_size,
            patch_size=spec.get("PATCH_SIZE", 4),
            embed_dim=spec.get("DIM_EMBED", 96),
            depths=tuple(spec.get("DEPTHS", [2, 2, 6, 2])),
            num_heads=tuple(spec.get("NUM_HEADS", [3, 6, 12, 24])),
            window_size=spec.get("WINDOW_SIZE", 7),
            mlp_ratio=spec.get("MLP_RATIO", 4.0),
            qkv_bias=spec.get("QKV_BIAS", True),
            drop_rate=spec.get("DROP_RATE", 0.0),
            attn_drop_rate=spec.get("ATTN_DROP_RATE", 0.0),
            drop_path_rate=spec.get("DROP_PATH_RATE", 0.1),
            ape=spec.get("USE_APE", False),
            patch_norm=spec.get("PATCH_NORM", True),
        )
    if name == "cvt_v4_transformer":
        n = spec.get("NUM_STAGES", 4)

        def arr(key, default):
            v = spec.get(key, [default] * n)
            return v if isinstance(v, list) else [v] * n

        stages = tuple(
            config_lib.CvTStageConfig(
                patch_size=arr("PATCH_SIZE", 3)[i],
                patch_stride=arr("PATCH_STRIDE", 2)[i],
                patch_padding=arr("PATCH_PADDING", 1)[i],
                embed_dim=arr("DIM_EMBED", 64)[i],
                depth=arr("DEPTH", 1)[i],
                num_heads=arr("NUM_HEADS", 1)[i],
                mlp_ratio=arr("MLP_RATIO", 4.0)[i],
                qkv_bias=arr("QKV_BIAS", True)[i],
                drop_path_rate=spec.get("DROP_PATH_RATE", 0.0),
                kernel_qkv=arr("KERNEL_QKV", 3)[i],
                padding_qkv=arr("PADDING_QKV", 1)[i],
                window_size=arr("WINDOW_SIZE", 7)[i],
                shift=arr("SHIFT", False)[i],
            )
            for i in range(n))
        return config_lib.CvTConfig(img_size=img_size, stages=stages)
    if name in ("vision_longformer", "cls_vil", "msvit"):
        msvit = spec.get("MSVIT", {})
        attn_type = msvit.get("ATTN_TYPE", "longformerhand")
        attn_type = {"longformerhand": "longformer",
                     "longformerauto": "longformer"}.get(attn_type, attn_type)
        return config_lib.vil_from_arch(
            msvit.get("ARCH", ""), img_size=img_size, attn_type=attn_type,
            drop_rate=spec.get("DROP", 0.0),
            drop_path_rate=spec.get("DROP_PATH", 0.1),
            norm_eps=float(msvit.get("LN_EPS", 1e-6)))
    raise ValueError(f"unsupported MODEL.NAME {name!r}")


def load_reference_yaml(path: str) -> Any:
    """A reference experiment YAML -> its backbone config."""
    return model_config_from_tree(_load_with_base(path))
