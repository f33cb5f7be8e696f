"""Analysis CLI (port of esvit_tpu/analysis/cli.py; ref:
analyze_models.py:544-837).

Subcommands, as the reference's analyze_models.py has them:
- ``vis_attention``          attention-map grids per image (ref :752-776)
- ``vis_correspondence``     matched-region line plots between an image
                             and its flip (ref :680-687)
- ``measure_correspondence`` flip accuracy and grid distance over a batch
                             (ref :689-742)
- ``measure_entropy``        per-block attention entropy over a batch
                             (ref :783-837)

``python -m esvit_tpu_torch.analysis.cli measure_entropy --arch swin_tiny
--pretrained ckpt.pth --data_path imgs/ --output_dir out/``

The backbone loads as the evals load it (evals/knn.py
``load_backbone_variables``: a reference .pth or the port's
checkpoint*.pth), images go through the evals' centre crop, and the
forwards run in fp32 on ``--device`` (the card unless ``--device cpu``).
The measurements append a JSON record to ``output_dir/log.txt``; the
``vis_*`` commands need matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from esvit_tpu_torch import config as config_lib
from esvit_tpu_torch.analysis import attention as attn_lib
from esvit_tpu_torch.analysis import correspondence as corr_lib
from esvit_tpu_torch.data import datasets as datasets_lib
from esvit_tpu_torch.evals.knn import (eval_transform,
                                       load_backbone_variables,
                                       model_from_args)
from esvit_tpu_torch.models.common import exact_fp32_convolutions


def _load(args):
    """(backbone on args.device with its weights, dataset)."""
    model_cfg, backbone = model_from_args(args)
    backbone = load_backbone_variables(backbone, model_cfg, args.pretrained,
                                       args.checkpoint_key)
    exact_fp32_convolutions()
    ds = datasets_lib.build_dataset(args.data_kind, root=args.data_path)
    return backbone.to(args.device), ds


def _batch(ds, n, size, start=0) -> np.ndarray:
    """Images start .. start+n of the dataset, centre-cropped and
    normalised: (n, size, size, 3) fp32."""
    return np.stack([eval_transform(ds[i][0], size)
                     for i in range(start, min(start + n, len(ds)))])


def _device_batch(x: np.ndarray, args) -> torch.Tensor:
    return torch.from_numpy(x).to(args.device)


def vis_attention(args):
    backbone, ds = _load(args)
    os.makedirs(args.output_dir, exist_ok=True)
    n = min(args.num_images, len(ds))
    for i in range(n):
        x = _device_batch(_batch(ds, 1, args.image_size, i), args)
        attn = attn_lib.attention_maps(backbone, x, n=1)
        attn_lib.save_attention_grid(
            attn.float().cpu().numpy(),
            os.path.join(args.output_dir, f"attn_{i}.png"))
    print(f"wrote {n} attention grids to {args.output_dir}", flush=True)


def vis_correspondence(args):
    backbone, ds = _load(args)
    os.makedirs(args.output_dir, exist_ok=True)
    for i in range(min(args.num_images, len(ds))):
        x = _batch(ds, 1, args.image_size, i)
        fea, fea_f = corr_lib.flip_features(backbone, x)
        img = np.asarray((x[0] - x[0].min()) / (x[0].max() - x[0].min())
                         * 255, np.uint8)
        corr_lib.plot_correspondence(
            img, img[:, ::-1], fea[0], fea_f[0],
            os.path.join(args.output_dir, f"corr_{i}.png"))
    print(f"wrote correspondence plots to {args.output_dir}", flush=True)


def measure_correspondence(args):
    backbone, ds = _load(args)
    imgs = _batch(ds, args.num_images, args.image_size)
    acc, dist = corr_lib.correspondence_accuracy(backbone, imgs)
    print(f"correspondence: acc {acc:.2f}% mean-dist {dist:.3f}", flush=True)
    _log(args, {"correspondence_acc": acc, "correspondence_dist": dist})


def measure_entropy(args):
    backbone, ds = _load(args)
    imgs = _device_batch(_batch(ds, args.num_images, args.image_size), args)
    attns = attn_lib.attention_maps(backbone, imgs, n=2)
    ents = [float(attn_lib.attention_entropy(a.float().cpu().numpy()).mean())
            for a in attns]
    print("per-block mean attention entropy:",
          [round(e, 4) for e in ents], flush=True)
    _log(args, {"attention_entropy": ents})


def _log(args, record):
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(record) + "\n")


COMMANDS = {"vis_attention": vis_attention,
            "vis_correspondence": vis_correspondence,
            "measure_correspondence": measure_correspondence,
            "measure_entropy": measure_entropy}


def main(argv=None):
    p = argparse.ArgumentParser("esvit_tpu_torch analysis")
    p.add_argument("command", choices=sorted(COMMANDS))
    p.add_argument("--arch", default="swin_tiny",
                   choices=sorted(config_lib.PRESETS))
    p.add_argument("--window_size", default=7, type=int)
    p.add_argument("--pretrained", default="",
                   help=".pth/.pt checkpoint: the reference's, or the "
                        "port's checkpoint*.pth")
    p.add_argument("--checkpoint_key", default="teacher")
    p.add_argument("--data_kind", default="folder")
    p.add_argument("--data_path", default="")
    p.add_argument("--image_size", default=224, type=int)
    p.add_argument("--num_images", default=8, type=int)
    p.add_argument("--output_dir", default="./analysis_out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    COMMANDS[args.command](args)


if __name__ == "__main__":
    main()
