"""Weighted k-NN evaluation on frozen features (port of
esvit_tpu/evals/knn.py; ref: eval_knn.py).

Protocol (eval_knn.py:46-232): centre-crop eval transform, teacher
backbone cls features, L2-normalised, then a weighted vote over the k
nearest train features with temperature-softened cosine similarity:
``w = exp(sim / T)``, T=0.07, k in {10, 20, 100, 200}.

Feature extraction is one batched forward per batch under
``torch.inference_mode``, in fp32 by default as in JAX (with fp32
convolutions exact, and BatchNorm on its running statistics:
``forward_features``' default ``bn_train=False``); the k-NN vote is a
chunked similarity product (the reference chunks into 100 pieces,
eval_knn.py:199-229). Both run on ``device``, the card unless the caller
asks for the CPU. Several processes extract strided shards and gather them
(evals/extract.py).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from esvit_tpu_torch import config as config_lib
from esvit_tpu_torch.data import datasets as datasets_lib
from esvit_tpu_torch.data.augment_host import IMAGENET_MEAN, IMAGENET_STD
from esvit_tpu_torch.evals.extract import extract_dataset_features
from esvit_tpu_torch.io.torch_checkpoint import load_backbone_checkpoint
from esvit_tpu_torch.models.common import exact_fp32_convolutions
from esvit_tpu_torch.models.registry import build_backbone


def eval_transform(img, size: int = 224) -> np.ndarray:
    """Resize(256, bicubic) + centre-crop(size) + normalise
    (ref: eval_knn.py:48-53), HWC float32."""
    from PIL import Image

    scale = 256 / min(img.size)
    img = img.resize((round(img.width * scale), round(img.height * scale)),
                     Image.BICUBIC)
    left = (img.width - size) // 2
    top = (img.height - size) // 2
    img = img.crop((left, top, left + size, top + size))
    x = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def eval_transform_bytes(data: bytes, size: int = 224) -> np.ndarray | None:
    """``eval_transform`` of a JPEG's bytes through the native library
    (native/), or None where PIL should run (not a JPEG, too small, no
    library).

    Resize(256) + CenterCrop(size) fold into ONE crop + resize: PIL's
    convolution resampler computes output pixel (left + xx) of the full
    resize from the source centre ((left + xx) + 0.5) * scale, the centre
    the box resample gives with the box origin at left * scale, so
    cropping after resizing equals resampling the back-projected crop box
    (within the +/-1 LSB of double against fixed-point accumulation).
    Where the library has no JPEG half, PIL decodes and the library
    crops."""
    from esvit_tpu_torch import native

    if not native.available():
        return None
    lib = native.library()
    source = lib.source(data)
    if source is None:
        return None
    w0, h0 = source[1]
    scale = 256 / min(w0, h0)
    rw, rh = round(w0 * scale), round(h0 * scale)
    if rw < size or rh < size:
        return None
    sx, sy = w0 / rw, h0 / rh
    left, top = (rw - size) // 2, (rh - size) // 2
    box = np.array([[[top * sy, left * sx, size * sy, size * sx]]])
    out = np.empty((1, size, size, 3), np.uint8)
    if lib.crops([source[0]], box, [size], [out], [0])[0]:
        return None
    view = out[0]
    x = view.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def batched_forward(fn, device, dtype=torch.float32):
    """numpy batch -> fn(batch on ``device`` in ``dtype``) as fp32 numpy,
    under inference mode."""
    if dtype == torch.float32:
        exact_fp32_convolutions()

    def fwd(x):
        with torch.inference_mode():
            out = fn(torch.from_numpy(x).to(device, dtype))
            return out.float().cpu().numpy()
    return fwd


def extract_features(backbone, dataset, *, batch_size: int = 64,
                     size: int = 224, dtype=torch.float32,
                     num_threads: int = 8, device="cuda",
                     counts: dict | None = None):
    """(features (N, C) L2-normalised f32, labels (N,)) of a dataset: the
    backbone's cls feature of each centre crop, on ``device``; JPEG bytes
    through the native library where it builds (``counts`` as
    extract.iter_batches')."""
    backbone.to(device)
    f, lab = extract_dataset_features(
        batched_forward(lambda x: backbone.forward_features(x)[0], device,
                        dtype),
        dataset, lambda img: eval_transform(img, size),
        batch_size=batch_size, num_threads=num_threads,
        transform_bytes=lambda data: eval_transform_bytes(data, size),
        counts=counts)
    f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    return f, lab


def knn_classifier(train_f: np.ndarray, train_l: np.ndarray,
                   test_f: np.ndarray, test_l: np.ndarray, *, k: int,
                   T: float = 0.07, num_classes: int | None = None,
                   chunk: int = 512, device="cuda") -> tuple[float, float]:
    """Top-1/top-5 accuracy (%) of the weighted k-NN vote
    (eval_knn.py:192-229): per test chunk the similarities to every train
    feature, the k largest, ``exp(sim / T)`` summed per class, classes
    ranked by that vote."""
    num_classes = num_classes or int(train_l.max()) + 1
    tf = torch.as_tensor(train_f, device=device)
    tl = torch.as_tensor(train_l, device=device).long()
    top1 = top5 = 0
    n = len(test_f)
    for s in range(0, n, chunk):
        q = torch.as_tensor(test_f[s:s + chunk], device=device)
        sim = q @ tf.T                                    # (b, N)
        topv, topi = torch.topk(sim, k, dim=1)
        w = torch.exp(topv / T)
        scores = torch.zeros(len(q), num_classes, device=device,
                             dtype=w.dtype).scatter_add_(1, tl[topi], w)
        ranked = torch.argsort(-scores, dim=1, stable=True).cpu().numpy()
        gt = test_l[s:s + chunk, None]
        top1 += int((ranked[:, :1] == gt).sum())
        top5 += int((ranked[:, :min(5, num_classes)] == gt).any(1).sum())
    return 100.0 * top1 / n, 100.0 * top5 / n


def run_knn_eval(backbone, train_ds, val_ds, *, ks=(10, 20, 100, 200),
                 T: float = 0.07, batch_size: int = 64, size: int = 224,
                 dump_dir: str | None = None, load_dir: str | None = None,
                 device="cuda", counts: dict | None = None):
    """Full protocol: extract (or load dumped features), optionally dump,
    classify at each k (ref: eval_knn.py:138-144, 291-295). ``counts``
    receives the images the native library and PIL decoded ('native',
    'pil'), which are also printed."""
    if load_dir:
        train_f = np.load(os.path.join(load_dir, "trainfeat.npy"))
        test_f = np.load(os.path.join(load_dir, "testfeat.npy"))
        train_l = np.load(os.path.join(load_dir, "trainlabels.npy"))
        test_l = np.load(os.path.join(load_dir, "testlabels.npy"))
    else:
        counts = {} if counts is None else counts
        train_f, train_l = extract_features(backbone, train_ds,
                                            batch_size=batch_size, size=size,
                                            device=device, counts=counts)
        test_f, test_l = extract_features(backbone, val_ds,
                                          batch_size=batch_size, size=size,
                                          device=device, counts=counts)
        print(f"feature extraction: {counts.get('native', 0)} images "
              f"decoded by the native library, {counts.get('pil', 0)} by "
              "PIL", flush=True)
    if dump_dir and not load_dir:
        os.makedirs(dump_dir, exist_ok=True)
        np.save(os.path.join(dump_dir, "trainfeat.npy"), train_f)
        np.save(os.path.join(dump_dir, "testfeat.npy"), test_f)
        np.save(os.path.join(dump_dir, "trainlabels.npy"), train_l)
        np.save(os.path.join(dump_dir, "testlabels.npy"), test_l)
    results = {}
    for k in ks:
        if k >= len(train_f):
            continue
        t1, t5 = knn_classifier(train_f, train_l, test_f, test_l, k=k, T=T,
                                device=device)
        results[k] = (t1, t5)
        print(f"{k}-NN classifier result: Top1: {t1:.2f}, Top5: {t5:.2f}",
              flush=True)
    return results


def load_backbone_variables(backbone, model_cfg, pretrained: str,
                            checkpoint_key: str = "teacher"):
    """The backbone with the ``checkpoint_key`` model's weights ('teacher'
    or 'student') of a .pth/.pt loaded (Swin tables adapted): a
    reference checkpoint, or the port's own checkpoint*.pth
    (io/checkpoint.py), which keeps the reference's names and layout. As
    initialised when ``pretrained`` is empty. esvit_tpu's orbax
    directories are turned into such a file by scripts/orbax_to_torch.py
    (on a machine with jax and orbax)."""
    del model_cfg  # the backbone carries its config
    if not pretrained:
        print("no pretrained weights — random features", flush=True)
        return backbone
    if pretrained.endswith((".pth", ".pt")):
        return load_backbone_checkpoint(backbone, pretrained, checkpoint_key)
    raise ValueError(f"{pretrained!r}: the evals load .pth/.pt "
                     "checkpoints (the reference's, or checkpoint*.pth of "
                     "esvit_tpu_torch.train.train); convert an esvit_tpu "
                     "orbax checkpoint directory with scripts/"
                     "orbax_to_torch.py, where jax and orbax are installed")


def model_from_args(args):
    """(model config, backbone with weights) from the eval CLIs' flags (a
    ``window_size`` of None: the preset's); the random init, when no
    weights are given, is seeded (0)."""
    model_cfg = config_lib.get_model_config(
        args.arch, **({"window_size": args.window_size}
                      if args.arch.startswith("swin")
                      and args.window_size is not None else {}))
    backbone = build_backbone(model_cfg,
                              generator=torch.Generator().manual_seed(0))
    return model_cfg, backbone


def main(argv=None):
    p = argparse.ArgumentParser("esvit_tpu_torch k-NN eval")
    p.add_argument("--arch", default="swin_tiny",
                   choices=sorted(config_lib.PRESETS))
    p.add_argument("--window_size", default=7, type=int)
    p.add_argument("--pretrained", default="",
                   help=".pth/.pt checkpoint: the reference's, or the "
                        "port's checkpoint*.pth")
    p.add_argument("--checkpoint_key", default="teacher")
    p.add_argument("--data_kind", default="folder")
    p.add_argument("--train_path", default="")
    p.add_argument("--val_path", default="")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--temperature", default=0.07, type=float)
    p.add_argument("--nb_knn", nargs="+", type=int, default=[10, 20, 100, 200])
    p.add_argument("--dump_features", default="")
    p.add_argument("--load_features", default="")
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.load_features:
        backbone = train_ds = val_ds = None
    else:
        model_cfg, backbone = model_from_args(args)
        backbone = load_backbone_variables(backbone, model_cfg,
                                           args.pretrained,
                                           args.checkpoint_key)
        train_ds = datasets_lib.build_dataset(args.data_kind,
                                              root=args.train_path)
        val_ds = datasets_lib.build_dataset(args.data_kind, root=args.val_path)
    results = run_knn_eval(backbone, train_ds, val_ds,
                           ks=tuple(args.nb_knn), T=args.temperature,
                           batch_size=args.batch_size,
                           dump_dir=args.dump_features or None,
                           load_dir=args.load_features or None,
                           device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
        f.write(json.dumps({f"{k}nn_top1": v[0] for k, v in results.items()})
                + "\n")
    return results


if __name__ == "__main__":
    main()
