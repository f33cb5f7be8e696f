"""Linear probe on frozen features (port of esvit_tpu/evals/linear.py;
ref: eval_linear.py).

Protocol (eval_linear.py:43-320): frozen backbone; features are the
concat of the avg-pooled outputs of the ``n_last_blocks`` (default 4) last
blocks (``forward_return_n_last_blocks``); one linear classifier trained
with SGD momentum 0.9, no weight decay, lr scaled by batch/256 and
cosine-annealed; top-1/top-5 on centre-crop val features.

Two training modes:

- **Reference protocol (default)**: each epoch re-forwards the frozen
  backbone on freshly RandomResizedCrop(224) + HorizontalFlip augmented
  images (ref eval_linear.py:50-55, :244-262).
- **Cached (``cached_features=True``)**: centre-crop features are
  extracted once and the probe trains on the cache. Much faster, but not
  the reference protocol (no train-time augmentation).

Val features are always cached (the val transform is deterministic). The
backbone and the probe run on ``device``, the card unless the caller asks
for the CPU; several processes extract strided shards (evals/extract.py)
and the online probe walks this process's shard, as esvit_tpu's does.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from esvit_tpu_torch import config as config_lib
from esvit_tpu_torch.data import datasets as datasets_lib
from esvit_tpu_torch.evals.extract import (extract_dataset_features,
                                           iter_batches, strided_shard)
from esvit_tpu_torch.evals.knn import (batched_forward, eval_transform,
                                       eval_transform_bytes,
                                       load_backbone_variables,
                                       model_from_args)
from esvit_tpu_torch.models.common import exact_fp32_convolutions
from esvit_tpu_torch.parallel.mesh import make_mesh
from esvit_tpu_torch.utils import schedules


def feature_dim_for(model_cfg, n_last_blocks: int) -> int:
    """Probe input dim = the summed widths of the n last blocks
    (ref: eval_linear.py:102-176)."""
    if model_cfg.name == "swin":
        dims = []
        for i, d in enumerate(model_cfg.depths):
            dims += [int(model_cfg.embed_dim * 2 ** i)] * d
        return sum(dims[-n_last_blocks:])
    if model_cfg.name == "vit":
        return model_cfg.embed_dim * n_last_blocks
    if model_cfg.name in ("cvt", "vil"):
        dims = []
        for s in model_cfg.stages:
            dims += [s.embed_dim] * s.depth
        return sum(dims[-n_last_blocks:])
    if model_cfg.name == "resnet":
        return model_cfg.num_features        # avgpool only (ref :168-176)
    raise ValueError(f"unknown arch {model_cfg.name}")


def _n_last_blocks(backbone, n_last_blocks):
    """The backbone's concat-of-n-last-blocks forward (BatchNorm on its
    running statistics, fp32 convolutions exact)."""
    exact_fp32_convolutions()
    return lambda x: backbone.forward_return_n_last_blocks(x, n_last_blocks)


def extract_probe_features(backbone, dataset, *, n_last_blocks=4,
                           batch_size=64, size=224, num_threads=8,
                           device="cuda"):
    """Centre-crop n-last-blocks features (f32, not normalised) and labels,
    in dataset order."""
    backbone.to(device)
    return extract_dataset_features(
        batched_forward(_n_last_blocks(backbone, n_last_blocks), device),
        dataset, lambda img: eval_transform(img, size),
        batch_size=batch_size, num_threads=num_threads,
        transform_bytes=lambda data: eval_transform_bytes(data, size))


def make_probe(dim: int, num_classes: int, *, scaled_lr: float,
               total_steps: int, seed: int = 0, device="cuda"):
    """(params {'w' (dim, classes), 'b'}, step(x, y) -> loss): SGD momentum
    0.9, no weight decay, cosine lr set from the step count before each
    step, the count starting at 0 as optax's does (eval_linear.py:189-195);
    weights trunc-normal(0.01) from a numpy generator, zero bias
    (eval_linear.py:307-320)."""
    rng = np.random.default_rng(seed)
    w = np.clip(rng.normal(0, 0.01, (dim, num_classes)), -0.02, 0.02)
    params = {
        "w": torch.tensor(w, dtype=torch.float32, device=device,
                          requires_grad=True),
        "b": torch.zeros(num_classes, device=device, requires_grad=True),
    }
    opt = torch.optim.SGD(params.values(), lr=0.0, momentum=0.9)
    count = 0

    def step(x, y):
        nonlocal count
        for group in opt.param_groups:
            group["lr"] = schedules.cosine_schedule(
                count, base_value=scaled_lr, final_value=0.0,
                total_steps=total_steps)
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(x @ params["w"] + params["b"], y)
        loss.backward()
        opt.step()
        count += 1
        return loss.detach()

    return params, step


def _probe_accuracy(params, test_f, test_l, num_classes):
    with torch.no_grad():
        x = torch.as_tensor(test_f, device=params["w"].device)
        logits = (x @ params["w"] + params["b"]).cpu().numpy()
    pred = np.argsort(-logits, axis=1, kind="stable")
    gt = test_l[:, None]
    top1 = 100.0 * (pred[:, :1] == gt).sum() / len(test_l)
    top5 = 100.0 * (pred[:, :min(5, num_classes)] == gt).any(1).sum() / len(test_l)
    return float(top1), float(top5)


def train_linear_probe(train_f, train_l, test_f, test_l, *, num_classes=None,
                       epochs=100, batch_size=256, lr=0.001, seed=0,
                       device="cuda"):
    """Cached-feature mode: the probe trained on precomputed centre-crop
    features (fast; not the reference's augmented protocol)."""
    num_classes = num_classes or int(train_l.max()) + 1
    rng = np.random.default_rng(seed)
    n = len(train_f)
    steps_per_epoch = max(n // batch_size, 1)
    params, step = make_probe(
        train_f.shape[1], num_classes, scaled_lr=lr * batch_size / 256.0,
        total_steps=epochs * steps_per_epoch, seed=seed, device=device)
    tf = torch.as_tensor(train_f, device=device)
    tl = torch.as_tensor(train_l, device=device).long()
    for _ in range(epochs):
        perm = rng.permutation(n)[: steps_per_epoch * batch_size]
        for s in range(steps_per_epoch):
            idx = torch.as_tensor(perm[s * batch_size:(s + 1) * batch_size],
                                  device=device)
            step(tf[idx], tl[idx])
    top1, top5 = _probe_accuracy(params, test_f, test_l, num_classes)
    return params, top1, top5


class _AugmentedProbeView:
    """Dataset view applying the reference's linear-probe train transform:
    RandomResizedCrop(size, scale=(0.08, 1.0)) + RandomHorizontalFlip +
    normalise (ref eval_linear.py:50-55), with a fresh draw per (epoch,
    index) so every epoch sees new crops."""

    def __init__(self, dataset, *, size: int, seed: int, epoch: int):
        self.dataset = dataset
        self.size = size
        self.seed = seed
        self.epoch = epoch

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        import random

        from PIL import Image

        from esvit_tpu_torch.data.augment_host import (IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       random_resized_crop)

        img, label = self.dataset[int(i)]
        if img.mode != "RGB":
            img = img.convert("RGB")
        rng = random.Random(hash((self.seed, self.epoch, int(i))))
        img = random_resized_crop(img, self.size, (0.08, 1.0), rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        x = np.asarray(img, np.float32) / 255.0
        return (x - IMAGENET_MEAN) / IMAGENET_STD, label


def train_linear_probe_online(backbone, train_ds, test_f, test_l, *,
                              n_last_blocks=4, num_classes=None, epochs=100,
                              batch_size=256, lr=0.001, seed=0, size=224,
                              num_threads=8, log_every=None, device="cuda"):
    """Reference protocol: per-epoch augmented forwards through the frozen
    backbone feeding the probe update directly (ref eval_linear.py:
    244-262). Each epoch walks this process's strided shard of the train
    set with fresh RRC+flip draws; the features stay on the device between
    backbone and probe."""
    num_classes = num_classes or int(test_l.max()) + 1
    mesh = make_mesh()
    my = strided_shard(len(train_ds), mesh.rank, mesh.world)
    steps_per_epoch = max(len(my) // batch_size, 1)
    params, step = make_probe(
        feature_dim_for(backbone.cfg, n_last_blocks), num_classes,
        scaled_lr=lr * batch_size / 256.0,
        total_steps=epochs * steps_per_epoch, seed=seed, device=device)
    backbone.to(device)
    fwd = _n_last_blocks(backbone, n_last_blocks)

    order_rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        view = _AugmentedProbeView(train_ds, size=size, seed=seed,
                                   epoch=epoch)
        perm = my[order_rng.permutation(len(my))]
        perm = perm[: steps_per_epoch * batch_size]
        for x, y, n_real in iter_batches(view, perm, lambda a: a,
                                         batch_size,
                                         num_threads=num_threads):
            if n_real < batch_size:
                continue                 # drop the ragged tail like DataLoader
            with torch.no_grad():
                f = fwd(torch.from_numpy(x).to(device))
            step(f, torch.as_tensor(y, device=device).long())
        if log_every and (epoch + 1) % log_every == 0:
            t1, t5 = _probe_accuracy(params, test_f, test_l, num_classes)
            print(f"probe epoch {epoch + 1}: top1 {t1:.2f} top5 {t5:.2f}",
                  flush=True)

    top1, top5 = _probe_accuracy(params, test_f, test_l, num_classes)
    return params, top1, top5


def run_linear_eval(backbone, train_ds, val_ds, *, n_last_blocks=4,
                    epochs=100, batch_size=256, lr=0.001, feat_batch=64,
                    size=224, num_classes=None, cached_features=False,
                    seed=0, device="cuda"):
    """cached_features=False (default) runs the reference protocol,
    per-epoch augmented forwards; True trains on a one-shot centre-crop
    feature cache. Returns (top1, top5)."""
    test_f, test_l = extract_probe_features(
        backbone, val_ds, n_last_blocks=n_last_blocks, batch_size=feat_batch,
        size=size, device=device)
    if cached_features:
        train_f, train_l = extract_probe_features(
            backbone, train_ds, n_last_blocks=n_last_blocks,
            batch_size=feat_batch, size=size, device=device)
        _, top1, top5 = train_linear_probe(
            train_f, train_l, test_f, test_l, epochs=epochs,
            batch_size=batch_size, lr=lr, num_classes=num_classes, seed=seed,
            device=device)
    else:
        _, top1, top5 = train_linear_probe_online(
            backbone, train_ds, test_f, test_l, n_last_blocks=n_last_blocks,
            epochs=epochs, batch_size=batch_size, lr=lr,
            num_classes=num_classes, size=size, seed=seed, device=device)
    print(f"Linear probe: Top1 {top1:.2f}, Top5 {top5:.2f}", flush=True)
    return top1, top5


def main(argv=None):
    p = argparse.ArgumentParser("esvit_tpu_torch linear eval")
    p.add_argument("--arch", default="swin_tiny",
                   choices=sorted(config_lib.PRESETS))
    p.add_argument("--window_size", default=7, type=int)
    p.add_argument("--pretrained", default="")
    p.add_argument("--checkpoint_key", default="teacher")
    p.add_argument("--n_last_blocks", default=4, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--data_kind", default="folder")
    p.add_argument("--train_path", default="")
    p.add_argument("--val_path", default="")
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--cached_features", default=False, action="store_true",
                   help="train the probe on one-shot centre-crop features "
                        "instead of the reference's per-epoch augmented "
                        "forwards (faster; below the published numbers)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    model_cfg, backbone = model_from_args(args)
    backbone = load_backbone_variables(backbone, model_cfg, args.pretrained,
                                       args.checkpoint_key)
    train_ds = datasets_lib.build_dataset(args.data_kind, root=args.train_path)
    val_ds = datasets_lib.build_dataset(args.data_kind, root=args.val_path)
    top1, top5 = run_linear_eval(
        backbone, train_ds, val_ds, n_last_blocks=args.n_last_blocks,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        cached_features=args.cached_features, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
        f.write(json.dumps({"linear_top1": top1, "linear_top5": top5}) + "\n")
    return top1, top5


if __name__ == "__main__":
    main()
