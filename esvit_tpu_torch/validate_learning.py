"""End-to-end learning validation of the port (the twin of
scripts/validate_learning.py).

Pre-trains a nano Swin, ViL or CvT with the full EsViT recipe (multi-crop
DDINO, augmentation on the device, or with ``--host_aug`` the full PIL
pipeline on the host, teacher EMA) on a procedural shape
dataset and compares the frozen teacher's k-NN accuracy before and after.
The models, crops, head / loss / optimiser settings, datasets, data loop
and gate are the reference script's: the LR / temperature schedule runs
over 20 epochs of ``steps // 20`` steps, while the data loop makes a new
iterator per pass over the 4096 training images.

    python -m esvit_tpu_torch.validate_learning --task shapes_hard \\
        --steps 6000 --backbone swin          # on the card
    python -m esvit_tpu_torch.validate_learning --size femto --steps 20 \\
        --cpu --min_gain -100                 # a CPU smoke run

Gates (the reference's, from its TPU rounds): shapes_hard at >= 5000
steps requires +10 k-NN points for Swin and +6 for ViL; shorter runs are
divergence canaries (+2 Swin, -1 ViL); the CvT leg has no measured
margin yet and is a canary at every length (-1); shapes requires +5.
Always: a finite last loss and a final accuracy above 1.25x chance.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from esvit_tpu_torch import config
from esvit_tpu_torch.data.datasets import Memoized, build_dataset
from esvit_tpu_torch.data.loader import build_train_iterator
from esvit_tpu_torch.evals.knn import run_knn_eval
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.train.step import EsViTTrainer

EPOCHS = 20
NANO_VIL_ARCH = ("l1,h2,d32,n2,s1,g1,p4,f4_l2,h4,d64,n2,s1,g1,p2,f4_"
                 "l3,h4,d128,n2,s0,g1,p2,f4")


def build_config(*, size: str = "nano", backbone: str = "swin",
                 fused: bool = True, dense: bool = True,
                 task: str = "shapes_hard", lr: float | None = None,
                 steps: int = 2000, batch: int = 64, seed: int = 0,
                 hires: bool = False) -> tuple[config.TrainConfig, int]:
    """The reference script's TrainConfig (bf16, ``seed`` for the initial
    weights, the crops and the drop-path draws) and source image side.
    hires (nano only): 160 px sources, 96 / 48 px crops, where the full
    PIL recipe's blur leaves shapes_hard's fill texture."""
    if hires and size != "nano":
        raise ValueError("--hires is a nano-size configuration")
    if size == "nano":
        g_size, l_size, img_size = (96, 48, 160) if hires else (64, 32, 96)
        if backbone == "vil":
            model = config.vil_from_arch(NANO_VIL_ARCH, img_size=g_size)
        elif backbone == "cvt":
            # The nano 3-stage CvT (scripts/validate_learning.py:126-140):
            # conv q/k/v with BatchNorm, QuickGELU; 64 px -> 16x16 -> 8x8
            # -> 4x4, the nano Swin's token grids.
            model = config.CvTConfig(img_size=g_size, stages=tuple(
                config.CvTStageConfig(patch_size=3, patch_stride=s,
                                      patch_padding=1, embed_dim=d, depth=n,
                                      num_heads=h)
                for s, d, n, h in ((4, 32, 1, 2), (2, 64, 1, 4),
                                   (2, 128, 2, 4))))
        else:
            model = config.SwinConfig(img_size=g_size, patch_size=4,
                                      embed_dim=32, depths=(2, 2, 2),
                                      num_heads=(2, 4, 4), window_size=4,
                                      drop_path_rate=0.0)
    else:
        if backbone != "swin":
            raise ValueError("--size femto is Swin-only")
        model = config.swin_femto(drop_path_rate=0.0)
        g_size, l_size, img_size = 32, 16, 64
    if not fused and backbone == "vil":
        model = dataclasses.replace(model, fused_sc="off")
    elif not fused and backbone == "swin":
        model = dataclasses.replace(model, fused_block_stages=())
    crops = config.CropConfig(global_size=g_size, global_scale=(0.4, 1.0),
                              local_size=l_size, local_scale=(0.3, 0.8),
                              local_crops_number=4)
    cfg = config.TrainConfig(
        model=model,
        head=config.HeadConfig(out_dim=1024, hidden_dim=512,
                               bottleneck_dim=64, norm_last_layer=False),
        loss=config.LossConfig(out_dim=1024, use_dense_prediction=dense,
                               warmup_teacher_temp_epochs=5),
        crops=crops,
        optim=config.OptimConfig(
            epochs=EPOCHS, warmup_epochs=4,
            lr=(lr if lr is not None
                else 4e-3 if task == "shapes_hard" else 8e-3),
            batch_size_per_device=batch, freeze_last_layer_epochs=1),
        steps_per_epoch=max(steps // EPOCHS, 1),
        dtype=torch.bfloat16, seed=seed)
    return cfg, img_size


def knn_accuracy(cfg, teacher, val_train, val_test, device) -> float:
    """10-NN top-1 (%) of the teacher backbone's features, in fp32 (a
    fresh fp32 backbone carrying the teacher's weights)."""
    backbone = build_backbone(cfg.model)
    backbone.load_state_dict(teacher.backbone.state_dict())
    res = run_knn_eval(backbone, val_train, val_test, ks=(10,),
                       batch_size=32, size=cfg.crops.global_size,
                       device=device)
    return res[10][0]


def validate(*, steps: int = 2000, batch: int = 64, size: str = "nano",
             backbone: str = "swin", dense: bool = True,
             task: str = "shapes_hard", eval_every: int = 0,
             max_seconds: float | None = None, lr: float | None = None,
             fused: bool = True, device: torch.device | str = "cuda",
             n_eval: int | None = None, seed: int = 0,
             host_aug: bool = False, hires: bool = False) -> dict:
    """Train and evaluate as the reference script does; no gate. Returns
    {'before', 'after', 'steps', 'seconds', 'last_loss'} (k-NN top-1 in
    %, steps taken, training seconds, the last step's loss) and, under
    'center_max', the largest |center| and |center_grid| at the end, and
    under 'feed_wait_seconds' the training loop's total wait on the feed.
    ``n_eval`` shrinks the k-NN sets for tests (the reference's: 512 for
    shapes_hard, else 256, for the train set; half that for the test
    set)."""
    device = torch.device(device)
    cfg, img_size = build_config(size=size, backbone=backbone, fused=fused,
                                 dense=dense, task=task, lr=lr, steps=steps,
                                 batch=batch, seed=seed, hires=hires)
    trainer = EsViTTrainer(cfg, total_batch_size=batch, device=device)
    if n_eval is None:
        n_eval = 512 if task == "shapes_hard" else 256
    # The reference redraws every image each pass; the twin draws each
    # once (the same bytes) and keeps it.
    train_ds = Memoized(build_dataset(task, n=4096, size=img_size, seed=0))
    val_train = Memoized(build_dataset(task, n=n_eval, size=img_size,
                                       seed=7))
    val_test = Memoized(build_dataset(task, n=n_eval // 2, size=img_size,
                                      seed=13))

    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)

    def knn(tag):
        acc = knn_accuracy(cfg, state.teacher, val_train, val_test, device)
        print(f"[{tag}] 10-NN top-1: {acc:.2f}%", flush=True)
        return acc

    def center_max():
        c = state.centers
        out = {"center": c.center.abs().max().item()}
        if getattr(c, "center_grid", None) is not None:
            out["center_grid"] = c.center_grid.abs().max().item()
        return out

    before = knn("random init")
    t0 = time.time()
    steps_done, epoch, out_of_time, metrics = 0, 0, False, None
    feed_wait = 0.0
    while steps_done < steps and not out_of_time:
        it = build_train_iterator(train_ds, cfg.crops, batch, epoch=epoch,
                                  seed=cfg.seed, num_threads=4,
                                  host_aug=host_aug, device=device)
        batches = iter(it)
        for batch_ in batches:
            state, metrics = trainer.train_step(state, batch_, drop_gen)
            steps_done += 1
            if eval_every and steps_done % eval_every == 0 \
                    and steps_done < steps:
                knn(f"step {steps_done}")
            if max_seconds is not None and time.time() - t0 > max_seconds:
                print(f"[budget] stopping at step {steps_done} after "
                      f"{time.time() - t0:.0f}s", flush=True)
                out_of_time = True
                break
            if steps_done % 50 == 0:
                line = (f"step {steps_done}: loss "
                        f"{float(metrics['loss']):.4f} "
                        f"({time.time() - t0:.0f}s)")
                if steps_done % 500 == 0:
                    # Long-horizon stability telemetry: the centre EMAs
                    # must stay bounded (collapse or NaN shows here first).
                    cmax = center_max()
                    line += "".join(f" |{k}|max {v:.3f}"
                                    for k, v in cmax.items())
                    assert all(map(math.isfinite, cmax.values())), \
                        "center EMA went non-finite"
                print(line, flush=True)
            if steps_done >= steps:
                break
        batches.close()
        feed_wait += sum(it.waits)
        epoch += 1
    seconds = time.time() - t0
    after = knn("trained")
    last_loss = float(metrics["loss"]) if metrics is not None else math.nan
    return {"before": before, "after": after, "steps": steps_done,
            "seconds": seconds, "last_loss": last_loss,
            "center_max": center_max(), "feed_wait_seconds": feed_wait}


def min_gain_for(task: str, steps: int, backbone: str) -> float:
    """The reference's default gain bar (scripts/validate_learning.py
    :270-298, measured on its TPU rounds)."""
    if task != "shapes_hard":
        return 5.0
    if backbone == "vil":
        return 6.0 if steps >= 5000 else -1.0
    if backbone == "cvt":
        return -1.0             # no measured nano-CvT margin: a canary
    return 10.0 if steps >= 5000 else 2.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", choices=["nano", "femto"], default="nano",
                   help="nano: 3-stage @64px; femto: 2-stage Swin @32px")
    p.add_argument("--backbone", choices=["swin", "vil", "cvt"],
                   default="swin",
                   help="vil: nano Vision-Longformer, two sliding-chunk "
                        "stages with a global token; cvt: nano CvT, conv "
                        "q/k/v with BatchNorm")
    p.add_argument("--no-dense", dest="dense", action="store_false",
                   help="disable the region-level (DDINO) task")
    p.add_argument("--task", choices=["shapes", "shapes_hard"],
                   default="shapes_hard")
    p.add_argument("--host_aug", action="store_true",
                   help="the host (PIL) augmentation path in place of the "
                        "card's, for an augmentation A/B")
    p.add_argument("--hires", action="store_true",
                   help="160px source, 96/48px crops (nano only): the "
                        "full PIL recipe's blur leaves the fill texture")
    p.add_argument("--min_gain", type=float, default=None,
                   help="required (after - before) k-NN gain in points; "
                        "default the reference's bar")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="run the teacher k-NN eval every N steps")
    p.add_argument("--max_seconds", type=float, default=None,
                   help="stop training after this wall-clock budget (the "
                        "final eval and gate still run)")
    p.add_argument("--lr", type=float, default=None,
                   help="peak learning rate (default 8e-3 shapes, 4e-3 "
                        "shapes_hard)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the initial weights, the crops and the "
                        "drop-path draws (the datasets stay fixed)")
    p.add_argument("--no-fused", dest="fused", action="store_false",
                   help="Swin: fused_block_stages=(); ViL: fused_sc='off'; "
                        "CvT has no kernel route")
    args = p.parse_args(argv)
    res = validate(steps=args.steps, batch=args.batch, size=args.size,
                   backbone=args.backbone, dense=args.dense, task=args.task,
                   eval_every=args.eval_every, max_seconds=args.max_seconds,
                   lr=args.lr, fused=args.fused,
                   device="cpu" if args.cpu else "cuda", seed=args.seed,
                   host_aug=args.host_aug, hires=args.hires)
    before, after = res["before"], res["after"]
    ms = res["seconds"] / max(res["steps"], 1) * 1e3
    print(f"\nresult: {before:.1f}% -> {after:.1f}% ({res['steps']} steps, "
          f"{res['seconds']:.0f}s, {ms:.1f} ms/step, feed wait "
          f"{res['feed_wait_seconds']:.1f}s, task={args.task}, "
          f"backbone={args.backbone}, fused={args.fused}, seed={args.seed}, "
          f"host_aug={args.host_aug}, hires={args.hires})",
          flush=True)
    min_gain = (args.min_gain if args.min_gain is not None
                else min_gain_for(args.task, args.steps, args.backbone))
    # Absolute sanity first: the relative gate alone can pass on near-noise
    # gains; a NaN loss or below-chance accuracy is always a bug.
    last_loss = res["last_loss"]
    assert math.isfinite(last_loss), f"final loss is not finite: {last_loss}"
    chance = 100.0 / (16 if args.task == "shapes_hard" else 4)
    assert after > chance * 1.25, (
        f"post-training k-NN {after:.1f}% is not above chance "
        f"({chance:.1f}%) by 25% — model is not learning at all")
    assert after > before + min_gain, (
        f"training gain {after - before:.1f} < required {min_gain}")
    print("LEARNING VALIDATION PASSED", flush=True)
    return res


if __name__ == "__main__":
    main()
