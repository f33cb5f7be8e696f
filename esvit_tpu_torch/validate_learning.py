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
    python -m esvit_tpu_torch.validate_learning --task shapes_hard \\
        --steps 6000 --seeds 0-7 --jobs 3     # a sweep: one leg a seed

Gates (the reference's, from its TPU rounds): shapes_hard at >= 5000
steps requires +10 k-NN points for Swin and +6 for ViL; shorter runs are
divergence canaries (+2 Swin, -1 ViL); the CvT leg has no measured
margin yet and is a canary at every length (-1); shapes requires +5.
Always: a finite last loss and a final accuracy above 1.25x chance.

A sweep (``--seeds``) runs the single-seed command once a seed, ``--jobs``
legs at once, and judges the gains by their mean and its standard error:
met if mean >= bar, fault if mean + 2 SE < bar, else unresolved. It exits
1 on a fault or on a leg that printed no k-NN gain.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import math
import os
import re
import subprocess
import sys
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


# A leg is this module run as a program: one single-seed gate.
LEG_COMMAND = (sys.executable, "-m", "esvit_tpu_torch.validate_learning")
_KNN_LINE = re.compile(r"^\[(random init|trained)\] 10-NN top-1: "
                       r"([-+0-9.eE]+|nan)%$", re.M)


def parse_seeds(text: str) -> list[int]:
    """``'0-7'``, ``'0,3,5'`` or a mix (``'0-2,9'``) -> the seeds in order.
    Refuses an empty list, a descending range and a repeated seed."""
    seeds = []
    for part in text.split(","):
        m = re.fullmatch(r"\s*(\d+)\s*(?:-\s*(\d+)\s*)?", part)
        if m is None:
            raise ValueError(f"not a seed or a range of seeds: {part!r}")
        lo = int(m.group(1))
        hi = lo if m.group(2) is None else int(m.group(2))
        if hi < lo:
            raise ValueError(f"descending range {part.strip()!r}")
        seeds += range(lo, hi + 1)
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"a seed is repeated in {text!r}")
    return seeds


def leg_argv(args: argparse.Namespace, seed: int) -> list[str]:
    """The single-seed command line of one leg of the sweep ``args``."""
    argv = ["--steps", str(args.steps), "--batch", str(args.batch),
            "--size", args.size, "--backbone", args.backbone,
            "--task", args.task, "--eval_every", str(args.eval_every),
            "--seed", str(seed)]
    for flag, value in (("--min_gain", args.min_gain),
                        ("--max_seconds", args.max_seconds),
                        ("--lr", args.lr)):
        if value is not None:
            argv += [flag, repr(value)]
    for flag, on in (("--no-dense", not args.dense),
                     ("--host_aug", args.host_aug), ("--hires", args.hires),
                     ("--cpu", args.cpu), ("--no-fused", not args.fused)):
        if on:
            argv.append(flag)
    return argv


def leg_gain(output: str) -> float | None:
    """after - before from a leg's printed k-NN lines, None if it printed
    no trained accuracy (the leg crashed before its last eval)."""
    acc = dict(_KNN_LINE.findall(output))
    if "random init" not in acc or "trained" not in acc:
        return None
    return float(acc["trained"]) - float(acc["random init"])


def summarize(gains: list[float], bar: float) -> dict:
    """The gains' mean, sample SD, SE = SD / sqrt(n) and the verdict:
    'met' if mean >= bar, 'fault' if mean + 2 SE < bar, else
    'unresolved' (one gain has no SD, so it is met or unresolved)."""
    n = len(gains)
    mean = sum(gains) / n if n else math.nan
    sd = (math.sqrt(sum((g - mean) ** 2 for g in gains) / (n - 1))
          if n > 1 else math.nan)
    se = sd / math.sqrt(n) if n > 1 else math.nan
    if mean >= bar:
        verdict = "met"
    elif mean + 2 * se < bar:
        verdict = "fault"
    else:
        verdict = "unresolved"
    return {"n": n, "mean": mean, "sd": sd, "se": se, "verdict": verdict}


def run_sweep(args: argparse.Namespace, seeds: list[int],
              bar: float) -> dict:
    """Runs ``LEG_COMMAND + leg_argv(args, seed)`` for every seed,
    ``args.jobs`` at once; prints each leg's ``result:`` line as it ends
    and one summary line. A leg that fails its gate or crashes is
    recorded, not fatal. With ``args.log_dir`` each leg's output streams
    to ``<backbone>_seed<s>.log`` there, headed by its command line and
    ended by its exit code; a finished log of the same command line is
    read in place of running the leg again, so a sweep cut short (by a
    time limit) resumes where it stopped. Returns the summary with each
    seed's gain (None: crashed) and exit code, and the sweep's own exit
    code."""
    log_dir = args.log_dir
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    # Legs at once share the host's cores: each gets its share of intra-op
    # threads (PyTorch's CPU pool spins, and oversubscribed it crawls).
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // args.jobs)))

    def leg(seed):
        argv = [*LEG_COMMAND, *leg_argv(args, seed)]
        if not log_dir:
            proc = subprocess.run(argv, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            return proc.returncode, proc.stdout, False
        head = "[sweep] leg: " + " ".join(argv[len(LEG_COMMAND):])
        path = os.path.join(log_dir, f"{args.backbone}_seed{seed}.log")
        if os.path.exists(path):
            with open(path) as f:
                text = f.read()
            end = re.search(r"^\[sweep\] exit (-?\d+)\n\Z", text, re.M)
            if text.startswith(head + "\n") and end:
                return int(end.group(1)), text, True
        with open(path, "w") as f:
            f.write(head + "\n")
            f.flush()
            rc = subprocess.run(argv, env=env, stdout=f,
                                stderr=subprocess.STDOUT).returncode
            f.write(f"[sweep] exit {rc}\n")
        with open(path) as f:
            return rc, f.read(), False

    legs = {}
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futures = {pool.submit(leg, s): s for s in seeds}
        for fut in concurrent.futures.as_completed(futures):
            seed = futures[fut]
            rc, out, reused = fut.result()
            gain = leg_gain(out)
            legs[seed] = {"gain": gain, "rc": rc}
            lines = [ln for ln in out.strip().splitlines()
                     if not ln.startswith("[sweep] ")]
            result = [ln for ln in lines if ln.startswith("result:")]
            shown = result[-1] if result else "no result line"
            tail = f"; exit {rc}: {lines[-1] if lines else ''}" if rc else ""
            gain_text = "none" if gain is None else f"{gain:+.2f}"
            print(f"[seed {seed}] {shown} gain {gain_text}{tail}"
                  f"{' (read from its log)' if reused else ''}", flush=True)
    ordered = sorted(legs)
    measured = [s for s in ordered if legs[s]["gain"] is not None]
    crashed = [s for s in ordered if legs[s]["gain"] is None]
    summary = summarize([legs[s]["gain"] for s in measured], bar)
    summary.update(legs=legs, bar=bar, crashed=crashed,
                   cleared=sum(legs[s]["rc"] == 0 for s in ordered))
    summary["exit_code"] = int(summary["verdict"] == "fault" or
                               bool(crashed))
    gains = ",".join(f"{s}:{legs[s]['gain']:+.2f}" for s in measured)
    print(f"summary: backbone={args.backbone} task={args.task} "
          f"steps={args.steps} fused={args.fused} "
          f"device={'cpu' if args.cpu else 'cuda'} gains={gains or '-'} "
          f"n={summary['n']} mean={summary['mean']:+.2f} "
          f"sd={summary['sd']:.2f} se={summary['se']:.2f} "
          f"cleared={summary['cleared']}/{len(ordered)} bar={bar:+.1f} "
          f"crashed={','.join(map(str, crashed)) or '-'} "
          f"verdict={summary['verdict']}", flush=True)
    return summary


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
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the initial weights, the crops and the "
                        "drop-path draws (the datasets stay fixed; "
                        "default 0)")
    p.add_argument("--seeds", default=None,
                   help="a sweep: one leg a seed, e.g. 0-7 or 0,3,5; "
                        "prints each leg's result and a summary line "
                        "(mean, SD, SE, verdict)")
    p.add_argument("--jobs", type=int, default=3,
                   help="legs of a sweep at once (on one card)")
    p.add_argument("--log_dir", default=None,
                   help="a sweep writes each leg's whole output here")
    p.add_argument("--no-fused", dest="fused", action="store_false",
                   help="Swin: fused_block_stages=(); ViL: fused_sc='off'; "
                        "CvT has no kernel route")
    args = p.parse_args(argv)
    min_gain = (args.min_gain if args.min_gain is not None
                else min_gain_for(args.task, args.steps, args.backbone))
    if args.seeds is not None:
        if args.seed is not None:
            p.error("--seeds and --seed exclude each other")
        if args.jobs < 1:
            p.error("--jobs must be at least 1")
        try:
            seeds = parse_seeds(args.seeds)
        except ValueError as e:
            p.error(f"--seeds: {e}")
        summary = run_sweep(args, seeds, min_gain)
        if summary["exit_code"]:
            raise SystemExit(summary["exit_code"])
        return summary
    if args.seed is None:
        args.seed = 0
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
