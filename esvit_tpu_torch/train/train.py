"""Pre-training orchestrator and CLI: the ``main_esvit.py`` equivalent
(port of esvit_tpu/train/train.py).

    python -m esvit_tpu_torch.train.train --arch swin_tiny --data_kind synthetic
    python -m esvit_tpu_torch.train.train --arch swin_femto --device cpu ...

Flow (ref: main_esvit.py:210-496 train_esvit): the (data, model) grid
over the process group (parallel/mesh.py) -> data -> trainer (model, optimizer,
schedules) -> an optional initialisation from a checkpoint, then local
auto-resume -> the epoch loop, with the NaN guard (a named debug
checkpoint, then exit 1; main_esvit.py:546-562), the SIGTERM save (a
checkpoint at the next step boundary, then exit 0; the ranks agree on a
signal that any of them got, so all save and exit), a checkpoint after
every epoch and the JSON-lines log, both written by rank 0. Several
processes: ``--distributed`` (launch.py), one process per card, each
data index feeding its ``1 / data`` share of every batch. With
``--mesh_model`` m > 1 (the DINO head's tensor parallelism) the world is
data x m: the m ranks of a data index take the same crops, the same
drop-path and mixup draws (seeded by the data index, so the replicated
backbone stays one), and each holds 1 / m of the heads' last layers; the
global batch and the LR scale with the data axis, as esvit_tpu's
(esvit_tpu/train/train.py:75-83). A checkpoint is whole: the first data
index's model ranks gather the head's rows, and rank 0 writes the file
that a run of one process writes; any grid restores it. The run is on
the card unless the caller asks for the CPU (``--device cpu``).

The data: ``--data_kind`` synthetic (random noise images), folder
(``--data_path``), zip (``--data_path`` and ``--zip_map_file``) or tsv
(``--data_path``), decoded on the host (JPEGs by the native library,
native/) and augmented on the card, or with ``--host_aug`` by the full
PIL pipeline on the host; composite_tsv and openimages_tsv take lists of
paths, which only ``train(data_kwargs=...)`` passes. ``--use_mixup``
mixes the first student views (data/mixup.py). ``--arch`` takes every
preset of config.py: Swin, ViL, CvT (cvt_femto, cvt_tiny) and ViT/DeiT
(deit_tiny, deit_small, vit_base). An fp32 run (``--no-bf16``) turns
cuDNN's TF32 off for its process (models/common.py
``exact_fp32_convolutions``). ``--optimizer sgd|lars``,
``--use_bn_in_head`` and ``--frozen_layers`` run as esvit_tpu's; the
ResNet family has no preset (esvit_tpu's CLI has none either) and is
trained from Python, ``train(TrainConfig(model=ResNetConfig(depth=50),
...))``.
"""

from __future__ import annotations

import argparse
import math
import os
import random
import signal
import subprocess
import sys
import time
from typing import Any

import torch

from esvit_tpu_torch import config as config_lib
from esvit_tpu_torch.data import datasets as datasets_lib
from esvit_tpu_torch.data import mixup as mixup_lib
from esvit_tpu_torch.data.loader import build_train_iterator, synthetic_batches
from esvit_tpu_torch.io.checkpoint import CheckpointManager
from esvit_tpu_torch.models.common import exact_fp32_convolutions
from esvit_tpu_torch.models.vil import PER_LAYER_MODE
from esvit_tpu_torch.parallel import mesh as mesh_lib
from esvit_tpu_torch.train.step import EsViTTrainer, TrainState
from esvit_tpu_torch.utils.metrics import MetricLogger, append_log


def git_sha() -> str:
    """Repo SHA stamping for logs (ref: utils.py:378-395 get_sha)."""
    cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=cwd,
            stderr=subprocess.DEVNULL).decode().strip()
        dirty = subprocess.call(["git", "diff-index", "--quiet", "HEAD"],
                                cwd=cwd, stderr=subprocess.DEVNULL)
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    return sha + (" (dirty)" if dirty else "")


def save_checkpoint(ckpt: CheckpointManager, state: TrainState,
                    mesh: mesh_lib.Mesh, **kw) -> None:
    """``ckpt.save`` (rank 0 writes), with one line saying what was
    written, its size and the seconds it took. Every rank calls it."""
    t0 = time.perf_counter()
    paths = ckpt.save(state, mesh=mesh, **kw)
    if not paths:
        return
    seconds = time.perf_counter() - t0
    size = os.path.getsize(paths[0])
    print(f"checkpoint: {', '.join(map(os.path.basename, paths))} at step "
          f"{state.step}, {size} bytes, {seconds:.3f} s", flush=True)


def vil_mode_schedule(cfg: config_lib.TrainConfig, steps_per_epoch: int):
    """``modes_for(step) -> (mode, teacher_mode)``, the ViL neighbour
    sampling schedule of esvit_tpu's train() (esvit_tpu/train/train.py:
    125-142, the reference's VIL_MODE_SWITCH): with ``cfg.model.mode`` >
    0, each step before ``int(mode_switch * epochs * steps_per_epoch)``
    draws the student's mode and then the teacher's, each uniform on 1-8,
    from ``random.Random(cfg.seed)`` (or gives (9, 9), each layer's own
    draw, with ``per_layer_mode``); every later step, and every step of
    another backbone, is (0, 0). Call it once per step, in order: the
    draws come in sequence. A resumed run starts them again from the
    seed, as esvit_tpu's does."""
    m = cfg.model
    mode = getattr(m, "mode", 0)
    switch = int(getattr(m, "mode_switch", 0.0) * cfg.optim.epochs
                 * steps_per_epoch)
    per_layer = getattr(m, "per_layer_mode", False)
    rng = random.Random(cfg.seed)

    def modes_for(step: int) -> tuple[int, int]:
        if mode > 0 and step < switch:
            if per_layer:
                return PER_LAYER_MODE, PER_LAYER_MODE
            return rng.randrange(1, 9), rng.randrange(1, 9)
        return 0, 0
    return modes_for


def train(cfg: config_lib.TrainConfig, *, data_kind: str = "synthetic_device",
          dataset=None, data_kwargs: dict | None = None,
          host_aug: bool = False, native_decode: bool | None = None,
          resume: bool = True,
          max_steps: int | None = None, profile_dir: str | None = None,
          init_from: str | None = None, device: torch.device | str = "cuda"
          ) -> tuple[TrainState, list[dict]]:
    """Train over the process group's cards (one process, no group: one
    card). Returns the final state and one record per step: {'step',
    'loss', 'lr', 'wd', 'grad_norm', 'seconds', 'data_seconds', 'modes'},
    where 'modes' is the step's (mode, teacher_mode) of a ViL backbone's
    neighbour sampling (:func:`vil_mode_schedule`) and
    'seconds' is the host time from the previous step's end, each step
    ending when its loss reaches the host, and 'data_seconds' the part of
    it spent taking the batch from the feed; fed from a dataset, also
    'native_images' and 'pil_images', the samples of the step's batch
    that the native library and PIL decoded. The first record of each
    epoch also holds 'inputs', what ``input_stats`` reads of the batch
    that step consumed.

    data_kind / data_kwargs: ``datasets.build_dataset``'s, or
    'synthetic_device' (random crops drawn on the card). host_aug: the
    full-PIL DINO augmentation on the host in place of the card's.
    native_decode: the feed's JPEG decode by the native library (None:
    where it builds; MultiCropIterator's).
    ``cfg.mixup`` (enabled) mixes the first student views, with draws
    from a CPU generator seeded ``cfg.seed + 2 + rank``.

    With a dataset of at least B images (B the global per-view batch) an
    epoch is ``len(dataset) // B`` steps, as in esvit_tpu; else
    ``cfg.steps_per_epoch``. ``resume`` restores ``cfg.output_dir``'s
    checkpoint.pth and starts at epoch ``step // steps_per_epoch``, from
    its first batch; ``init_from`` (a checkpoint file) is loaded first, as
    an initialisation that a local checkpoint overrides. ``profile_dir``
    receives a torch.profiler trace of the first epoch (trace.json)."""
    print(f"git: {git_sha()}", flush=True)
    mesh = mesh_lib.make_mesh(cfg.mesh)
    B = cfg.optim.batch_size_per_device * mesh.data    # global per-view batch
    B_local = B // mesh.data                           # this process's share
    if dataset is None and data_kind != "synthetic_device":
        dataset = datasets_lib.build_dataset(data_kind, **(data_kwargs or {}))
    device = torch.device(device)
    if cfg.dtype == torch.float32:
        exact_fp32_convolutions()
    # Every data index walks a disjoint 1 / data shard of B_local samples
    # per step, so all agree on len // B steps (DistributedSampler semantics).
    steps_per_epoch = (len(dataset) // B
                       if dataset is not None and len(dataset) >= B
                       else cfg.steps_per_epoch)
    steps_per_epoch = max(steps_per_epoch, 1)
    cfg = cfg.replace(steps_per_epoch=steps_per_epoch)
    trainer = EsViTTrainer(cfg, total_batch_size=B, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))

    ckpt = CheckpointManager(cfg.output_dir)
    if init_from:
        init = CheckpointManager(os.path.dirname(os.path.abspath(init_from)))
        if init.restore(state, os.path.basename(init_from),
                        mesh=mesh) is not None:
            print(f"initialized from {init_from} (step {state.step})",
                  flush=True)
        else:
            print(f"WARNING: init_from {init_from} not found", flush=True)
    if resume and ckpt.restore(state, mesh=mesh) is not None:
        print(f"resumed from step {state.step}", flush=True)
    # Drop-path masks (and ViL's per-layer neighbour draws): one stream
    # per data index, so the model ranks of one draw alike.
    drop_gen = torch.Generator(device=device).manual_seed(
        cfg.seed + 1 + mesh.data_index)
    modes_for = vil_mode_schedule(cfg, steps_per_epoch)
    mix = cfg.mixup if cfg.mixup is not None and cfg.mixup.enabled else None
    mix_gen = torch.Generator().manual_seed(cfg.seed + 2 + mesh.data_index)
    c = cfg.crops
    view_sizes = ([(c.global_size, c.global_size)] * 2
                  + [(c.local_size, c.local_size)] * c.local_crops_number)

    # Preemption: SIGTERM checkpoints at the next step boundary and exits
    # 0, so the relaunched job resumes from it.
    preempted = []

    def on_sigterm(signum, frame):
        preempted.append(signum)
        print("SIGTERM received: checkpointing at next step boundary",
              flush=True)

    previous = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        previous = None        # not the main thread (e.g. a test runner's)

    profiler = None
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()

    history: list[dict] = []
    images_per_step = cfg.crops.ncrops * B
    try:
        for epoch in range(state.step // steps_per_epoch, cfg.optim.epochs):
            logger = MetricLogger()
            header = f"Epoch: [{epoch}/{cfg.optim.epochs}]"
            feed = None
            if dataset is not None:
                feed = build_train_iterator(
                    dataset, cfg.crops, B_local, epoch=epoch, seed=cfg.seed,
                    host_aug=host_aug, native_decode=native_decode,
                    process_index=mesh.data_index,
                    process_count=mesh.data, device=device)
                source = iter(feed)
                decoded = (0, 0)
            else:
                source = synthetic_batches(cfg.crops, B_local,
                                           steps=steps_per_epoch,
                                           seed=cfg.seed + epoch,
                                           device=device)
            data_s = [0.0]
            batches = _timed(source, data_s)
            step_t0 = time.perf_counter()
            first = True
            try:
                for batch in logger.log_every(batches, 10, header):
                    inputs = input_stats(batch) if first else None
                    first = False
                    draws = (mixup_lib.draw_multicrop(mix_gen, mix,
                                                      view_sizes)
                             if mix is not None else None)
                    modes = modes_for(state.step)
                    state, metrics = trainer.train_step(
                        state, batch, drop_gen, draws, mode=modes[0],
                        teacher_mode=modes[1])
                    loss = float(metrics["loss"])
                    if not math.isfinite(loss):
                        # NaN guard (main_esvit.py:546-562): dump a debug
                        # checkpoint, exit.
                        print(f"Loss is {loss}, stopping training",
                              flush=True)
                        save_checkpoint(ckpt, state, mesh, epoch=epoch,
                                        force_named=True)
                        sys.exit(1)
                    now = time.perf_counter()
                    rec = {"step": state.step, "loss": loss,
                           "lr": metrics["lr"], "wd": metrics["wd"],
                           "grad_norm": float(metrics["grad_norm"]),
                           "seconds": now - step_t0,
                           "data_seconds": data_s[0], "modes": modes}
                    if feed is not None:
                        rec["native_images"] = feed.native_images - decoded[0]
                        rec["pil_images"] = feed.pil_images - decoded[1]
                        decoded = (feed.native_images, feed.pil_images)
                    if inputs is not None:
                        rec["inputs"] = inputs
                    history.append(rec)
                    logger.update(loss=loss, lr=rec["lr"], wd=rec["wd"],
                                  grad_norm=rec["grad_norm"],
                                  img_per_sec=images_per_step
                                  / max(rec["seconds"], 1e-9))
                    step_t0 = now
                    # Every rank acts on a SIGTERM that any rank got:
                    # the save is a collective over the model group.
                    if mesh.any(bool(preempted), device):
                        save_checkpoint(ckpt, state, mesh, epoch=epoch)
                        print(f"checkpointed at step {state.step}; exiting "
                              "for preemption", flush=True)
                        sys.exit(0)
                    if max_steps is not None and state.step >= max_steps:
                        break
            finally:
                batches.close()         # the feed stops its workers
            if profiler is not None:
                profiler.stop()
                os.makedirs(profile_dir, exist_ok=True)
                trace = os.path.join(profile_dir, "trace.json")
                profiler.export_chrome_trace(trace)
                profiler = None
                print(f"profiler trace written to {trace}", flush=True)
            print(f"Averaged stats: {logger}", flush=True)
            save_checkpoint(ckpt, state, mesh, epoch=epoch,
                            save_every_epochs=cfg.save_every_epochs)
            append_log(cfg.output_dir,
                       {"epoch": epoch,
                        **{f"train_{k}": v
                           for k, v in logger.global_avgs().items()}})
            if max_steps is not None and state.step >= max_steps:
                break
    finally:
        if profiler is not None:
            profiler.stop()
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    return state, history


def input_stats(batch) -> dict:
    """Of each of a batch's (global, local) NHWC crops that holds images:
    its device, dtype and shape, whether every value is finite, and each
    channel's mean and std."""
    out = {}
    for name, x in zip(("global", "local"), batch):
        if not x.shape[0]:
            continue
        flat = x.detach().reshape(-1, x.shape[-1]).double()
        out[name] = {"device": x.device.type, "dtype": str(x.dtype),
                     "shape": tuple(x.shape),
                     "finite": bool(torch.isfinite(flat).all()),
                     "mean": flat.mean(0).tolist(),
                     "std": flat.std(0).tolist()}
    return out


def _timed(batches, seconds: list):
    """The generator ``batches``, with seconds[0] set to the time each
    next() took; closing this closes ``batches`` (the feed stops its
    workers)."""
    try:
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                return
            seconds[0] = time.perf_counter() - t0
            yield batch
    finally:
        batches.close()


def get_args_parser():
    """esvit_tpu's flags with its defaults, plus ``--device``."""
    p = argparse.ArgumentParser("esvit_tpu_torch pretrain",
                                description="EsViT SSL pre-training on the "
                                            "card")
    p.add_argument("--arch", default="swin_tiny",
                   choices=sorted(config_lib.PRESETS))
    p.add_argument("--window_size", default=7, type=int)
    p.add_argument("--out_dim", default=65536, type=int)
    p.add_argument("--norm_last_layer", default=False,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--use_bn_in_head", default=False,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--use_dense_prediction", default=True,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--momentum_teacher", default=0.996, type=float)
    p.add_argument("--warmup_teacher_temp", default=0.04, type=float)
    p.add_argument("--teacher_temp", default=0.07, type=float)
    p.add_argument("--warmup_teacher_temp_epochs", default=30, type=int)
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--lr", default=5e-4, type=float)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--weight_decay", default=0.04, type=float)
    p.add_argument("--weight_decay_end", default=0.4, type=float)
    p.add_argument("--clip_grad", default=3.0, type=float)
    p.add_argument("--freeze_last_layer", default=1, type=int)
    p.add_argument("--frozen_layers", nargs="*", default=[],
                   help="parameter subtrees frozen for the whole run "
                        "(esvit_tpu's keys: patch_embed, layers_0, "
                        "layers_0/blocks_1, layers.0, head, or *)")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "sgd", "lars"],
                   help="adamw (one fused pass), or sgd / lars in "
                        "esvit_tpu's optax order")
    p.add_argument("--batch_size_per_device", default=32, type=int)
    p.add_argument("--global_crops_scale", nargs=2, type=float,
                   default=(0.4, 1.0))
    p.add_argument("--local_crops_scale", nargs=2, type=float,
                   default=(0.05, 0.4))
    p.add_argument("--local_crops_number", default=8, type=int)
    p.add_argument("--local_crops_size", default=96, type=int)
    p.add_argument("--use_mixup", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="mixup / CutMix on the first --num_mixup_views "
                        "student views (mixup-SSL)")
    p.add_argument("--num_mixup_views", default=2, type=int)
    p.add_argument("--mixup", default=0.8, type=float)
    p.add_argument("--cutmix", default=1.0, type=float)
    p.add_argument("--mixup_prob", default=1.0, type=float)
    p.add_argument("--mixup_switch_prob", default=0.5, type=float)
    p.add_argument("--smoothing", default=0.0, type=float)
    p.add_argument("--data_kind", default="synthetic",
                   choices=["synthetic", "folder", "zip", "tsv",
                            "composite_tsv", "openimages_tsv"],
                   help="composite_tsv and openimages_tsv take lists of "
                        "paths, which only train(data_kwargs=...) passes")
    p.add_argument("--data_path", default="")
    p.add_argument("--zip_map_file", default="")
    p.add_argument("--host_aug", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="the full PIL augmentation on the host in place "
                        "of the photometrics on the card")
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--saveckp_freq", default=5, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--mesh_model", default=1, type=int,
                   help="tensor-parallel axis size for the DINO head: the "
                        "heads' last layers split over this many processes "
                        "(it divides the world size; world = data x model)")
    p.add_argument("--bf16", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--max_steps", default=None, type=int)
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the first epoch")
    p.add_argument("--pretrained_weights_ckpt", default="",
                   help="checkpoint loaded as initialization before local "
                        "auto-resume (continued_from recipes)")
    p.add_argument("--distributed", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="torch.distributed over the processes that the "
                        "environment describes (launch.py)")
    p.add_argument("--debug_nans", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="torch.autograd.set_detect_anomaly: trap the op "
                        "producing the first NaN (TRAIN.DETECT_ANOMALY)")
    p.add_argument("--device", default="cuda",
                   help="cuda (one card per process) or cpu")
    return p


def config_from_args(args) -> config_lib.TrainConfig:
    model = config_lib.get_model_config(
        args.arch, **({"window_size": args.window_size}
                      if args.arch.startswith("swin") else {}))
    return config_lib.TrainConfig(
        model=model,
        head=config_lib.HeadConfig(out_dim=args.out_dim,
                                   use_bn=args.use_bn_in_head,
                                   norm_last_layer=args.norm_last_layer),
        loss=config_lib.LossConfig(
            out_dim=args.out_dim,
            use_dense_prediction=args.use_dense_prediction,
            warmup_teacher_temp=args.warmup_teacher_temp,
            teacher_temp=args.teacher_temp,
            warmup_teacher_temp_epochs=args.warmup_teacher_temp_epochs),
        crops=config_lib.CropConfig(
            global_scale=tuple(args.global_crops_scale),
            local_scale=tuple(args.local_crops_scale),
            local_crops_number=args.local_crops_number,
            local_size=args.local_crops_size),
        optim=config_lib.OptimConfig(
            optimizer=args.optimizer, lr=args.lr, min_lr=args.min_lr,
            warmup_epochs=args.warmup_epochs,
            weight_decay=args.weight_decay,
            weight_decay_end=args.weight_decay_end,
            momentum_teacher=args.momentum_teacher,
            clip_grad=args.clip_grad,
            freeze_last_layer_epochs=args.freeze_last_layer,
            epochs=args.epochs,
            batch_size_per_device=args.batch_size_per_device,
            frozen_layers=tuple(args.frozen_layers)),
        mesh=config_lib.MeshConfig(model=args.mesh_model),
        mixup=(None if not args.use_mixup else mixup_lib.MixupConfig(
            enabled=True, num_mixup_views=args.num_mixup_views,
            mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
            prob=args.mixup_prob, switch_prob=args.mixup_switch_prob,
            label_smoothing=args.smoothing)),
        seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        output_dir=args.output_dir,
        save_every_epochs=args.saveckp_freq,
    )


def data_kwargs_from_args(args) -> dict[str, Any]:
    """build_dataset's arguments for ``--data_kind`` (esvit_tpu's CLI
    mapping). composite_tsv and openimages_tsv take lists of paths that
    esvit_tpu's CLI has no flags for: refused here, as they cannot run
    from its command line either."""
    if args.data_kind == "folder":
        return {"root": args.data_path}
    if args.data_kind == "zip":
        return {"zip_path": args.data_path, "map_file": args.zip_map_file}
    if args.data_kind == "tsv":
        return {"tsv_path": args.data_path}
    if args.data_kind in ("composite_tsv", "openimages_tsv"):
        raise ValueError(
            f"--data_kind {args.data_kind} needs lists of TSV paths, which "
            "the CLI has no flags for (esvit_tpu's neither): call "
            f"train(cfg, data_kind={args.data_kind!r}, data_kwargs=...) "
            "from Python")
    return {}


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    cfg = config_from_args(args)
    # Refuse before any setup (a grid's world is known here without
    # --distributed: one process).
    config_lib.check_supported(cfg, world=None if args.distributed else 1)
    data_kwargs = data_kwargs_from_args(args)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.distributed:
        from esvit_tpu_torch.launch import initialize_distributed

        initialize_distributed(device=args.device)
    try:
        os.makedirs(args.output_dir, exist_ok=True)
        train(cfg, data_kind=args.data_kind, data_kwargs=data_kwargs,
              host_aug=args.host_aug, max_steps=args.max_steps,
              profile_dir=args.profile_dir or None,
              init_from=args.pretrained_weights_ckpt or None,
              device=args.device)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
