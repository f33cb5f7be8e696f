"""Training loop (port of esvit_tpu/train/train.py ``train``).

Builds the trainer, draws random weights from ``cfg.seed``, and runs the
epoch loop with the NaN guard and MetricLogger lines, over a dataset
(``dataset=``, or ``data_kind`` one of data/datasets.py's kinds with
``data_kwargs``) through one ``MultiCropIterator`` per epoch, augmented on
the device, or over on-device synthetic batches (data kind
``synthetic_device``). The zip/TSV/file-list readers and host
augmentation are ROADMAP queue 1 item 6b; checkpoint save/resume, the
SIGTERM save, the CLI and multi-card runs are item 8. ``train`` raises
NotImplementedError when asked for them.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from esvit_tpu_torch.config import TrainConfig
from esvit_tpu_torch.data import datasets as datasets_lib
from esvit_tpu_torch.data.loader import build_train_iterator, synthetic_batches
from esvit_tpu_torch.train.step import EsViTTrainer, TrainState
from esvit_tpu_torch.utils.metrics import MetricLogger, append_log


def train(cfg: TrainConfig, *, data_kind: str = "synthetic_device",
          dataset=None, data_kwargs: dict | None = None,
          host_aug: bool = False, resume: bool = False,
          max_steps: int | None = None, device: torch.device | str = "cuda"
          ) -> tuple[TrainState, list[dict]]:
    """Train on one device. Returns the final state and one record per
    step: {'step', 'loss', 'lr', 'wd', 'grad_norm', 'seconds',
    'data_seconds'}, where 'seconds' is the host time from the previous
    step's end, each step ending when its loss reaches the host, and
    'data_seconds' the part of it spent taking the batch from the feed.
    The first record of each epoch also holds 'inputs', what
    ``input_stats`` reads of the batch that step consumed.
    With a dataset of at least B images an epoch is ``len(dataset) // B``
    steps, as in esvit_tpu; else ``cfg.steps_per_epoch``."""
    if host_aug:
        raise NotImplementedError("host_aug (the full-PIL DINO pipeline) is "
                                  "not ported yet (ROADMAP queue 1 item 6b)")
    if resume:
        raise NotImplementedError("checkpoint resume is not ported yet "
                                  "(ROADMAP queue 1 item 8)")
    if dataset is None and data_kind != "synthetic_device":
        dataset = datasets_lib.build_dataset(data_kind, **(data_kwargs or {}))
    device = torch.device(device)
    B = cfg.optim.batch_size_per_device
    steps_per_epoch = (len(dataset) // B
                       if dataset is not None and len(dataset) >= B
                       else cfg.steps_per_epoch)
    steps_per_epoch = max(steps_per_epoch, 1)
    cfg = cfg.replace(steps_per_epoch=steps_per_epoch)
    trainer = EsViTTrainer(cfg, total_batch_size=B, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)

    history: list[dict] = []
    images_per_step = cfg.crops.ncrops * B
    for epoch in range(state.step // steps_per_epoch, cfg.optim.epochs):
        logger = MetricLogger()
        header = f"Epoch: [{epoch}/{cfg.optim.epochs}]"
        if dataset is not None:
            batches = iter(build_train_iterator(dataset, cfg.crops, B,
                                                epoch=epoch, seed=cfg.seed,
                                                device=device))
        else:
            batches = synthetic_batches(cfg.crops, B, steps=steps_per_epoch,
                                        seed=cfg.seed + epoch, device=device)
        data_s = [0.0]
        step_t0 = time.perf_counter()
        first = True
        for batch in logger.log_every(_timed(batches, data_s), 10, header):
            inputs = input_stats(batch) if first else None
            first = False
            state, metrics = trainer.train_step(state, batch, drop_gen)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                # NaN guard (main_esvit.py:546-562). The debug checkpoint
                # waits for checkpointing (ROADMAP queue 1 item 8).
                print(f"Loss is {loss}, stopping training", flush=True)
                sys.exit(1)
            now = time.perf_counter()
            rec = {"step": state.step, "loss": loss, "lr": metrics["lr"],
                   "wd": metrics["wd"],
                   "grad_norm": float(metrics["grad_norm"]),
                   "seconds": now - step_t0, "data_seconds": data_s[0]}
            if inputs is not None:
                rec["inputs"] = inputs
            history.append(rec)
            logger.update(loss=loss, lr=rec["lr"], wd=rec["wd"],
                          grad_norm=rec["grad_norm"],
                          img_per_sec=images_per_step / max(rec["seconds"], 1e-9))
            step_t0 = now
            if max_steps is not None and state.step >= max_steps:
                break
        print(f"Averaged stats: {logger}", flush=True)
        append_log(cfg.output_dir,
                   {"epoch": epoch,
                    **{f"train_{k}": v for k, v in logger.global_avgs().items()}})
        if max_steps is not None and state.step >= max_steps:
            break
    return state, history


def input_stats(batch) -> dict:
    """Of each of a batch's (global, local) NHWC crops: its device, dtype
    and shape, whether every value is finite, and each channel's mean and
    std."""
    out = {}
    for name, x in zip(("global", "local"), batch):
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
