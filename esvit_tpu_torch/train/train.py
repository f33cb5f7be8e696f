"""Training loop (port of esvit_tpu/train/train.py ``train``).

Builds the trainer, draws random weights from ``cfg.seed``, and runs the
epoch loop over on-device synthetic batches (data kind
``synthetic_device``) with the NaN guard and MetricLogger lines. The
real-data kinds are ROADMAP queue 1 item 6; checkpoint save/resume, the
SIGTERM save, the CLI and multi-card runs are item 8. ``train`` raises
NotImplementedError when asked for them.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from esvit_tpu_torch.config import TrainConfig
from esvit_tpu_torch.data.loader import synthetic_batches
from esvit_tpu_torch.train.step import EsViTTrainer, TrainState
from esvit_tpu_torch.utils.metrics import MetricLogger, append_log


def train(cfg: TrainConfig, *, data_kind: str = "synthetic_device",
          dataset=None, resume: bool = False, max_steps: int | None = None,
          device: torch.device | str = "cuda"
          ) -> tuple[TrainState, list[dict]]:
    """Train on one device. Returns the final state and one record per
    step: {'step', 'loss', 'lr', 'wd', 'grad_norm', 'seconds'}, where
    'seconds' is the host time from the previous step's end, each step
    ending when its loss reaches the host."""
    if dataset is not None or data_kind != "synthetic_device":
        raise NotImplementedError(
            f"data_kind={data_kind!r}: only 'synthetic_device' is ported "
            "(real data: ROADMAP queue 1 item 6)")
    if resume:
        raise NotImplementedError("checkpoint resume is not ported yet "
                                  "(ROADMAP queue 1 item 8)")
    device = torch.device(device)
    B = cfg.optim.batch_size_per_device
    steps_per_epoch = max(cfg.steps_per_epoch, 1)
    trainer = EsViTTrainer(cfg, total_batch_size=B, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)

    history: list[dict] = []
    images_per_step = cfg.crops.ncrops * B
    for epoch in range(state.step // steps_per_epoch, cfg.optim.epochs):
        logger = MetricLogger()
        header = f"Epoch: [{epoch}/{cfg.optim.epochs}]"
        batches = synthetic_batches(cfg.crops, B, steps=steps_per_epoch,
                                    seed=cfg.seed + epoch, device=device)
        step_t0 = time.perf_counter()
        for batch in logger.log_every(batches, 10, header):
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
                   "seconds": now - step_t0}
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
