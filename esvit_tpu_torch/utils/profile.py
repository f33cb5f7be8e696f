"""Where the port's train step spends its time on the card.

    python -m esvit_tpu_torch.utils.profile
        [--model swin_tiny|swin_tiny_w14|vil_tiny|cvt_tiny|deit_small]
        [--batch 32] [--steps 3] [--trace step_trace.json]

Runs the Swin-T W=7 (config.swin_tiny_multicrop), the Swin-T W=14 (the
same recipe at window_size=14), the ViL-T
(config.vil_tiny_multicrop), the CvT-T (config.cvt_tiny_multicrop) or
the DeiT-S (config.deit_small_multicrop) multi-crop DDINO step: two warm-up steps, ``--steps`` timed steps without the profiler (host
clock, each ending in a loss fetch), then ``--steps`` steps under
torch.profiler. Prints, per step: the untraced step time; the kernels'
summed device time and the device idle share against the untraced step
(one stream, so kernels do not overlap); the GPU-timeline length of each
``esvit/*`` span of train_step (the backward's kernels run on the
autograd engine's thread, outside any span: they are the busy time left
over); device time by kernel group; and the top kernels. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch

from esvit_tpu_torch import config as config_lib
from esvit_tpu_torch.data.loader import synthetic_batches
from esvit_tpu_torch.train.step import EsViTTrainer


def _swin_tiny_w14_multicrop(batch_size):
    return config_lib.swin_tiny_multicrop(batch_size).replace(
        model=config_lib.swin_tiny(window_size=14))


MODELS = {"swin_tiny": (config_lib.swin_tiny_multicrop, "Swin-T W=7"),
          "swin_tiny_w14": (_swin_tiny_w14_multicrop, "Swin-T W=14"),
          "vil_tiny": (config_lib.vil_tiny_multicrop, "ViL-T"),
          "cvt_tiny": (config_lib.cvt_tiny_multicrop, "CvT-T"),
          "deit_small": (config_lib.deit_small_multicrop, "DeiT-S/16")}


def _kernel_group(name: str) -> str:
    """A kernel's group by its demangled name. The block-fused kernels
    (fused_block_fwd_* for the forward's token tiles F1-F4, fused_bwd_*,
    wgrad_tc, sum_rows for the backward) are tested before the GEMM names;
    both passes' attention halves (A1, A2 and the dbias sum) are the
    window-attention tile kernels instantiated with the fused block's bias
    policy (FusedBlockBias), so they go to the fused block. cuDNN's
    convolutions (CvT's) have a group of their own, before the GEMMs
    (its implicit-GEMM kernels name a gemm)."""
    n = name.lower()
    if "sliding_chunk" in n or "glo_reduce" in n:
        return "sliding chunk (this repo's CUDA)"
    if any(k in n for k in ("fusedblockbias", "fused_block", "fused_bwd",
                            "wgrad_tc", "sum_rows")):
        return "fused block (this repo's CUDA)"
    if "window_attention" in n or "dbias_reduce" in n:
        return "window attention (this repo's CUDA)"
    if any(k in n for k in ("cudnn", "conv", "fprop", "dgrad", "wgrad")):
        return "convolutions (cuDNN)"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "GEMM (cuBLAS)"
    if "reduce" in n or "norm" in n or "softmax" in n:
        return "reductions / norms / softmax"
    return "elementwise / copies / other"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="swin_tiny", choices=sorted(MODELS))
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--trace", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    make_cfg, label = MODELS[args.model]
    cfg = make_cfg(args.batch)
    dev = torch.device("cuda")
    trainer = EsViTTrainer(cfg, total_batch_size=args.batch, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = list(synthetic_batches(cfg.crops, args.batch, steps=1,
                                     device=dev))

    def steps():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = trainer.train_step(state, batches[0], gen)
            float(m["loss"])
        return (time.perf_counter() - t0) * 1e3 / args.steps

    steps()                                                     # warm-up
    step_ms = steps()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_ms = steps()
    if args.trace:
        prof.export_chrome_trace(args.trace)

    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    spans = {e.name for e in device_events if e.name.startswith("esvit/")}
    kernels = [e for e in device_events if e.name not in spans]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    per_step = lambda us: us / 1e3 / args.steps          # noqa: E731
    busy_ms = per_step(sum(k.device_time_total for k in kernels))
    print(f"[{card}] {label} B={args.batch} multi-crop DDINO bf16")
    print(f"step {step_ms:.2f} ms untraced ({traced_ms:.2f} traced); "
          f"kernels {busy_ms:.2f} ms; device idle share "
          f"{1 - busy_ms / step_ms:.3f}")
    span_ms = collections.Counter()
    for e in device_events:
        if e.name in spans:
            span_ms[e.name] += e.device_time_total
    for name, us in sorted(span_ms.items()):
        print(f"  span {name:24s} GPU timeline {per_step(us):8.2f} ms")

    groups = collections.Counter()
    by_name = collections.Counter()
    calls = collections.Counter()
    for k in kernels:
        groups[_kernel_group(k.name)] += k.device_time_total
        by_name[k.name] += k.device_time_total
        calls[k.name] += 1
    for g, us in groups.most_common():
        print(f"  group {g:38s} {per_step(us):8.2f} ms "
              f"({per_step(us) / busy_ms:.1%})")
    for name, us in by_name.most_common(30):
        print(f"  kernel {per_step(us):8.3f} ms x{calls[name] // args.steps:4d}"
              f"/step {name[:90]}")


if __name__ == "__main__":
    main()
