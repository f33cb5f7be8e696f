#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises,
so the script exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit and the
   torch/CUDA versions; TF32 off for the parity checks.
2. Build the window-attention kernels from esvit_tpu_torch/csrc/.
3. Kernel vs plain PyTorch on the card at every shape the Swin-T W=7
   B=32 multi-crop step gives the kernels (bf16, plus one fp32 case):
   forward output and the q/k/v/bias gradients within 3e-2 (bf16) or
   2e-5 (fp32) after normalising each by its max-abs; dbias bit-identical
   on repeat; median times over 20 reps of kernel and plain.
4. The slice: the Swin-T forward with the kernels agrees with the plain
   path on a small fp32 input; then esvit_tpu_torch.train.train.train()
   runs 5 steps of Swin-T W=7, B=32, 2x224 + 8x96 crops, out_dim 65536,
   DDINO, bf16, on-device synthetic data. Losses must be finite; student,
   teacher and both centers must change; the kernels' launch counts must
   equal the per-step count derived from the model times the steps.

The line before the last is the per-kernel JSON record: ``launches`` from
the 5 steps; ``max_abs_err`` the largest max-abs difference from the plain
version over the slice shapes, each divided by the plain result's
max-abs (the quantity held to the tolerance); ``ms`` / ``plain_ms`` the
per-step time at the slice shapes (calls per step x median per call).
The last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
STEPS = 5
REPS = 20
SOURCE = "esvit_tpu_torch/csrc/window_attention.cu"
REPLACES = {"fwd": "esvit_tpu/ops/packed_window_attention.py:305",
            "bwd": "esvit_tpu/ops/packed_window_attention.py:314"}

# (label, windows B_, C, nH, stage resolution H, shifted, dtype name,
#  calls per step: forward, backward). Windows are ws=7; the 224 crops are
# 2B images through teacher and student, the 96 crops 8B images through
# the student. Stages 2-3 at 96px run the sub-window path (no kernel).
SHAPES = [
    ("224 s0", 4096, 96, 3, 56, False, "bf16", 2, 1),
    ("224 s0 shifted", 4096, 96, 3, 56, True, "bf16", 2, 1),
    ("224 s1", 1024, 192, 6, 28, False, "bf16", 2, 1),
    ("224 s1 shifted", 1024, 192, 6, 28, True, "bf16", 2, 1),
    ("224 s2", 256, 384, 12, 14, False, "bf16", 6, 3),
    ("224 s2 shifted", 256, 384, 12, 14, True, "bf16", 6, 3),
    ("224 s3", 64, 768, 24, 7, False, "bf16", 2, 1),
    ("96 s0", 4096, 96, 3, 24, False, "bf16", 1, 1),
    ("96 s0 shifted", 4096, 96, 3, 24, True, "bf16", 1, 1),
    ("96 s1", 1024, 192, 6, 12, False, "bf16", 1, 1),
    ("96 s1 shifted", 1024, 192, 6, 12, True, "bf16", 1, 1),
    ("224 s1 shifted fp32", 1024, 192, 6, 28, True, "fp32", 0, 0),
]
TOL = {"bf16": 3e-2, "fp32": 2e-5}


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build(wa):
    t0 = time.perf_counter()
    report = wa.build()
    if report:
        log(report.strip())
    log(f"build: {time.perf_counter() - t0:.2f} s")


def _median_ms(torch, fn):
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_kernels(torch, wa, wops):
    """Kernel vs plain at the slice's shapes. Returns per-kernel max error
    and the per-step kernel/plain milliseconds (sum over shapes of calls
    per step x median time)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"fwd": 0.0, "bwd": 0.0}
    per_step = {k: {"ms": 0.0, "plain_ms": 0.0} for k in ("fwd", "bwd")}
    scale = 32 ** -0.5
    for label, B_, C, nH, H, shifted, dt, n_fwd, n_bwd in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        N = 49
        region = (torch.as_tensor(wops.window_region_ids(H, H, 7, 3),
                                  device=dev) if shifted else None)
        q, k, v, do = (torch.randn(B_ * N, C, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        bias = 0.3 * torch.randn(nH, N, N, generator=gen, device=dev)

        def grads(fn):
            ts = [t.clone().requires_grad_() for t in (q, k, v, bias)]
            out = fn(*ts, region, N, nH, scale)
            g = torch.autograd.grad(out, ts, do)
            return [out.detach()] + list(g)

        got = grads(wa._WindowAttention.apply)
        again = grads(wa._WindowAttention.apply)
        ref = grads(wa.window_attention_plain)
        if not torch.equal(got[4], again[4]):
            raise AssertionError(f"{label}: dbias differs between two runs")
        errs = []
        for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: kernel {name} not finite")
            s = max(b.float().abs().max().item(), 1e-6)
            errs.append((a.float() - b.float()).abs().max().item() / s)
        if max(errs) > TOL[dt]:
            raise AssertionError(f"{label}: errors {errs} above {TOL[dt]}")
        worst["fwd"] = max(worst["fwd"], errs[0])
        worst["bwd"] = max(worst["bwd"], *errs[1:])

        with torch.no_grad():
            t_fwd = _median_ms(torch, lambda: wa._fwd(q, k, v, bias, region,
                                                     N, nH, scale))
            p_fwd = _median_ms(torch, lambda: wa.window_attention_plain(
                q, k, v, bias, region, N, nH, scale))
        t_bwd = _median_ms(torch, lambda: wa._bwd(q, k, v, bias, region, do,
                                                 N, nH, scale))
        ts = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        out = wa.window_attention_plain(*ts, region, N, nH, scale)
        p_bwd = _median_ms(torch, lambda: torch.autograd.grad(
            out, ts, do, retain_graph=True))
        del out, ts
        for key, t, p, n in (("fwd", t_fwd, p_fwd, n_fwd),
                             ("bwd", t_bwd, p_bwd, n_bwd)):
            per_step[key]["ms"] += n * t
            per_step[key]["plain_ms"] += n * p
        log(f"kernel-vs-plain {label:20s} B_={B_:5d} C={C:3d} nH={nH:2d} "
            f"{dt}: max err out {errs[0]:.2e} dq {errs[1]:.2e} "
            f"dk {errs[2]:.2e} dv {errs[3]:.2e} dbias {errs[4]:.2e} "
            f"(tol {TOL[dt]:.0e}); dbias bit-identical on repeat")
        log(f"  time {label:20s} fwd kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms | bwd kernel {t_bwd:.4f} ms plain "
            f"{p_bwd:.4f} ms")
    return worst, per_step


def phase_forward_parity(torch, C):
    """The Swin-T backbone through the kernels vs the plain path, fp32,
    same weights, 2 images at 224 and 96 px: relative error <= 1e-4."""
    from esvit_tpu_torch.models.swin import SwinTransformer

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    packed = SwinTransformer(C.swin_tiny(drop_path_rate=0.0),
                             generator=gen).to(dev)
    plain = SwinTransformer(C.swin_tiny(drop_path_rate=0.0,
                                        attention_impl="xla")).to(dev)
    plain.load_state_dict(packed.state_dict())
    for size in (224, 96):
        x = torch.randn(2, size, size, 3, generator=gen).to(dev)
        with torch.no_grad():
            a = packed.forward_features(x)[1]
            b = plain.forward_features(x)[1]
        err = ((a - b).abs().max() / b.abs().max()).item()
        if not (torch.isfinite(a).all() and err <= 1e-4):
            raise AssertionError(f"forward {size}px: kernel vs plain {err:.2e}")
        log(f"swin-t forward_features {size}px fp32: kernel vs plain "
            f"rel err {err:.2e} (tol 1e-4), shape {tuple(a.shape)}")


def phase_slice(torch, C, wa, card, out_dir):
    from esvit_tpu_torch.models.swin import SwinTransformer
    from esvit_tpu_torch.train.train import train

    cfg = C.swin_tiny_multicrop(BATCH, output_dir=out_dir)
    probe = SwinTransformer(cfg.model)
    g, l = cfg.crops.global_size, cfg.crops.local_size
    want_fwd = (2 * probe.window_attention_calls(g)
                + probe.window_attention_calls(l)) * STEPS
    want_bwd = (probe.window_attention_calls(g)
                + probe.window_attention_calls(l)) * STEPS
    del probe
    init = _initial_weights(torch, cfg)

    wa.launches["fwd"] = wa.launches["bwd"] = 0
    state, history = train(cfg, max_steps=STEPS, device="cuda")
    torch.cuda.synchronize()
    got = dict(wa.launches)

    losses = [h["loss"] for h in history]
    if len(losses) != STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses {losses}")
    if got != {"fwd": want_fwd, "bwd": want_bwd}:
        raise AssertionError(f"launches {got}, model-derived "
                             f"{{'fwd': {want_fwd}, 'bwd': {want_bwd}}}")
    moved = {
        "student": _max_change(torch, state.student, init),
        "teacher": _max_change(torch, state.teacher, init),
        "center": state.centers.center.abs().max().item(),
        "center_grid": state.centers.center_grid.abs().max().item(),
    }
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"state did not change: {moved}")
    ms = statistics.mean(h["seconds"] for h in history[1:]) * 1e3
    ips = cfg.crops.ncrops * BATCH / (ms / 1e3)
    log(f"slice: losses {losses}")
    log(f"slice: max change {moved}")
    log(f"slice: launches {got} (model-derived per step: fwd "
        f"{want_fwd // STEPS}, bwd {want_bwd // STEPS})")
    log(f"slice: Swin-T W=7 B={BATCH} 2x224+8x96 DDINO out_dim 65536 bf16: "
        f"{ms:.1f} ms/step, {ips:.1f} img/s over steps 2-{STEPS} "
        f"[{card}]")
    log(f"slice: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return got


def _initial_weights(torch, cfg):
    """The student's initial weights, as train() draws them (seed cfg.seed)."""
    from esvit_tpu_torch.train.step import EsViTTrainer

    model = EsViTTrainer(cfg).build_model(
        torch.Generator().manual_seed(cfg.seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _max_change(torch, model, init):
    return max((p.detach().cpu() - init[n]).abs().max().item()
               for n, p in model.state_dict().items())


def main():
    if not os.path.isdir(os.path.join(ROOT, "esvit_tpu_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repo: "
                           "esvit_tpu_torch/ is not beside it")
    sys.path.insert(0, ROOT)
    import torch

    card = phase_device(torch)
    from esvit_tpu_torch import config as C
    from esvit_tpu_torch.ops import window as wops
    from esvit_tpu_torch.ops import window_attention as wa

    phase_build(wa)
    worst, per_step = phase_kernels(torch, wa, wops)
    phase_forward_parity(torch, C)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        launches = phase_slice(torch, C, wa, card, out_dir)
    record = {"kernels": [
        {"name": f"window_attention_{k}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": worst[k], "ms": per_step[k]["ms"],
         "plain_ms": per_step[k]["plain_ms"]} for k in ("fwd", "bwd")]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
