#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises,
so the script exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit and the
   torch/CUDA versions; TF32 off for the parity checks.
2. Build both kernel libraries from esvit_tpu_torch/csrc/ (one nvcc each,
   started together) and print nvcc's -Xptxas -v report.
3. Window attention vs plain PyTorch on the card at every full-window
   shape of the Swin-T W=7 B=32 multi-crop step (bf16, plus one fp32
   case): forward output and the q/k/v/bias gradients within 3e-2 (bf16)
   or 2e-5 (fp32) after normalising each by its max-abs; dbias
   bit-identical on repeat; median times over 20 reps of kernel and
   plain.
4. The block-fused kernel pair vs its plain version at every block shape
   the default (fused) route gives it, shifted and unshifted, with
   drop-path scales that drop an image (bf16, plus one fp32 case): the
   output, dx and all 17 parameter gradients within the same tolerances
   (dbk, whose exact value is 0, at the scale of the largest gradient);
   every gradient bit-identical on repeat; median times over 20 reps.
5. Forward parity, fp32, 224 and 96 px, same weights: the default fused
   route, the window-attention route (fused_block_stages=()) and the
   plain route (attention_impl='xla', no fused stages) agree within 1e-4
   relative.
6. The slice: esvit_tpu_torch.train.train.train() runs 5 steps of Swin-T
   W=7, B=32, 2x224 + 8x96 crops, out_dim 65536, DDINO, bf16, on-device
   synthetic data, on the default fused route; then 3 steps of the
   window-attention route in the same process. Losses must be finite;
   student, teacher and both centers must change; each route's launch
   counts of both kernel pairs must equal the per-step counts derived
   from the model times the steps.

The line before the last is the per-kernel JSON record: ``launches`` from
the default route's 5 steps; ``max_abs_err`` the largest max-abs
difference from the plain version over the checked shapes, each divided
by its normaliser (the quantity held to the tolerance); ``ms`` /
``plain_ms`` the per-step time of the default route at the slice shapes
(calls per step x median per call). The last line is
{"ok": true, "device": {...}}.
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
KERNELS = {
    "window_attention": ("esvit_tpu_torch/csrc/window_attention.cu", {
        "fwd": "esvit_tpu/ops/packed_window_attention.py:305",
        "bwd": "esvit_tpu/ops/packed_window_attention.py:314"}),
    "fused_block": ("esvit_tpu_torch/csrc/fused_block.cu", {
        "fwd": "esvit_tpu/ops/fused_block.py:459",
        "bwd": "esvit_tpu/ops/fused_block.py:475"}),
}

# Window attention: (label, windows B_, C, nH, stage resolution H, shifted,
# dtype name, calls per step on the default route: forward, backward).
# Windows are ws=7; the 224 crops are 2B images through teacher and
# student, the 96 crops 8B images through the student. On the default
# route stages 0-2 run block-fused, so only the 224px stage 3 (two
# unshifted blocks) launches these kernels; the other full-window shapes
# are those of the window-attention route and stay checked.
SHAPES = [
    ("224 s0", 4096, 96, 3, 56, False, "bf16", 0, 0),
    ("224 s0 shifted", 4096, 96, 3, 56, True, "bf16", 0, 0),
    ("224 s1", 1024, 192, 6, 28, False, "bf16", 0, 0),
    ("224 s1 shifted", 1024, 192, 6, 28, True, "bf16", 0, 0),
    ("224 s2", 256, 384, 12, 14, False, "bf16", 0, 0),
    ("224 s2 shifted", 256, 384, 12, 14, True, "bf16", 0, 0),
    ("224 s3", 64, 768, 24, 7, False, "bf16", 4, 2),
    ("96 s0", 4096, 96, 3, 24, False, "bf16", 0, 0),
    ("96 s0 shifted", 4096, 96, 3, 24, True, "bf16", 0, 0),
    ("96 s1", 1024, 192, 6, 12, False, "bf16", 0, 0),
    ("96 s1 shifted", 1024, 192, 6, 12, True, "bf16", 0, 0),
    ("224 s1 shifted fp32", 1024, 192, 6, 28, True, "fp32", 0, 0),
]
# Block-fused kernel: (label, images B, C, nH, stage resolution H (0: the
# augmented window of 6x6 tokens + 1 virtual token), shifted, dtype name,
# calls per step: forward, backward). Each stage alternates unshifted and
# shifted blocks; the augmented window carries the shift in its bias.
FUSED_SHAPES = [
    ("224 s0", 64, 96, 3, 56, False, "bf16", 2, 1),
    ("224 s0 shifted", 64, 96, 3, 56, True, "bf16", 2, 1),
    ("224 s1", 64, 192, 6, 28, False, "bf16", 2, 1),
    ("224 s1 shifted", 64, 192, 6, 28, True, "bf16", 2, 1),
    ("224 s2", 64, 384, 12, 14, False, "bf16", 6, 3),
    ("224 s2 shifted", 64, 384, 12, 14, True, "bf16", 6, 3),
    ("96 s0 padded", 256, 96, 3, 24, False, "bf16", 1, 1),
    ("96 s0 padded shifted", 256, 96, 3, 24, True, "bf16", 1, 1),
    ("96 s1 padded", 256, 192, 6, 12, False, "bf16", 1, 1),
    ("96 s1 padded shifted", 256, 192, 6, 12, True, "bf16", 1, 1),
    ("96 s2 augmented", 256, 384, 12, 0, False, "bf16", 6, 6),
    ("224 s1 shifted fp32", 64, 192, 6, 28, True, "fp32", 0, 0),
]
FUSED_GRADS = ("x", "g1", "be1", "wq", "bq", "wk", "bk", "wv", "bv", "bias",
               "wp", "bp", "g2", "be2", "w1", "b1", "w2", "b2")
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


def phase_build(cuda_build):
    t0 = time.perf_counter()
    for name, (lib, report) in cuda_build.build_all(KERNELS).items():
        log(f"built {lib.name}")
        for line in report.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("  " + line.strip())
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


def phase_window_attention(torch, wa, wops):
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


def _fused_case(torch, wops, B, C, nH, H, shifted, dtype, gen):
    """Inputs of one block-fused call at a slice shape, drawn on the card:
    (x, params, keep1, keep2, region, pad, geometry, output gradient).
    H = 0 is the augmented window: 36 real tokens and the virtual token,
    whose pad multiplier is 0 and whose bias row is 0, as the model builds
    them. Both drop-path scales drop one image."""
    dev = torch.device("cuda")
    M = 4 * C
    region = pad = None
    if H == 0:
        N, nW = 37, 1
        pad = torch.ones(N, device=dev)
        pad[-1] = 0.0
    else:
        Hp = -(-H // 7) * 7
        N, nW = 49, (Hp // 7) ** 2
        ss = 3 if shifted else 0
        if shifted:
            region = torch.as_tensor(wops.window_region_ids(H, H, 7, ss),
                                     device=dev)
        if Hp != H:
            pad = torch.as_tensor(wops.pad_token_mask(H, H, Hp, Hp, 7, ss),
                                  device=dev)

    def r(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gen, device=dev)

    params = dict(
        g1=1 + r(C, s=0.1), be1=r(C, s=0.1),
        wq=r(C, C, s=C ** -0.5), bq=r(C, s=0.02),
        wk=r(C, C, s=C ** -0.5), bk=r(C, s=0.02),
        wv=r(C, C, s=C ** -0.5), bv=r(C, s=0.02),
        bias=r(nH, N, N, s=0.05),
        wp=r(C, C, s=C ** -0.5), bp=r(C, s=0.02),
        g2=1 + r(C, s=0.1), be2=r(C, s=0.1),
        w1=r(C, M, s=C ** -0.5), b1=r(M, s=0.02),
        w2=r(M, C, s=M ** -0.5), b2=r(C, s=0.02))
    x, do = r(B, nW * N, C, s=0.5), r(B, nW * N, C)
    if H == 0:
        params["bias"][:, -1] = 0.0
        x[:, -1] = 0.0
        do[:, -1] = 0.0
    keep1 = torch.full((B,), 1 / 0.9, device=dev)
    keep2 = keep1.clone()
    keep1[0] = keep2[-1] = 0.0
    geometry = (N, nH, nW, (C // nH) ** -0.5, 1e-6)
    return (x.to(dtype), params, keep1, keep2, region, pad, geometry,
            do.to(dtype))


def phase_fused(torch, fb, wops):
    """The block-fused pair vs its plain version at the default route's
    block shapes. Returns per-kernel max error and the per-step
    kernel/plain milliseconds."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = fb._lib()
    for N in range(1, 65):
        for C in range(32, fb._MAX_C + 1, 32):
            for nH in (n for n in range(1, C + 1) if C % n == 0):
                if not fb.supports(N, C, nH, 4 * C):
                    continue
                for itemsize in (2, 4):
                    need = lib.esvit_fused_block_smem_bytes(N, C, nH, itemsize)
                    if need > limit:
                        raise AssertionError(
                            f"supports() admits N={N} C={C} nH={nH}, whose "
                            f"{itemsize}-byte block needs {need} bytes of "
                            f"shared memory (card: {limit})")
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"fwd": 0.0, "bwd": 0.0}
    per_step = {k: {"ms": 0.0, "plain_ms": 0.0} for k in ("fwd", "bwd")}
    for label, B, C, nH, H, shifted, dt, n_fwd, n_bwd in FUSED_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, params, k1, k2, region, pad, geo, do = _fused_case(
            torch, wops, B, C, nH, H, shifted, dtype, gen)
        N, _, nW, scale, eps = geo
        kw = dict(N=N, nH=nH, nW=nW, scale=scale, region=region, pad=pad,
                  eps=eps)

        def grads(fn):
            xs = x.clone().requires_grad_()
            ps = {n: t.clone().requires_grad_() for n, t in params.items()}
            out = fn(xs, ps, k1, k2, **kw)
            g = torch.autograd.grad(out, [xs, *ps.values()], do)
            return dict(out=out.detach(), **dict(zip(FUSED_GRADS, g)))

        got, again, ref = (grads(fb.fused_swin_block),
                           grads(fb.fused_swin_block),
                           grads(fb.fused_swin_block_plain))
        gscale = max(ref[n].float().abs().max().item() for n in FUSED_GRADS)
        errs = {}
        for name, a in got.items():
            if not torch.isfinite(a).all():
                raise AssertionError(f"fused {label}: kernel {name} not finite")
            if not torch.equal(a, again[name]):
                raise AssertionError(f"fused {label}: {name} differs between "
                                     "two runs")
            b = ref[name].float()
            s = gscale if name == "bk" else max(b.abs().max().item(), 1e-6)
            errs[name] = (a.float() - b).abs().max().item() / s
        bad = {n: e for n, e in errs.items() if e > TOL[dt]}
        if bad:
            raise AssertionError(f"fused {label}: errors {bad} above {TOL[dt]}")
        worst["fwd"] = max(worst["fwd"], errs["out"])
        worst["bwd"] = max(worst["bwd"], *(errs[n] for n in FUSED_GRADS))
        del got, again, ref

        with torch.no_grad():
            t_fwd = _median_ms(torch, lambda: fb._fwd(
                x, params, k1, k2, region, pad, geo))
            p_fwd = _median_ms(torch, lambda: fb.fused_swin_block_plain(
                x, params, k1, k2, **kw))
        t_bwd = _median_ms(torch, lambda: fb._bwd(
            x, params, k1, k2, region, pad, do, geo))
        xs = x.clone().requires_grad_()
        ps = {n: t.clone().requires_grad_() for n, t in params.items()}
        out = fb.fused_swin_block_plain(xs, ps, k1, k2, **kw)
        p_bwd = _median_ms(torch, lambda: torch.autograd.grad(
            out, [xs, *ps.values()], do, retain_graph=True))
        del out, xs, ps
        for key, t, p, n in (("fwd", t_fwd, p_fwd, n_fwd),
                             ("bwd", t_bwd, p_bwd, n_bwd)):
            per_step[key]["ms"] += n * t
            per_step[key]["plain_ms"] += n * p
        top = sorted(((n if n == "out" else f"d{n}", e)
                      for n, e in errs.items()), key=lambda kv: -kv[1])[:3]
        log(f"fused-vs-plain {label:22s} B={B:3d} N={N} nW={nW:2d} C={C:3d} "
            f"nH={nH:2d} {dt}: max err out {errs['out']:.2e} dx "
            f"{errs['x']:.2e}, largest {', '.join(f'{n} {e:.2e}' for n, e in top)}"
            f" (tol {TOL[dt]:.0e}); all 19 results bit-identical on repeat")
        log(f"  time {label:22s} fwd kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms | bwd kernel {t_bwd:.4f} ms plain "
            f"{p_bwd:.4f} ms")
    return worst, per_step


def phase_forward_parity(torch, C, fb):
    """The Swin-T backbone on the default fused route, on the
    window-attention route and on the plain route, fp32, same weights,
    2 images at 224 and 96 px: relative error <= 1e-4 to the plain one."""
    from esvit_tpu_torch.models.swin import SwinTransformer

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    fused = SwinTransformer(C.swin_tiny(drop_path_rate=0.0),
                            generator=gen).to(dev)
    routes = {
        "fused": fused,
        "window-attention": SwinTransformer(C.swin_tiny(
            drop_path_rate=0.0, fused_block_stages=())).to(dev),
        "plain": SwinTransformer(C.swin_tiny(
            drop_path_rate=0.0, attention_impl="xla",
            fused_block_stages=())).to(dev),
    }
    for model in routes.values():
        model.load_state_dict(fused.state_dict())
    for size in (224, 96):
        x = torch.randn(2, size, size, 3, generator=gen).to(dev)
        out = {}
        fb.launches["fwd"] = 0
        with torch.no_grad():
            for name, model in routes.items():
                out[name] = model.forward_features(x)[1]
        if fb.launches["fwd"] != fused.fused_block_calls(size):
            raise AssertionError(f"forward {size}px: {fb.launches['fwd']} "
                                 "fused launches, model-derived "
                                 f"{fused.fused_block_calls(size)}")
        b = out["plain"]
        for name in ("fused", "window-attention"):
            a = out[name]
            err = ((a - b).abs().max() / b.abs().max()).item()
            if not (torch.isfinite(a).all() and err <= 1e-4):
                raise AssertionError(f"forward {size}px: {name} route vs "
                                     f"plain {err:.2e}")
            log(f"swin-t forward_features {size}px fp32: {name} route vs "
                f"plain rel err {err:.2e} (tol 1e-4), shape {tuple(a.shape)}")


def _derived_launches(C, cfg, steps):
    """Per-kernel launches of `steps` train steps, from the model's routing:
    the teacher runs the 224 crops forward, the student all crops forward
    and backward."""
    from esvit_tpu_torch.models.swin import SwinTransformer

    probe = SwinTransformer(cfg.model)
    g, l = cfg.crops.global_size, cfg.crops.local_size
    want = {}
    for name, calls in (("window_attention", probe.window_attention_calls),
                        ("fused_block", probe.fused_block_calls)):
        want[name] = {"fwd": (2 * calls(g) + calls(l)) * steps,
                      "bwd": (calls(g) + calls(l)) * steps}
    return want


def _train_route(torch, cfg, steps, counters, label, card):
    """train() for `steps` steps with every launch count set to 0 just
    before; returns (state, history, counts read just after)."""
    from esvit_tpu_torch.train.train import train

    for launches in counters.values():
        launches["fwd"] = launches["bwd"] = 0
    torch.cuda.reset_peak_memory_stats()
    state, history = train(cfg, max_steps=steps, device="cuda")
    torch.cuda.synchronize()
    got = {name: dict(launches) for name, launches in counters.items()}
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    ms = statistics.mean(h["seconds"] for h in history[1:]) * 1e3
    ips = cfg.crops.ncrops * BATCH / (ms / 1e3)
    log(f"slice {label}: losses {losses}")
    log(f"slice {label}: launches {got}")
    log(f"slice {label}: Swin-T W=7 B={BATCH} 2x224+8x96 DDINO out_dim 65536 "
        f"bf16: {ms:.1f} ms/step, {ips:.1f} img/s over steps 2-{steps}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB [{card}]")
    return state, got


def phase_slice(torch, C, counters, card, out_dir):
    """The default (fused) route for STEPS steps, then the window-attention
    route for 3, each with its launch counts held to the model's."""
    import gc

    cfg = C.swin_tiny_multicrop(BATCH, output_dir=out_dir)
    want = _derived_launches(C, cfg, STEPS)
    init = _initial_weights(torch, cfg)
    state, got = _train_route(torch, cfg, STEPS, counters, "fused route", card)
    if got != want:
        raise AssertionError(f"fused route: launches {got}, model-derived "
                             f"{want}")
    moved = {
        "student": _max_change(torch, state.student, init),
        "teacher": _max_change(torch, state.teacher, init),
        "center": state.centers.center.abs().max().item(),
        "center_grid": state.centers.center_grid.abs().max().item(),
    }
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"state did not change: {moved}")
    log(f"slice fused route: max change {moved}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    wa_cfg = cfg.replace(model=C.swin_tiny(fused_block_stages=()))
    wa_want = _derived_launches(C, wa_cfg, 3)
    state, wa_got = _train_route(torch, wa_cfg, 3, counters,
                                 "window-attention route", card)
    if wa_got != wa_want:
        raise AssertionError(f"window-attention route: launches {wa_got}, "
                             f"model-derived {wa_want}")
    del state
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
    from esvit_tpu_torch.ops import cuda_build
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import window as wops
    from esvit_tpu_torch.ops import window_attention as wa

    phase_build(cuda_build)
    results = {"window_attention": phase_window_attention(torch, wa, wops),
               "fused_block": phase_fused(torch, fb, wops)}
    phase_forward_parity(torch, C, fb)
    counters = {"window_attention": wa.launches, "fused_block": fb.launches}
    with tempfile.TemporaryDirectory() as out_dir:
        launches = phase_slice(torch, C, counters, card, out_dir)
    record = {"kernels": [
        {"name": f"{name}_{k}", "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1][k], "launches": launches[name][k],
         "max_abs_err": worst[k], "ms": per_step[k]["ms"],
         "plain_ms": per_step[k]["plain_ms"]}
        for name, (worst, per_step) in results.items() for k in ("fwd", "bwd")]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
