"""A kernel here and in another checkout, on the card. Needs a CUDA
device and nvcc.

    python -m esvit_tpu_torch.utils.fwd_compare --other DIR
        [--kernel fused_block|sliding_chunk|large]

``fused_block`` (row 1, the default): at every block shape of
chip_smoke.py's ``FUSED_SHAPES`` (the Swin-T W=7 B=32 multi-crop step's,
drawn by its ``_fused_case`` from the same seed in both checkouts), times
ops/fused_block.py ``_fwd``. ``sliding_chunk`` (rows 5-6): at every
shape of chip_smoke.py's ``SC_SHAPES`` (the ViL-T step's), times both
passes, ops/sliding_chunk.py ``_fwd`` and ``_bwd``, on inputs drawn from
the same seed in both checkouts. ``large`` (the large-window tile's
rows, N > 64): the packed pair's forward and backward at chip_smoke.py's
``WA_SHAPES_B14`` (rows 3-4, per Swin-B W=14 packed-route step), the
qkv-layout forward at its W=14 ``PWA_SHAPES`` (row 7, per W=14 eval
batch) and the block-fused pair's forward and backward at the W=14
entries of ``FUSED_SHAPES`` and ``FUSED_SHAPES_B14`` (rows 1-2, per
Swin-T and per Swin-B W=14 step; C=512 apart); its last line is a JSON
object of those sums, which ``chip_smoke.py --parent DIR`` reads. Each
runs in this checkout and in the
checkout DIR (e.g. a ``git archive`` of an earlier commit), a process
each, in the order this, DIR, this, DIR: median ms of 20 calls (CUDA
events) per shape, and the sum over a step (calls per step x median).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LARGE_WORKER = r'''
import json, math, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from esvit_tpu_torch.ops import fused_block as fb
from esvit_tpu_torch.ops import pallas_window_attention as pwa
from esvit_tpu_torch.ops import window as wops
from esvit_tpu_torch.ops import window_attention as wa
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(3)
sums = dict.fromkeys(("wa_b14_fwd", "wa_b14_bwd", "pwa_w14_fwd",
                      "fused_w14_fwd", "fused_w14_bwd", "fused_b14_fwd",
                      "fused_b14_bwd", "fused_c512_fwd", "fused_c512_bwd"),
                     0.0)


def r(*shape, dtype=torch.float32, s=1.0):
    return (s * torch.randn(*shape, generator=gen, device=dev)).to(dtype)


for label, B_, C, nH, H, shifted, dt, n_fwd, n_bwd, N in cs.WA_SHAPES_B14:
    if N <= 64 or not (n_fwd or n_bwd):
        continue
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    ws = math.isqrt(N)
    region = (torch.as_tensor(wops.window_region_ids(H, H, ws, ws // 2),
                              device=dev) if shifted else None)
    q, k, v, do = (r(B_ * N, C, dtype=dtype) for _ in range(4))
    bias = r(nH, N, N, s=0.3)
    scale = (C // nH) ** -0.5
    with torch.no_grad():
        f = cs._median_ms(torch, lambda: wa._fwd(q, k, v, bias, region, N,
                                                 nH, scale))
    b = cs._median_ms(torch, lambda: wa._bwd(q, k, v, bias, region, do, N,
                                             nH, scale))
    sums["wa_b14_fwd"] += n_fwd * f
    sums["wa_b14_bwd"] += n_bwd * b
    print(f"  rows 3-4 {label:26s} {dt} fwd {f:.4f} bwd {b:.4f} ms",
          flush=True)
for label, B_, C, nH, H, shifted, dt, _, *rest in cs.PWA_SHAPES:
    if not rest or rest[0] != 14 or not rest[1]:
        continue
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    N, Hp = 196, -(-H // 14) * 14
    nWm = (Hp // 14) ** 2 if shifted else 1
    qkv = r(B_, N, 3 * C, dtype=dtype)
    bias = r(nWm, nH, N, N, s=0.3)
    with torch.no_grad():
        f = cs._median_ms(torch, lambda: pwa._fwd(qkv, bias, nH,
                                                  (C // nH) ** -0.5))
    sums["pwa_w14_fwd"] += rest[1] * f
    print(f"  row 7 {label:29s} {dt} fwd {f:.4f} ms", flush=True)
for shapes, cell in ((cs.FUSED_SHAPES, "w14"), (cs.FUSED_SHAPES_B14, "b14")):
    for label, B, C, nH, H, shifted, dt, _, _, ws, *calls in shapes:
        if ws != 14 or not calls:
            continue
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, params, k1, k2, region, pad, geo, do = cs._fused_case(
            torch, wops, B, C, nH, H, shifted, dtype, gen, ws)
        with torch.no_grad():
            f = cs._median_ms(torch, lambda: fb._fwd(x, params, k1, k2,
                                                     region, pad, geo))
        b = cs._median_ms(torch, lambda: fb._bwd(x, params, k1, k2, region,
                                                 pad, do, geo))
        n_f, n_b = calls[0]
        sums[f"fused_{cell}_fwd"] += n_f * f
        sums[f"fused_{cell}_bwd"] += n_b * b
        if cell == "b14" and C == 512:
            sums["fused_c512_fwd"] += n_f * f
            sums["fused_c512_bwd"] += n_b * b
        print(f"  rows 1-2 {cell} {label:22s} {dt} fwd {f:.4f} bwd {b:.4f} "
              "ms", flush=True)
print(json.dumps(sums), flush=True)
'''

# Each worker runs in a checkout's root with that checkout first on
# sys.path, so it uses what every tree since the kernel's port has:
# chip_smoke's shape lists and _median_ms, and the wrapper's _fwd / _bwd.
# A shape's window side, where the lists have one, is its last element
# (7 in the trees before them).
_WORKERS = {"fused_block": ("row 1 forward", r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from esvit_tpu_torch.ops import fused_block as fb, window as wops
gen = torch.Generator(device="cuda").manual_seed(1)
step = 0.0
for label, B, C, nH, H, shifted, dt, n_fwd, _, *ws in cs.FUSED_SHAPES:
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    x, params, k1, k2, region, pad, geo, _ = cs._fused_case(
        torch, wops, B, C, nH, H, shifted, dtype, gen, *ws)
    with torch.no_grad():
        ms = cs._median_ms(torch, lambda: fb._fwd(x, params, k1, k2, region,
                                                 pad, geo))
    step += n_fwd * ms
    print(f"  {label:22s} {dt} forward {ms:.4f} ms", flush=True)
print(f"  per default step {step:.3f} ms", flush=True)
'''), "sliding_chunk": ("rows 5-6 forward and backward", r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from esvit_tpu_torch.ops import sliding_chunk as sc
gen = torch.Generator(device="cuda").manual_seed(2)
nglo = 1
step = {"fwd": 0.0, "bwd": 0.0}
for label, BH, n, M, dt, n_fwd, n_bwd, *w in cs.SC_SHAPES:
    W = w[0] if w else 7
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32

    def r(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    ins = (r(BH, n, n, M, s=M ** -0.5), r(BH, n, n, M), r(BH, n, n, M),
           r(BH, nglo, M), r(BH, nglo, M))
    do = r(BH, n, n, M)
    with torch.no_grad():
        fwd = cs._median_ms(torch, lambda: sc._fwd(*ins, n, n, W))
        _, stats = sc._fwd(*ins, n, n, W)
        bwd = cs._median_ms(torch, lambda: sc._bwd(*ins, stats, do, n, n, W))
    step["fwd"] += n_fwd * fwd
    step["bwd"] += n_bwd * bwd
    print(f"  {label:14s} {dt} forward {fwd:.4f} ms backward {bwd:.4f} ms",
          flush=True)
print(f"  per ViL-T step forward {step['fwd']:.3f} ms backward "
      f"{step['bwd']:.3f} ms", flush=True)
'''), "large": ("the large-window tile's rows", LARGE_WORKER)}


def large_times(tree: Path) -> dict:
    """Runs the ``large`` worker in checkout ``tree`` and returns its sums
    (ms): rows 3-4 per Swin-B W=14 packed-route step ("wa_b14_fwd",
    "wa_b14_bwd"), row 7 per W=14 eval batch ("pwa_w14_fwd"), rows 1-2 per
    Swin-T W=14 step ("fused_w14_fwd", "fused_w14_bwd") and per Swin-B
    W=14 step ("fused_b14_fwd", "fused_b14_bwd"; its C=512 blocks
    "fused_c512_fwd", "fused_c512_bwd")."""
    out = subprocess.run([sys.executable, "-c", LARGE_WORKER], cwd=tree,
                         check=True, capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, type=Path)
    p.add_argument("--kernel", default="fused_block", choices=sorted(_WORKERS))
    args = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    what, worker = _WORKERS[args.kernel]
    other = args.other.resolve()
    for tree in (ROOT, other, ROOT, other):
        print(f"{what}, checkout {tree}", flush=True)
        subprocess.run([sys.executable, "-c", worker], cwd=tree, check=True)


if __name__ == "__main__":
    main()
