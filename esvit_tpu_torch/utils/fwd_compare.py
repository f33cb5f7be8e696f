"""A kernel here and in another checkout, on the card. Needs a CUDA
device and nvcc.

    python -m esvit_tpu_torch.utils.fwd_compare --other DIR
        [--kernel fused_block|sliding_chunk]

``fused_block`` (row 1, the default): at every block shape of
chip_smoke.py's ``FUSED_SHAPES`` (the Swin-T W=7 B=32 multi-crop step's,
drawn by its ``_fused_case`` from the same seed in both checkouts), times
ops/fused_block.py ``_fwd``. ``sliding_chunk`` (rows 5-6): at every
shape of chip_smoke.py's ``SC_SHAPES`` (the ViL-T step's), times both
passes, ops/sliding_chunk.py ``_fwd`` and ``_bwd``, on inputs drawn from
the same seed in both checkouts. Each runs in this checkout and in the
checkout DIR (e.g. a ``git archive`` of an earlier commit), a process
each, in the order this, DIR, this, DIR: median ms of 20 calls (CUDA
events) per shape, and the sum over a step (calls per step x median).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

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
''')}


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
