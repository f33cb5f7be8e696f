"""Row 1 (the block-fused forward) here and in another checkout, on the
card. Needs a CUDA device and nvcc.

    python -m esvit_tpu_torch.utils.fwd_compare --other DIR

At every block shape of chip_smoke.py's ``FUSED_SHAPES`` (the Swin-T W=7
B=32 multi-crop step's, drawn by its ``_fused_case`` from the same seed
in both checkouts), times ops/fused_block.py ``_fwd`` in this checkout
and in the checkout DIR (e.g. a ``git archive`` of an earlier commit), a
process each, in the order this, DIR, this, DIR: median ms of 20 calls
(CUDA events) per shape, and the sum over a default step (calls per step
x median).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# Runs in a checkout's root with that checkout first on sys.path, so it
# uses what every tree since the block-fused kernels has: chip_smoke's
# FUSED_SHAPES, _fused_case and _median_ms, and fused_block._fwd.
_WORKER = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from esvit_tpu_torch.ops import fused_block as fb, window as wops
gen = torch.Generator(device="cuda").manual_seed(1)
step = 0.0
for label, B, C, nH, H, shifted, dt, n_fwd, _ in cs.FUSED_SHAPES:
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    x, params, k1, k2, region, pad, geo, _ = cs._fused_case(
        torch, wops, B, C, nH, H, shifted, dtype, gen)
    with torch.no_grad():
        ms = cs._median_ms(torch, lambda: fb._fwd(x, params, k1, k2, region,
                                                 pad, geo))
    step += n_fwd * ms
    print(f"  {label:22s} {dt} forward {ms:.4f} ms", flush=True)
print(f"  per default step {step:.3f} ms", flush=True)
'''


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, type=Path)
    args = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    other = args.other.resolve()
    for tree in (ROOT, other, ROOT, other):
        print(f"row 1 forward, checkout {tree}", flush=True)
        subprocess.run([sys.executable, "-c", _WORKER], cwd=tree, check=True)


if __name__ == "__main__":
    main()
