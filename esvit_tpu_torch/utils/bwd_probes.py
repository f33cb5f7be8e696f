"""Card probes of the backward kernels for what chip_smoke.py does not
measure. Needs a CUDA device and nvcc.

    python -m esvit_tpu_torch.utils.bwd_probes compare --other DIR
    python -m esvit_tpu_torch.utils.bwd_probes launch-bounds
    python -m esvit_tpu_torch.utils.bwd_probes ragged-count

compare: the window-attention backward (ops/window_attention.py ``_bwd``,
row 4) at Swin-T's 224 px shapes, fp32 and bf16, in this checkout and in
the checkout DIR (a process each, alternating, two runs each): median ms
of 20 calls (CUDA events) and the largest error against autograd through
the plain version, each normalised by its max-abs.

launch-bounds: the fp32 backward tile at two blocks per SM (its
``__launch_bounds__``, at most 128 registers) against one block (no
register cap), each built from a copy of csrc/; row 4 at its fp32 shapes
and the block-fused fp32 backward at 224 px stage 1, alternating.

ragged-count: the token kernels' row count on a ragged last tile (392
rows in tiles of 64) when ``make_tok`` forms it as
``min(g.R, g.B_ * g.N - (int)b.row0)`` with a size_t row0, in place of
plain ints: each kernel's count on its last two tiles (printf), built at
-O3 and at -Xptxas -O0, and T2's instructions that take the minimum
(cuobjdump -sass), for both forms.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from esvit_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[2]
PROBES = cuda_build.BUILD / "probes"

# Row 4 at Swin-T's 224 px shapes: (label, windows, C, heads, stage side,
# shifted, dtype).
ROW4_SHAPES = [
    ("224 s1 shifted fp32", 1024, 192, 6, 28, True, "float32"),
    ("224 s0 fp32", 4096, 96, 3, 56, False, "float32"),
    ("224 s3 fp32", 64, 768, 24, 7, False, "float32"),
    ("224 s0 bf16", 4096, 96, 3, 56, False, "bfloat16"),
    ("224 s1 shifted bf16", 1024, 192, 6, 28, True, "bfloat16"),
]

# Runs in a checkout's root with that checkout first on sys.path, so it
# uses only what every tree since the tile kernels has: window_attention
# _bwd and window_attention_plain, window.window_region_ids.
_ROW4_WORKER = r'''
import statistics, sys, torch
sys.path.insert(0, ".")
from esvit_tpu_torch.ops import window as wops, window_attention as wa
shapes, reps = eval(sys.argv[1]), 20
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)

def median_ms(fn):
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        a.record(); fn(); b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)

for label, B_, C, nH, H, shifted, dt in shapes:
    N, dtype = 49, getattr(torch, dt)
    q, k, v, do = (torch.randn(B_ * N, C, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    bias = 0.3 * torch.randn(nH, N, N, generator=gen, device=dev)
    region = (torch.as_tensor(wops.window_region_ids(H, H, 7, 3), device=dev)
              if shifted else None)
    scale = (C // nH) ** -0.5
    got = wa._bwd(q, k, v, bias, region, do, N, nH, scale)
    ts = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    want = torch.autograd.grad(wa.window_attention_plain(*ts, region, N, nH, scale), ts, do)
    err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
              for a, b in zip(got, want))
    ms = median_ms(lambda: wa._bwd(q, k, v, bias, region, do, N, nH, scale))
    print(f"  {label:22s} {ms:.4f} ms, max error {err:.2e}", flush=True)
'''


def _median_ms(fn, reps=20):
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def compare(other: Path):
    for tree in (ROOT, other, ROOT, other):
        print(f"row 4 backward, checkout {tree}", flush=True)
        subprocess.run([sys.executable, "-c", _ROW4_WORKER, repr(ROW4_SHAPES)],
                       cwd=tree, check=True)


def _build_variant(tag: str, edits: dict, names, extra=()):
    """Builds each library of `names` (its cuda_build.sources) from a copy of csrc/ with
    `edits` ({file or file#label: (old, new)}) applied, into PROBES/tag;
    returns {name: (library path, ptxas report)}."""
    d = PROBES / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    for key, (old, new) in edits.items():
        fname = key.split("#")[0]
        text = (d / fname).read_text()
        if old not in text:
            raise RuntimeError(f"{fname}: the text to replace is not there")
        (d / fname).write_text(text.replace(old, new))
    procs = {}
    for name in names:
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", *extra,
               "-I", str(d), "-o", str(d / f"lib{name}.so"),
               *map(str, cuda_build.sources(name, d))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        report = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {tag}/{name}.cu:\n{report[-3000:]}")
        out[name] = (d / f"lib{name}.so", report)
    return out


def _use(libs: dict):
    """Points the wrappers at the given libraries."""
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import window_attention as wa
    loaded = {name: ctypes.CDLL(str(path)) for name, (path, _) in libs.items()}
    cuda_build.load = lambda name, _orig=cuda_build.load: loaded.get(name) or _orig(name)
    wa._lib.cache_clear()
    fb._lib.cache_clear()
    wa.tile_plan.cache_clear()


def _fused_case(B, C, nH, H, shifted, dtype, gen, ws=7):
    """One block-fused backward call's inputs: (x, params, keep1, keep2,
    region, pad, output gradient, geometry); no padding, no drop-path."""
    from esvit_tpu_torch.ops import window as wops
    dev = torch.device("cuda")
    N, nW, M = ws * ws, (H // ws) ** 2, 4 * C

    def r(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gen, device=dev)

    params = dict(g1=1 + r(C, s=0.1), be1=r(C, s=0.1),
                  wq=r(C, C, s=C ** -0.5), bq=r(C, s=0.02),
                  wk=r(C, C, s=C ** -0.5), bk=r(C, s=0.02),
                  wv=r(C, C, s=C ** -0.5), bv=r(C, s=0.02),
                  bias=r(nH, N, N, s=0.05), wp=r(C, C, s=C ** -0.5),
                  bp=r(C, s=0.02), g2=1 + r(C, s=0.1), be2=r(C, s=0.1),
                  w1=r(C, M, s=C ** -0.5), b1=r(M, s=0.02),
                  w2=r(M, C, s=M ** -0.5), b2=r(C, s=0.02))
    region = (torch.as_tensor(wops.window_region_ids(H, H, ws, ws // 2), device=dev)
              if shifted else None)
    x = r(B, nW * N, C, s=0.5).to(dtype)
    do = r(B, nW * N, C).to(dtype)
    return x, params, None, None, region, None, do, (N, nH, nW, (C // nH) ** -0.5, 1e-6)


def launch_bounds():
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import window as wops
    from esvit_tpu_torch.ops import window_attention as wa
    old = ("template <typename T, class Policy>\n__global__ void __launch_bounds__"
           "(kMaxWarps * 32, 2)\nwindow_attention_bwd_tile_kernel")
    one = old.replace("32, 2)", "32, sizeof(T) == 2 ? 2 : 1)")
    names = ("window_attention", "fused_block")
    variants = {"two": _build_variant("two_blocks", {}, names),
                "one": _build_variant("one_block", {"window_attention_tile.cuh": (old, one)},
                                      names)}
    for tag, libs in variants.items():
        report = libs["window_attention"][1].splitlines()
        for i, line in enumerate(report):
            if "Compiling entry" in line and "bwd_tile_kernelIf" in line:
                print(tag, "block(s) per SM:", " | ".join(s.strip() for s in report[i + 2:i + 4]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, B_, C, nH, H, shifted, dt in ROW4_SHAPES:
        if dt != "float32":
            continue
        N = 49
        q, k, v, do = (torch.randn(B_ * N, C, generator=gen, device=dev) for _ in range(4))
        bias = 0.3 * torch.randn(nH, N, N, generator=gen, device=dev)
        region = (torch.as_tensor(wops.window_region_ids(H, H, 7, 3), device=dev)
                  if shifted else None)
        cases.append((label, (q, k, v, bias, region, do, N, nH, (C // nH) ** -0.5)))
    fused = _fused_case(64, 192, 6, 28, True, torch.float32, gen)
    cap = dict(wa._SM_WARPS_MAX_BWD)
    try:
        for tag in ("two", "one", "two", "one"):
            _use(variants[tag])
            # one block of 8 warps per SM when the registers are not capped
            wa._SM_WARPS_MAX_BWD[4] = cap[4] if tag == "two" else 8
            for label, args in cases:
                ms = _median_ms(lambda: wa._bwd(*args))
                print(f"{tag} row 4 {label:22s} {ms:.4f} ms", flush=True)
            ms = _median_ms(lambda: fb._bwd(*fused))
            print(f"{tag} fused fp32 backward 224 s1 shifted {ms:.4f} ms", flush=True)
    finally:
        wa._SM_WARPS_MAX_BWD.update(cap)


def ragged_count():
    from esvit_tpu_torch.ops import fused_block as fb
    ints = ("  const int row0 = blockIdx.x * g.R, left = g.B_ * g.N - row0;\n"
            "  b.row0 = (size_t)row0;\n  b.n = left < g.R ? left : g.R;\n")
    size_t = ("  b.row0 = (size_t)blockIdx.x * g.R;\n"
              "  b.n = min(g.R, g.B_ * g.N - (int)b.row0);\n")
    printf = ('\n  if (threadIdx.x == 0 && blockIdx.x >= gridDim.x - 2) printf('
              '"T%d tile %d of %d: %d rows\\n", {k}, blockIdx.x, gridDim.x, b.n);')
    dev = torch.device("cuda")
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    for form, count, extra in (("plain ints", ints, ()), ("size_t row0", size_t, ()),
                               ("size_t row0", size_t, ("-Xptxas", "-O0"))):
        flags = " ".join(extra) or "-O3"
        print(f"{form}, {flags}:", flush=True)
        edits = {"fused_block.cu": (ints, count)} if count is not ints else {}
        for k in (1, 2, 3):   # each token kernel prints its last two tiles' counts
            call = f"const Tok<T> b = make_tok<T>(tab.p, g, {k}, smem);"
            edits[f"fused_block.cu#{k}"] = (call, call + printf.format(k=k))
        edits["fused_block.cu#io"] = ("#include <stdint.h>\n",
                                      "#include <stdint.h>\n#include <cstdio>\n")
        tag = f"ragged_{form.split()[0]}_{flags.lstrip('-').replace(' ', '')}"
        _use(_build_variant(tag, edits, ("fused_block",), extra))
        case = _fused_case(2, 64, 2, 14, False, torch.bfloat16,
                           torch.Generator(device=dev).manual_seed(3))
        dx, grads, _ = fb._bwd_buffers(*case)
        torch.cuda.synchronize()
        print(f"  dx finite {bool(torch.isfinite(dx).all())}, gradients finite "
              f"{all(bool(torch.isfinite(g).all()) for g in grads.values())}", flush=True)
        if extra:
            continue
        d = PROBES / f"{tag}_sass"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, d)
        (d / "fused_block.cu").write_text(
            (d / "fused_block.cu").read_text().replace(ints, count))
        for kind in ("cubin", "ptx"):
            subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-I", str(d), f"-{kind}", "-o",
                            str(d / f"t.{kind}"), str(d / "fused_block.cu")],
                           check=True, capture_output=True)
        sass = subprocess.run([str(cuobjdump), "-sass", str(d / "t.cubin")],
                              capture_output=True, text=True, check=True).stdout
        t2 = [f for f in re.split(r"\n\s*Function : ", sass)
              if re.match(r"\S*fused_bwd_t2_kernelI13__nv_bfloat16", f)][0]
        for line in t2.splitlines()[:120]:
            if "MNMX" in line:
                print("  T2 SASS:", re.sub(r"\s*/\* 0x[0-9a-f]+ \*/", "", line).strip())
        ptx = (d / "t.ptx").read_text()
        t2 = ptx[ptx.index("fused_bwd_t2_kernelI13__nv_bfloat16EEv"):].splitlines()[:80]
        for i, line in enumerate(t2):
            if line.strip().startswith("min.s32"):
                for prev in t2[max(0, i - 4):i + 1]:
                    print("  T2 PTX:", prev.strip())
                break


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="probe", required=True)
    sub.add_parser("compare").add_argument("--other", required=True, type=Path)
    sub.add_parser("launch-bounds")
    sub.add_parser("ragged-count")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bwd_probes needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    if args.probe == "compare":
        compare(args.other.resolve())
    elif args.probe == "launch-bounds":
        launch_bounds()
    else:
        ragged_count()


if __name__ == "__main__":
    main()
