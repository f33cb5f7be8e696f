#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises,
so the script exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit and the
   torch/CUDA versions; TF32 off for the parity checks.
2. Build the four kernel libraries from esvit_tpu_torch/csrc/ (one nvcc
   each, started together) and print nvcc's -Xptxas -v report; fail if a
   window-attention tile kernel's registers hold fewer warps per SM than
   ops/window_attention.py tile_plan assumes; print the sliding-chunk
   tensor-core kernels' registers, spills and blocks per SM.
3. Window attention vs plain PyTorch on the card at every full-window
   shape of the Swin-T W=7 B=32 multi-crop step (bf16, plus one fp32
   case): forward output and the q/k/v/bias gradients within 3e-2 (bf16)
   or 2e-5 (fp32) after normalising each by its max-abs; dbias
   bit-identical on repeat; median times over 20 reps of kernel, plain
   and the library call (scaled_dot_product_attention), with each
   shape's bound. First, the tile kernels' shared memory (forward and
   backward) as the wrapper counts it equals the kernels' own count at
   every N, head dim and dtype, and fits a block.
4. The block-fused kernels vs their plain version at every block shape
   the default (fused) route gives them (Swin-T's, and the learning
   gate's nano Swin's at W=4: C 32/64/128, N=16 and the augmented window
   of 5 tokens, bf16, and its fp32 eval), shifted and unshifted, with
   drop-path scales that drop an image (bf16, plus one fp32 case): the
   output, dx and all 17 parameter gradients within the same tolerances
   (dbk, whose exact value is 0, at the scale of the largest gradient);
   every result bit-identical on repeat; each forward stage kernel (F1,
   A1, F2, F3, F4) and each backward stage kernel (T1, A1, T2, A2, T3)
   within the same tolerance of its plain twin on its own inputs; median
   times over 20 reps; both passes' device time split by kernel
   (torch.profiler), per shape and per default step; beside the forward,
   a yardstick: torch.matmul (cuBLAS) of the block's four products at the
   shape, timed only. First, both passes' token-tile blocks fit the card
   at every admitted width.
5. The sliding-chunk kernel pair vs its plain version at the four shapes
   of the ViL-T W=7 B=32 multi-crop step (bf16, plus one fp32 case) and
   at the learning gate's nano ViL shapes (W=4, head dim 16): the
   output and the five gradients within the same tolerances, every one
   bit-identical on repeat; each kernel (forward, bwd_q, bwd_k, the
   globals' reduce) within the same tolerance of its staged twin on its
   own inputs; median times over 20 reps of kernel, plain and the library
   call (scaled_dot_product_attention with the neighbourhood as a boolean
   mask, whose output is first held to the plain one); both passes'
   device time split by kernel (torch.profiler), per shape and per ViL-T
   step, and beside it the device time of the layout copies around each
   call (models/vil_layers.py). First, every admitted shape's blocks fit
   the card, and ops/sliding_chunk.py kernel_smem_bytes equals the
   kernels' own count.
6. The forward-only qkv-layout window attention (row 7) vs plain PyTorch
   on the card at every shape of the eval slice (fp32, B=64 at 224 px,
   shifted and unshifted) and of its train route (bf16, the 224 and 96 px
   shapes): the output within the same tolerances and bit-identical on
   repeat; d(qkv) and d(bias) through the autograd wrapper equal to the
   plain version's; median times over 20 reps of kernel, plain and the
   library call (scaled_dot_product_attention, the dense bias as its
   float attn_mask, its output first held to the plain one).
7. Forward parity, fp32, 224 and 96 px, same weights: the Swin-T default
   fused route, the window-attention route (fused_block_stages=()), the
   qkv-layout route (attention_impl='pallas', no fused stages) and the
   plain route (attention_impl='xla', no fused stages) agree within 1e-4
   relative, and so does forward_return_n_last_blocks(x, 4) on each of
   them; each kernel's launches equal the model-derived counts; so do
   ViL-T's kernel route and its plain route (fused_sc='off').
8. The slices: esvit_tpu_torch.train.train.train() runs 5 steps of Swin-T
   W=7, B=32, 2x224 + 8x96 crops, out_dim 65536, DDINO, bf16, on-device
   synthetic data, on the default fused route; then 3 steps of the
   window-attention route and 3 of the qkv-layout route, then 5 steps of
   ViL-T on the same crops, in the same process. Losses must be finite;
   student, teacher and both centers must change (default route and
   ViL-T); each run's launch counts of every kernel must equal the
   per-step counts derived from the model times the steps. Then the
   route order: the default route and fused_block_stages=() alternate for
   3 rounds of 3 steps each; each route's median ms per step over steps
   2-3 of its rounds and their spread. Between the two, the data-fed
   slice: 6 steps of the Swin-T default route through train() fed by
   data/loader.py MultiCropIterator over ProceduralShapesHard (256 px,
   8B images, 4 host threads, uint8 upload, augmentation on the card),
   with the same checks; its ms per step (steps 2-6) beside the synthetic
   one, the host's wait on the feed per step and peak memory; the batch
   train() consumed at step 1 on the card, fp32, each channel's mean and
   std in a band around the normalisation; then the feed alone: host
   batches per second, and the upload + augmentation time per batch.
9. The eval slice: Swin-T on the qkv-layout route, fp32, random weights
   from seed 0, batch 64, on synthetic 256 px images (PIL decode
   and transform on the host; 2048 train, 512 val, 10 classes):
   esvit_tpu_torch.evals.knn.run_knn_eval at k 10/20/100/200, then
   esvit_tpu_torch.evals.linear.run_linear_eval with cached 4-last-block
   features. Features finite and unit-norm, accuracies in [0, 100], and
   the kernel's launches equal to the model-derived count per batch
   times the batches.
10. The learning canary: 200 steps of esvit_tpu_torch.validate_learning's
   nano Swin leg on shapes_hard (k-NN before and after, no gain gate):
   a finite last loss and centres, and the block-fused launches equal to
   the model's (the steps and the two evals). The full gates are
   ``python -m esvit_tpu_torch.validate_learning --steps 6000``.

The line before the last is the per-kernel JSON record: ``launches`` from
the Swin-T default route's 5 steps (ViL-T's 5 for sliding_chunk, the eval
slice for pallas_window_attention);
``max_abs_err`` the largest max-abs difference from the plain version
over the checked shapes, each divided by its normaliser (the quantity
held to the tolerance); ``ms`` /
``plain_ms`` / ``library_ms`` the per-step time of the default route at
the slice shapes (calls per step x median per call; per eval forward
batch for pallas_window_attention); ``bound_ms`` the larger of the bytes
over HBM bandwidth and the operations over the peak of their type (bf16
tensor cores; fp32 CUDA cores for the fp32 eval), summed the same way.
The last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
STEPS = 5
REPS = 20
# The route order: rounds of the default route and fused_block_stages=()
# in turns, and steps per round.
ROUTE_ROUNDS, ROUTE_STEPS = 3, 3
# The data-fed Swin-T slice: steps, images per batch of the procedural
# dataset, host threads (train()'s feed has MultiCropIterator's default
# 4), and the band each channel's mean and std must fall in after
# normalisation (ProceduralShapesHard is dark, mean ~ -0.8).
DATA_STEPS, DATA_IMAGES, NUM_THREADS = 6, 8, 4
DATA_MEAN_BAND, DATA_STD_BAND = (-1.5, 1.5), (0.3, 1.5)
# The nano learning canary's steps.
CANARY_STEPS = 200
KERNELS = {
    "window_attention": ("esvit_tpu_torch/csrc/window_attention.cu", {
        "fwd": "esvit_tpu/ops/packed_window_attention.py:305",
        "bwd": "esvit_tpu/ops/packed_window_attention.py:314"}),
    "fused_block": ("esvit_tpu_torch/csrc/fused_block.cu", {
        "fwd": "esvit_tpu/ops/fused_block.py:459",
        "bwd": "esvit_tpu/ops/fused_block.py:475"}),
    "sliding_chunk": ("esvit_tpu_torch/csrc/sliding_chunk.cu", {
        "fwd": "esvit_tpu/ops/sliding_chunk_fused.py:116",
        "bwd": "esvit_tpu/ops/sliding_chunk_fused.py:132"}),
    # Forward only: the TPU kernel has no backward (autodiff of its plain
    # reference), and neither has the port.
    "pallas_window_attention": (
        "esvit_tpu_torch/csrc/pallas_window_attention.cu", {
            "fwd": "esvit_tpu/ops/pallas_window_attention.py:36"}),
}
# H100 SXM peaks for the roofline bound (NVIDIA data sheet, dense; fp32
# outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
# An H100 SM's shared memory (228 KB, 1 KB of it reserved per block).
SM_SMEM_BYTES = 233472
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

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
# Block-fused kernel: (label, images B, C, nH, stage resolution H, shifted,
# dtype name, calls per step: forward, backward, window size ws). Each stage
# alternates unshifted and shifted blocks. H < ws is one padded window per
# image, run as the augmented window of H*H tokens + 1 virtual token; it
# carries the shift in its bias. The "nano" shapes are the learning gate's
# nano Swin (esvit_tpu_torch/validate_learning.py: W=4, C 32/64/128, B=64):
# its 64 px global crops (2B images), its 32 px locals (4B images, stage 2
# the augmented window of 5 tokens) and its fp32 k-NN eval (batch 32);
# none runs in a Swin-T step.
FUSED_SHAPES = [
    ("224 s0", 64, 96, 3, 56, False, "bf16", 2, 1, 7),
    ("224 s0 shifted", 64, 96, 3, 56, True, "bf16", 2, 1, 7),
    ("224 s1", 64, 192, 6, 28, False, "bf16", 2, 1, 7),
    ("224 s1 shifted", 64, 192, 6, 28, True, "bf16", 2, 1, 7),
    ("224 s2", 64, 384, 12, 14, False, "bf16", 6, 3, 7),
    ("224 s2 shifted", 64, 384, 12, 14, True, "bf16", 6, 3, 7),
    ("96 s0 padded", 256, 96, 3, 24, False, "bf16", 1, 1, 7),
    ("96 s0 padded shifted", 256, 96, 3, 24, True, "bf16", 1, 1, 7),
    ("96 s1 padded", 256, 192, 6, 12, False, "bf16", 1, 1, 7),
    ("96 s1 padded shifted", 256, 192, 6, 12, True, "bf16", 1, 1, 7),
    ("96 s2 augmented", 256, 384, 12, 6, False, "bf16", 6, 6, 7),
    ("224 s1 shifted fp32", 64, 192, 6, 28, True, "fp32", 0, 0, 7),
    ("nano 64 s0", 128, 32, 2, 16, False, "bf16", 0, 0, 4),
    ("nano 64 s0 shifted", 128, 32, 2, 16, True, "bf16", 0, 0, 4),
    ("nano 64 s1", 128, 64, 4, 8, False, "bf16", 0, 0, 4),
    ("nano 64 s1 shifted", 128, 64, 4, 8, True, "bf16", 0, 0, 4),
    ("nano 64 s2", 128, 128, 4, 4, False, "bf16", 0, 0, 4),
    ("nano 32 s0", 256, 32, 2, 8, False, "bf16", 0, 0, 4),
    ("nano 32 s0 shifted", 256, 32, 2, 8, True, "bf16", 0, 0, 4),
    ("nano 32 s1", 256, 64, 4, 4, False, "bf16", 0, 0, 4),
    ("nano 32 s1 shifted", 256, 64, 4, 4, True, "bf16", 0, 0, 4),
    ("nano 32 s2 augmented", 256, 128, 4, 2, False, "bf16", 0, 0, 4),
    ("nano 64 s0 fp32", 32, 32, 2, 16, False, "fp32", 0, 0, 4),
    ("nano 64 s0 shifted fp32", 32, 32, 2, 16, True, "fp32", 0, 0, 4),
    ("nano 64 s1 shifted fp32", 32, 64, 4, 8, True, "fp32", 0, 0, 4),
    ("nano 64 s2 fp32", 32, 128, 4, 4, False, "fp32", 0, 0, 4),
]
FUSED_GRADS = ("x", "g1", "be1", "wq", "bq", "wk", "bk", "wv", "bv", "bias",
               "wp", "bp", "g2", "be2", "w1", "b1", "w2", "b2")
# Sliding-chunk kernel: (label, BH, grid side nx = ny, head dim M, dtype
# name, calls per step: forward, backward, chunk side W). ViL-T's sparse
# stages have W=7 and one global token; stage 0 has 1 head of 48, stage 1
# 3 of 32; the 224 crops are 2B images through teacher and student, the
# 96 crops 8B images through the student. The "nano" shapes are the
# learning gate's nano ViL (W=4, head dim 16, one global, B=64): stage 0
# 2 heads, stage 1 4 heads, at 64 px (2B images) and 32 px (4B images;
# its stage 0 has the shape of the 64 px stage 1), and its fp32 k-NN eval
# (batch 32); none runs in a ViL-T step.
SC_SHAPES = [
    ("224 s0", 64, 56, 48, "bf16", 2, 1, 7),
    ("224 s1", 192, 28, 32, "bf16", 2, 1, 7),
    ("96 s0 padded", 256, 24, 48, "bf16", 1, 1, 7),
    ("96 s1 padded", 768, 12, 32, "bf16", 1, 1, 7),
    ("224 s1 fp32", 192, 28, 32, "fp32", 0, 0, 7),
    ("nano 64 s0", 256, 16, 16, "bf16", 0, 0, 4),
    ("nano 64 s1, 32 s0", 512, 8, 16, "bf16", 0, 0, 4),
    ("nano 32 s1", 1024, 4, 16, "bf16", 0, 0, 4),
    ("nano 64 s0 fp32", 64, 16, 16, "fp32", 0, 0, 4),
    ("nano 64 s1 fp32", 128, 8, 16, "fp32", 0, 0, 4),
]
SC_GRADS = ("q", "k", "v", "k_glo", "v_glo")
# Heads of the ViL-T stage of each head dim (stage 0: 48 = 1 x 48; stage
# 1: 96 = 3 x 32), for the layout copies around a call.
SC_HEADS = {48: 1, 32: 3}
# Row 7, the qkv-layout window attention: (label, windows B_, C, nH,
# stage resolution H, shifted, dtype name, calls per eval forward batch).
# fp32: the eval slice, B=64 images at 224 px (12 calls per forward);
# bf16: the qkv-layout train route's shapes, the 224 crops (2B images)
# and the 96 crops (8B images; stages 2-3 take the sub-window path).
PWA_SHAPES = [
    ("224 s0", 4096, 96, 3, 56, False, "fp32", 1),
    ("224 s0 shifted", 4096, 96, 3, 56, True, "fp32", 1),
    ("224 s1", 1024, 192, 6, 28, False, "fp32", 1),
    ("224 s1 shifted", 1024, 192, 6, 28, True, "fp32", 1),
    ("224 s2", 256, 384, 12, 14, False, "fp32", 3),
    ("224 s2 shifted", 256, 384, 12, 14, True, "fp32", 3),
    ("224 s3", 64, 768, 24, 7, False, "fp32", 2),
    ("224 s0", 4096, 96, 3, 56, False, "bf16", 0),
    ("224 s0 shifted", 4096, 96, 3, 56, True, "bf16", 0),
    ("224 s1", 1024, 192, 6, 28, False, "bf16", 0),
    ("224 s1 shifted", 1024, 192, 6, 28, True, "bf16", 0),
    ("224 s2", 256, 384, 12, 14, False, "bf16", 0),
    ("224 s2 shifted", 256, 384, 12, 14, True, "bf16", 0),
    ("224 s3", 64, 768, 24, 7, False, "bf16", 0),
    ("96 s0", 4096, 96, 3, 24, False, "bf16", 0),
    ("96 s0 shifted", 4096, 96, 3, 24, True, "bf16", 0),
    ("96 s1", 1024, 192, 6, 12, False, "bf16", 0),
    ("96 s1 shifted", 1024, 192, 6, 12, True, "bf16", 0),
]
TOL = {"bf16": 3e-2, "fp32": 2e-5}
# The eval slice: batch, synthetic train / val images, image side, classes.
EVAL_BATCH = 64
EVAL_TRAIN, EVAL_VAL, EVAL_SIZE, EVAL_CLASSES = 2048, 512, 256, 10


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


def ptxas_registers(report):
    """{mangled kernel name: registers} from nvcc's -Xptxas -v report."""
    regs, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def check_tile_registers(wa, regs):
    """Every window-attention tile kernel's registers against what
    ops/window_attention.py tile_plan assumes: the warps an SM holds at
    the kernel's registers (allocated in units of 8 a thread) must be at
    least the plan's _SM_WARPS_MAX / _SM_WARPS_MAX_BWD. Returns the lines
    it checked."""
    checked = []
    for name, n in regs.items():
        if "window_attention_bwd_tile_kernel" in name:
            cap = wa._SM_WARPS_MAX_BWD[2 if "bfloat16" in name else 4]
        elif "window_attention_tile_kernel" in name:
            cap = wa._SM_WARPS_MAX[2 if "bfloat16" in name else 4]
        else:
            continue
        fits = wa._SM_REGS // (-(-n // 8) * 8 * 32)
        if fits < cap:
            raise AssertionError(
                f"{name}: {n} registers hold {fits} warps per SM, but "
                f"tile_plan assumes {cap}")
        checked.append(f"{name[:60]} {n} regs: {fits} warps/SM >= plan {cap}")
    return checked


def sliding_chunk_registers(sc, wa, regs):
    """Lines for the sliding-chunk tensor-core kernels of nvcc's report,
    each instantiation (KD = round16(M) / 16 head-dim steps): registers,
    and the blocks an SM holds by registers (allocated in units of 8 a
    thread) and by shared memory at W=7, M=16 KD, one global."""
    threads = 32 * -(-49 // 16)
    lines = []
    for name, n in regs.items():
        m = re.search(r"sliding_chunk_(fwd|bwd_q|bwd_k)_tc_kernelILi(\d)E",
                      name)
        if m:
            kernel, kd = m.group(1), int(m.group(2))
            smem = sc.kernel_smem_bytes(7, 16 * kd, 1, 2)[kernel]
            by_regs = wa._SM_REGS // (-(-n // 8) * 8 * threads)
            by_smem = SM_SMEM_BYTES // (smem + 1024)
            lines.append(f"sliding_chunk_{kernel}_tc_kernel<{kd}> {n} regs: "
                         f"{by_regs} blocks/SM by registers, {by_smem} by "
                         f"shared memory ({smem} bytes at W=7 M={16 * kd})")
    return sorted(lines)


def phase_build(cuda_build, wa, sc):
    """Build every library; hold the tile kernels' registers to the plan
    (a library built before this run has no report and is not checked)."""
    t0 = time.perf_counter()
    regs = {}
    for name, (lib, report) in cuda_build.build_all(KERNELS).items():
        log(f"built {lib.name}")
        for line in report.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("  " + line.strip())
        regs.update(ptxas_registers(report))
    log(f"build: {time.perf_counter() - t0:.2f} s")
    lines = check_tile_registers(wa, regs)
    if regs and len(lines) < 10:
        raise AssertionError(f"found {len(lines)} tile kernels in the "
                             "ptxas report, expected 10")
    for line in lines:
        log(f"registers {line}")
    sc_lines = sliding_chunk_registers(sc, wa, regs)
    if regs and len(sc_lines) != 12:
        raise AssertionError(f"found {len(sc_lines)} sliding-chunk "
                             "tensor-core kernels in the ptxas report, "
                             "expected 12")
    for line in sc_lines:
        log(f"registers {line}")


class Tally:
    """One kernel's per-step sums over the shapes of its path: calls x
    median ms of the kernel, its plain version and the library call (if
    any), and calls x the bytes and operations of its bound; the largest
    normalised error over every checked shape."""

    def __init__(self, library: bool = False, flop_rate=BF16_FLOP_PER_S):
        self.err = 0.0
        self.ms = self.plain_ms = 0.0
        self.library_ms = 0.0 if library else None
        self.nbytes = self.flops = 0.0
        self.flop_rate = flop_rate

    def add(self, calls, ms, plain_ms, nbytes, flops, library_ms=None):
        self.ms += calls * ms
        self.plain_ms += calls * plain_ms
        self.nbytes += calls * nbytes
        self.flops += calls * flops
        if self.library_ms is not None:
            self.library_ms += calls * library_ms

    def record(self):
        t_bytes = self.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.flops / self.flop_rate * 1e3
        return {"max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": self.library_ms}


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


# kernel_split's one entry when no profiler session recorded device time.
EVENTS_TOTAL = "all-kernels-cuda-events"


def kernel_split(torch, fn, reps=REPS, sessions=3):
    """Device ms per call of fn by kernel name: torch.profiler's CUDA
    kernel events over `reps` calls (after a warm-up), each kernel's summed
    duration divided by reps, largest first.

    A profiler session has come back with no device events at all on the
    H100, midway through this script after two dozen sessions that recorded
    them, so an empty session is retried, up to `sessions` in all. If every one is empty, fn is timed with CUDA events
    instead (_median_ms), and the split is that one total under
    EVENTS_TOTAL, with a line saying so. The split is a measurement only:
    nothing it returns decides whether the run passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                us = evt.time_range.elapsed_us()
                split[evt.name] = split.get(evt.name, 0.0) + us / 1e3 / reps
        if split:
            return dict(sorted(split.items(), key=lambda kv: -kv[1]))
        log(f"kernel_split: profiler session {session} of {sessions} "
            "recorded no device time")
    log(f"kernel_split: timed with CUDA events instead, as one entry "
        f"({EVENTS_TOTAL})")
    return {EVENTS_TOTAL: _median_ms(torch, fn)}


def _kernel_key(name):
    """A kernel's bare name: no return type, namespaces, template arguments
    or parameters; a block-fused forward stage kernel keeps its stage
    (fused_block_fwd_tc_kernel<WN, S> is "F<S> fused_block_fwd_tc")."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.search(r"(fused_block_fwd_\w+)_kernel<(?:\d+, )?(\d+)>", name)
    if m:
        return f"F{m.group(2)} {m.group(1)}"
    return re.split(r"[(<]", name, maxsplit=1)[0].split()[-1].split("::")[-1]


def _split_line(split, top=8):
    """`name ms` of the largest entries of a kernel_split, by bare name."""
    short = {}
    for name, ms in split.items():
        short[_kernel_key(name)] = short.get(_kernel_key(name), 0.0) + ms
    items = sorted(short.items(), key=lambda kv: -kv[1])[:top]
    return ", ".join(f"{n} {ms:.4f}" for n, ms in items)


def phase_window_attention(torch, wa, wops):
    """Kernel vs plain at the slice's shapes, and the library call
    (scaled_dot_product_attention, the bias + shift mask as its float
    attn_mask; its backward gives dq, dk, dv, not dbias). Returns a Tally
    per kernel."""
    F = torch.nn.functional
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = wa._lib()
    for N in range(1, 65):
        for hd in range(1, 65):
            for itemsize in (2, 4):
                for backward in (False, True):
                    count = (lib.esvit_window_attention_bwd_smem_bytes
                             if backward else
                             lib.esvit_window_attention_tile_smem_bytes)
                    for warps in range(1, 9):
                        want = count(N, hd, itemsize, warps)
                        if want != wa.tile_smem_bytes(N, hd, itemsize, warps,
                                                      backward):
                            raise AssertionError(
                                f"tile_smem_bytes({N}, {hd}, {itemsize}, "
                                f"{warps}, {backward}) is not the kernel's "
                                f"{want}")
                    plan = wa.tile_plan(64, N, hd, 3, 1, itemsize,
                                        backward=backward)
                    if plan.smem > limit:
                        raise AssertionError(
                            f"tile plan {plan} at N={N} hd={hd} (backward "
                            f"{backward}) needs more than {limit} bytes")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tally = {"fwd": Tally(library=True), "bwd": Tally(library=True)}
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
        tally["fwd"].err = max(tally["fwd"].err, errs[0])
        tally["bwd"].err = max(tally["bwd"].err, *errs[1:])

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

        # The library call on (B, nW*nH, N, hd) heads, mask (nW*nH, N, N).
        nW = region.shape[0] if shifted else 1
        mask = bias[None]
        if shifted:
            differ = region[:, :, None] != region[:, None, :]
            mask = mask + torch.where(differ, -100.0, 0.0)[:, None]
        mask = mask.reshape(nW * nH, N, N).to(dtype)

        def heads(t):
            return (t.reshape(B_ // nW, nW, N, nH, C // nH).permute(0, 1, 3, 2, 4)
                    .reshape(B_ // nW, nW * nH, N, C // nH).contiguous())

        q4, k4, v4, do4 = (heads(t) for t in (q, k, v, do))
        with torch.no_grad():
            l_fwd = _median_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale))
        ts = [t.clone().requires_grad_() for t in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*ts, attn_mask=mask, scale=scale)
        l_bwd = _median_ms(torch, lambda: torch.autograd.grad(
            out, ts, do4, retain_graph=True))
        del out, ts, q4, k4, v4, do4

        isz = q.element_size()
        rows = B_ * N * C * isz
        tables = nH * N * N * 4 + (region.numel() * 4 if shifted else 0)
        work = {"fwd": (4 * rows + tables, 4 * B_ * N * N * C),
                "bwd": (7 * rows + tables + nH * N * N * 4,
                        10 * B_ * N * N * C)}
        tally["fwd"].add(n_fwd, t_fwd, p_fwd, *work["fwd"], l_fwd)
        tally["bwd"].add(n_bwd, t_bwd, p_bwd, *work["bwd"], l_bwd)
        rate = FP32_FLOP_PER_S if dt == "fp32" else BF16_FLOP_PER_S
        bound = {k: max(b / HBM_BYTES_PER_S, f / rate) * 1e3
                 for k, (b, f) in work.items()}
        log(f"kernel-vs-plain {label:20s} B_={B_:5d} C={C:3d} nH={nH:2d} "
            f"{dt}: max err out {errs[0]:.2e} dq {errs[1]:.2e} "
            f"dk {errs[2]:.2e} dv {errs[3]:.2e} dbias {errs[4]:.2e} "
            f"(tol {TOL[dt]:.0e}); dbias bit-identical on repeat")
        log(f"  time {label:20s} fwd kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms sdpa {l_fwd:.4f} ms bound {bound['fwd']:.4f} ms "
            f"| bwd kernel {t_bwd:.4f} ms plain {p_bwd:.4f} ms sdpa "
            f"{l_bwd:.4f} ms bound {bound['bwd']:.4f} ms")
    return tally


def _fused_case(torch, wops, B, C, nH, H, shifted, dtype, gen, ws=7):
    """Inputs of one block-fused call at a slice shape, drawn on the card:
    (x, params, keep1, keep2, region, pad, geometry, output gradient).
    H < ws is the augmented window: the H*H real tokens and the virtual
    token, whose pad multiplier is 0 and whose bias row is 0, as the model
    builds them. Both drop-path scales drop one image."""
    dev = torch.device("cuda")
    M = 4 * C
    region = pad = None
    if H < ws:
        N, nW = H * H + 1, 1
        pad = torch.ones(N, device=dev)
        pad[-1] = 0.0
    else:
        Hp = -(-H // ws) * ws
        N, nW = ws * ws, (Hp // ws) ** 2
        ss = ws // 2 if shifted else 0
        if shifted:
            region = torch.as_tensor(wops.window_region_ids(H, H, ws, ss),
                                     device=dev)
        if Hp != H:
            pad = torch.as_tensor(wops.pad_token_mask(H, H, Hp, Hp, ws, ss),
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
    if H < ws:
        params["bias"][:, -1] = 0.0
        x[:, -1] = 0.0
        do[:, -1] = 0.0
    keep1 = torch.full((B,), 1 / 0.9, device=dev)
    keep2 = keep1.clone()
    keep1[0] = keep2[-1] = 0.0
    geometry = (N, nH, nW, (C // nH) ** -0.5, 1e-6)
    return (x.to(dtype), params, keep1, keep2, region, pad, geometry,
            do.to(dtype))


def phase_fused(torch, fb, wa, wops):
    """The block-fused pair vs its plain version at the default route's
    block shapes. Returns per-kernel max error and the per-step
    kernel/plain milliseconds."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = fb._lib()
    for C in range(32, fb._MAX_C + 1, 32):
        for itemsize in (2, 4):
            need = {"forward": lib.esvit_fused_block_fwd_smem_bytes(
                        C, 4 * C, itemsize),
                    "backward": lib.esvit_fused_block_bwd_smem_bytes(
                        C, fb.token_rows(C, itemsize), itemsize)}
            for what, n in need.items():
                if n > limit:
                    raise AssertionError(
                        f"the {what}'s token tiles at C={C} need {n} bytes "
                        f"of shared memory (card: {limit})")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tally = {"fwd": Tally(), "bwd": Tally()}
    split_step = {"fwd": {}, "bwd": {}}
    cublas_step = 0.0
    for label, B, C, nH, H, shifted, dt, n_fwd, n_bwd, ws in FUSED_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, params, k1, k2, region, pad, geo, do = _fused_case(
            torch, wops, B, C, nH, H, shifted, dtype, gen, ws)
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
        tally["fwd"].err = max(tally["fwd"].err, errs["out"])
        tally["bwd"].err = max(tally["bwd"].err,
                               *(errs[n] for n in FUSED_GRADS))
        del got, again, ref
        for what, stage_errors in (("fwd", fb.fwd_stage_errors),
                                   ("bwd", fb.bwd_stage_errors)):
            args = (x, params, k1, k2) + ((do,) if what == "bwd" else ())
            stages = stage_errors(*args, **kw)
            bad = {n: e for n, e in stages.items() if e > TOL[dt]}
            if bad:
                raise AssertionError(f"fused {label}: {what} stage errors "
                                     f"{bad} above {TOL[dt]}")
            log(f"fused-stages {label:22s} {dt} {what}: " + ", ".join(
                f"{n} {e:.2e}" for n, e in stages.items())
                + f" (tol {TOL[dt]:.0e})")

        with torch.no_grad():
            t_fwd = _median_ms(torch, lambda: fb._fwd(
                x, params, k1, k2, region, pad, geo))
            p_fwd = _median_ms(torch, lambda: fb.fused_swin_block_plain(
                x, params, k1, k2, **kw))
            t_cublas = _cublas_ms(torch, x, params)
        cublas_step += n_fwd * t_cublas
        t_bwd = _median_ms(torch, lambda: fb._bwd(
            x, params, k1, k2, region, pad, do, geo))
        splits = {"fwd": kernel_split(torch, lambda: fb._fwd(
                      x, params, k1, k2, region, pad, geo)),
                  "bwd": kernel_split(torch, lambda: fb._bwd(
                      x, params, k1, k2, region, pad, do, geo))}
        for what, calls in (("fwd", n_fwd), ("bwd", n_bwd)):
            for name, ms in splits[what].items():
                key = _kernel_key(name)
                split_step[what][key] = (split_step[what].get(key, 0.0)
                                         + calls * ms)
        xs = x.clone().requires_grad_()
        ps = {n: t.clone().requires_grad_() for n, t in params.items()}
        out = fb.fused_swin_block_plain(xs, ps, k1, k2, **kw)
        p_bwd = _median_ms(torch, lambda: torch.autograd.grad(
            out, [xs, *ps.values()], do, retain_graph=True))
        del out, xs, ps
        # Bound: the block's products (q/k/v, proj, fc1, fc2: 24 C^2 per
        # token; attention 4 N C per token), 3x in the backward (the
        # recompute and two transposed products per layer), on x, the
        # output (gradient) rows and the fp32 parameters.
        T = x.shape[0] * x.shape[1]
        rows = T * C * x.element_size()
        pbytes = 4 * sum(t.numel() for t in params.values())
        tables = sum(4 * t.numel() for t in (region, pad, k1, k2)
                     if t is not None)
        flops = 2 * T * 12 * C * C + 4 * T * N * C
        tally["fwd"].add(n_fwd, t_fwd, p_fwd, 2 * rows + pbytes + tables,
                         flops)
        tally["bwd"].add(n_bwd, t_bwd, p_bwd, 3 * rows + 2 * pbytes + tables,
                         3 * flops)
        top = sorted(((n if n == "out" else f"d{n}", e)
                      for n, e in errs.items()), key=lambda kv: -kv[1])[:3]
        log(f"fused-vs-plain {label:22s} B={B:3d} W={ws} N={N} nW={nW:2d} "
            f"C={C:3d} nH={nH:2d} {dt}: max err out {errs['out']:.2e} dx "
            f"{errs['x']:.2e}, largest {', '.join(f'{n} {e:.2e}' for n, e in top)}"
            f" (tol {TOL[dt]:.0e}); all 19 results bit-identical on repeat")
        bound = {k: max(b / HBM_BYTES_PER_S, f / BF16_FLOP_PER_S
                        if dt == "bf16" else f / FP32_FLOP_PER_S) * 1e3
                 for k, (b, f) in (("fwd", (2 * rows + pbytes + tables, flops)),
                                   ("bwd", (3 * rows + 2 * pbytes + tables,
                                            3 * flops)))}
        log(f"  time {label:22s} fwd kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms bound {bound['fwd']:.4f} ms cublas four products "
            f"{t_cublas:.4f} ms | bwd kernel {t_bwd:.4f} ms plain "
            f"{p_bwd:.4f} ms bound {bound['bwd']:.4f} ms")
        for what in ("fwd", "bwd"):
            log(f"  split {label:22s} {what} "
                f"{sum(splits[what].values()):.4f} ms: "
                f"{_split_line(splits[what])}")
    for what in ("fwd", "bwd"):
        log(f"fused {what} split per default step (ms, torch.profiler): "
            + json.dumps({k: round(v, 4) for k, v in sorted(
                split_step[what].items(), key=lambda kv: -kv[1]) if v}))
    log(f"fused fwd per default step {tally['fwd'].ms:.4f} ms beside cublas "
        f"four products {cublas_step:.4f} ms (timed only)")
    return tally


def _cublas_ms(torch, x, params):
    """The yardstick of the block-fused forward: one torch.matmul (cuBLAS)
    per product of the block (q/k/v, proj, fc1, fc2) on rows of the
    shape's size in x's dtype; timed only, never on the port's path."""
    rows, C = x.shape[0] * x.shape[1], x.shape[2]
    M = params["w1"].shape[1]
    gen = torch.Generator(device=x.device).manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=x.device).to(x.dtype)

    y, g = r(rows, C), r(rows, M)
    ws = [torch.cat([params["wq"], params["wk"], params["wv"]], 1),
          params["wp"], params["w1"], params["w2"]]
    wqkv, wp, w1, w2 = (w.to(x.dtype) for w in ws)
    return _median_ms(torch, lambda: (y @ wqkv, y @ wp, y @ w1, g @ w2))


def phase_pallas_window_attention(torch, pwa, wops):
    """Row 7 vs its plain version at the eval slice's and the train
    route's shapes, and the library call (scaled_dot_product_attention,
    the dense bias as its float attn_mask). Returns the Tally of the
    forward, summed per eval forward batch (fp32 peak for the bound)."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tally = Tally(library=True, flop_rate=FP32_FLOP_PER_S)
    N = 49
    for label, B_, C, nH, H, shifted, dt, calls in PWA_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        hd, scale = C // nH, (C // nH) ** -0.5
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dtype)
        do = torch.randn(B_, N, C, generator=gen, device=dev).to(dtype)
        bias = 0.3 * torch.randn(1, nH, N, N, generator=gen, device=dev)
        if shifted:
            mask = torch.as_tensor(wops.shifted_window_mask(H, H, 7, 3),
                                   device=dev)
            bias = (bias + mask[:, None]).contiguous()
        nWm = bias.shape[0]

        def grads(fn):
            q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
            out = fn(q, b, nH, scale)
            return [out.detach(), *torch.autograd.grad(out, (q, b), do)]

        got, again, ref = (grads(pwa._PallasWindowAttention.apply),
                           grads(pwa._PallasWindowAttention.apply),
                           grads(pwa.pallas_window_attention_plain))
        if not torch.isfinite(got[0]).all():
            raise AssertionError(f"pallas {label} {dt}: kernel out not finite")
        if not torch.equal(got[0], again[0]):
            raise AssertionError(f"pallas {label} {dt}: out differs between "
                                 "two runs")
        for name, a, b in zip(("dqkv", "dbias"), got[1:], ref[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"pallas {label} {dt}: {name} is not the "
                                     "plain version's")
        s_ = max(ref[0].float().abs().max().item(), 1e-6)
        err = (got[0].float() - ref[0].float()).abs().max().item() / s_
        if err > TOL[dt]:
            raise AssertionError(f"pallas {label} {dt}: error {err:.2e} above "
                                 f"{TOL[dt]}")
        tally.err = max(tally.err, err)
        plain_out = ref[0]
        del got, again, ref

        # The library call on (B_/nWm, nWm*nH, N, hd) heads, mask
        # (nWm*nH, N, N); its output is held to the plain one first.
        def heads(t):
            return (t.reshape(B_ // nWm, nWm, N, nH, hd).permute(0, 1, 3, 2, 4)
                    .reshape(B_ // nWm, nWm * nH, N, hd).contiguous())

        q4, k4, v4 = (heads(t) for t in qkv.reshape(B_, N, 3, C).unbind(2))
        lmask = bias.reshape(nWm * nH, N, N).to(dtype)
        with torch.no_grad():
            lib_out = F.scaled_dot_product_attention(q4, k4, v4,
                                                     attn_mask=lmask,
                                                     scale=scale)
            lib_out = (lib_out.reshape(B_ // nWm, nWm, nH, N, hd)
                       .permute(0, 1, 3, 2, 4).reshape(B_, N, C))
            lib_err = (lib_out.float() - plain_out.float()).abs().max().item() / s_
            if lib_err > TOL[dt]:
                raise AssertionError(f"pallas {label} {dt}: the library call "
                                     f"is {lib_err:.2e} from plain")
            del lib_out, plain_out
            t_fwd = _median_ms(torch, lambda: pwa._fwd(qkv, bias, nH, scale))
            p_fwd = _median_ms(torch, lambda: pwa.pallas_window_attention_plain(
                qkv, bias, nH, scale))
            l_fwd = _median_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=lmask, scale=scale))
        del q4, k4, v4, lmask

        # Bound: qkv read once, the dense bias once, the output written
        # once; q k^T and p v, 4 hd flops per (query, key) pair.
        isz = qkv.element_size()
        nbytes = 4 * B_ * N * C * isz + bias.numel() * 4
        flops = 4 * B_ * nH * N * N * hd
        tally.add(calls, t_fwd, p_fwd, nbytes, flops, l_fwd)
        rate = FP32_FLOP_PER_S if dt == "fp32" else BF16_FLOP_PER_S
        bound = max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3
        log(f"pallas-vs-plain {label:16s} B_={B_:5d} C={C:3d} nH={nH:2d} "
            f"nWm={nWm:2d} {dt}: max err out {err:.2e} (tol {TOL[dt]:.0e}); "
            f"out bit-identical on repeat; dqkv, dbias equal to plain; sdpa "
            f"out vs plain {lib_err:.2e}")
        log(f"  time {label:16s} {dt} kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms sdpa {l_fwd:.4f} ms bound {bound:.4f} ms "
            f"(calls per eval batch {calls})")
    return tally


def phase_forward_parity(torch, C, fb, wa, pwa):
    """The Swin-T backbone on the default fused route, on the
    window-attention route, on the qkv-layout route and on the plain
    route, fp32, same weights, 2 images at 224 and 96 px: relative error
    <= 1e-4 to the plain one, for forward_features and for
    forward_return_n_last_blocks(x, 4) (the probe's features, which every
    route computes in its classic block loop); each kernel's launches
    equal to the model-derived count."""
    from esvit_tpu_torch.models.swin import SwinTransformer

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    fused = SwinTransformer(C.swin_tiny(drop_path_rate=0.0),
                            generator=gen).to(dev)
    routes = {
        "fused": fused,
        "window-attention": SwinTransformer(C.swin_tiny(
            drop_path_rate=0.0, fused_block_stages=())).to(dev),
        "qkv-layout": SwinTransformer(C.swin_tiny(
            drop_path_rate=0.0, attention_impl="pallas",
            fused_block_stages=())).to(dev),
        "plain": SwinTransformer(C.swin_tiny(
            drop_path_rate=0.0, attention_impl="xla",
            fused_block_stages=())).to(dev),
    }
    for model in routes.values():
        model.load_state_dict(fused.state_dict())
    kernel_routes = ("fused", "window-attention", "qkv-layout")

    def check(what, a, b):
        err = ((a - b).abs().max() / b.abs().max()).item()
        if not (torch.isfinite(a).all() and err <= 1e-4):
            raise AssertionError(f"{what}: {err:.2e} from plain")
        log(f"swin-t {what} fp32: rel err vs plain {err:.2e} (tol 1e-4), "
            f"shape {tuple(a.shape)}")

    def run(what, fn, size, capture):
        """fn on every route with the launch counts set to 0 just before;
        each kernel's forward launches equal to the sum of the routes'
        model-derived counts (capturing calls no fused block)."""
        for counter in (fb, wa, pwa):
            counter.launches["fwd"] = 0
        with torch.no_grad():
            out = {name: fn(model) for name, model in routes.items()}
        want = {
            "fused_block": 0 if capture else sum(
                m.fused_block_calls(size) for m in routes.values()),
            "window_attention": sum(m.window_attention_calls(size, capture)
                                    for m in routes.values()),
            "pallas_window_attention": sum(
                m.pallas_window_attention_calls(size, capture)
                for m in routes.values()),
        }
        got = {"fused_block": fb.launches["fwd"],
               "window_attention": wa.launches["fwd"],
               "pallas_window_attention": pwa.launches["fwd"]}
        if got != want:
            raise AssertionError(f"{what} {size}px: launches {got}, "
                                 f"model-derived {want}")
        for name in kernel_routes:
            check(f"{what} {size}px: {name} route", out[name], out["plain"])
        log(f"swin-t {what} {size}px: forward launches {got}")

    for size in (224, 96):
        x = torch.randn(2, size, size, 3, generator=gen).to(dev)
        run("forward_features", lambda m: m.forward_features(x)[1], size,
            False)
        run("forward_return_n_last_blocks(x, 4)",
            lambda m: m.forward_return_n_last_blocks(x, 4), size, True)


def _sc_keys(n: int, W: int, nglo: int) -> int:
    """Keys summed over the n x n queries of one (image, head) of a
    sliding-chunk call: the globals and the real tokens of each query's
    in-grid 3 x 3 chunk neighbourhood (what this data needs, not the
    padded 9 W^2)."""
    m = -(-n // W)
    real = [min(W, n - W * c) for c in range(m)]
    near = [sum(real[max(c - 1, 0):c + 2]) for c in range(m)]
    return sum(real[i] * real[j] * (nglo + near[i] * near[j])
               for i in range(m) for j in range(m))


def _sc_library_mask(torch, n: int, W: int, nglo: int, dev):
    """(n*n, nglo + n*n) bool, True where a query of the n x n grid may
    attend: the globals, and the tokens of the in-grid 3 x 3 chunk
    neighbourhood of its own W x W chunk."""
    c = torch.arange(n, device=dev) // W
    near = (c[:, None] - c[None, :]).abs() <= 1
    local = (near[:, None, :, None] & near[None, :, None, :]).reshape(
        n * n, n * n)
    return torch.cat([torch.ones(n * n, nglo, dtype=torch.bool, device=dev),
                      local], 1)


def _stand_in(torch):
    """A stand-in for the sliding-chunk call in :func:`_sc_layout_split`:
    the output is q itself, and each input's gradient is a tensor of its
    shape made in the forward (no kernel), so only the layout copies
    around the call reach the device."""

    class StandIn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, kg, vg):
            ctx.grads = [torch.empty_like(t) for t in (k, v, kg, vg)]
            return q.view_as(q)

        @staticmethod
        def backward(ctx, g):
            return (g, *ctx.grads)

    return StandIn


def _sc_layout_split(torch, BH, n, M, nglo, dtype, gen):
    """Device ms per call of the layout copies around one sliding-chunk
    call, (forward, backward): models/vil_layers.py Long2DSCAttention's
    permutes of q, k, v and the globals into (BH, nx, ny, M) grids and of
    the output back to tokens, and their gradients' copies in autograd,
    with the call itself a stand-in (_stand_in). torch.profiler over REPS
    calls, as kernel_split; timed only."""
    H = SC_HEADS[M]
    B, C, N = BH // H, H * M, nglo + n * n
    call = _stand_in(torch)
    dev = torch.device("cuda")
    q_lin = torch.randn(B, n * n, C, generator=gen, device=dev).to(dtype)
    kv_lin = torch.randn(B, N, 2 * C, generator=gen, device=dev).to(dtype)
    g_out = torch.randn(B, n * n, C, generator=gen, device=dev).to(dtype)

    def around(q_lin, kv_lin):
        q = q_lin.reshape(B, n * n, H, M)
        kv = kv_lin.reshape(B, N, 2, H, M)
        grid = (BH, n, n, M)
        q = q.permute(0, 2, 1, 3).reshape(grid)
        k, v = (kv[:, nglo:, i].permute(0, 2, 1, 3).reshape(grid)
                for i in (0, 1))
        kg, vg = (kv[:, :nglo, i].permute(0, 2, 1, 3).reshape(BH, nglo, M)
                  for i in (0, 1))
        x1 = call.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           kg.contiguous(), vg.contiguous())
        return x1.reshape(B, H, n * n, M).permute(0, 2, 1, 3).reshape(
            B, n * n, C)

    def both():
        ins = [t.requires_grad_() for t in (q_lin.detach(), kv_lin.detach())]
        torch.autograd.grad(around(*ins), ins, g_out)

    with torch.no_grad():
        fwd = sum(kernel_split(torch, lambda: around(q_lin, kv_lin)).values())
    return fwd, sum(kernel_split(torch, both).values()) - fwd


def phase_sliding_chunk(torch, sc):
    """The sliding-chunk pair vs its plain version at the ViL-T slice's
    shapes, each kernel vs its staged twin, and the library call
    (scaled_dot_product_attention with the neighbourhood as a boolean
    attn_mask; its backward gives all five gradients); the pair's device
    time by kernel and the layout copies around it. Returns a Tally per
    kernel."""
    F = torch.nn.functional
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = sc._lib()
    for W in range(1, 9):
        for M in range(8, 65, 8):
            for nglo in range(9):
                need = lib.esvit_sliding_chunk_smem_bytes(W, M, nglo)
                if sc.supports(W, M, nglo) and need > limit:
                    raise AssertionError(
                        f"supports() admits W={W} M={M} nglo={nglo}, whose "
                        f"blocks need {need} bytes of shared memory (card: "
                        f"{limit})")
                for dtype, itemsize in ((0, 4), (1, 2)):
                    mirror = sc.kernel_smem_bytes(W, M, nglo, itemsize)
                    for which, name in enumerate(("fwd", "bwd_q", "bwd_k")):
                        own = lib.esvit_sliding_chunk_kernel_smem_bytes(
                            W, M, nglo, dtype, which)
                        if own != mirror[name]:
                            raise AssertionError(
                                f"kernel_smem_bytes({W}, {M}, {nglo}, "
                                f"{itemsize})[{name}] = {mirror[name]}, the "
                                f"kernel's own count {own}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    tally = {"fwd": Tally(library=True), "bwd": Tally(library=True)}
    split_step = {"fwd": {}, "bwd": {}, "layout fwd": 0.0, "layout bwd": 0.0}
    nglo = 1
    for label, BH, n, M, dt, n_fwd, n_bwd, W in SC_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32

        def r(*shape, s=1.0):
            return (s * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

        inputs = (r(BH, n, n, M, s=M ** -0.5), r(BH, n, n, M),
                  r(BH, n, n, M), r(BH, nglo, M), r(BH, nglo, M))
        do = r(BH, n, n, M)
        kw = dict(nx=n, ny=n, W=W)

        def kernel(*ts, nx, ny, W):
            return sc._SlidingChunk.apply(*ts, nx, ny, W)

        def grads(fn):
            ts = [t.clone().requires_grad_() for t in inputs]
            out = fn(*ts, **kw)
            return [out.detach()] + list(torch.autograd.grad(out, ts, do))

        got, again, ref = (grads(kernel), grads(kernel),
                           grads(sc.sliding_chunk_attention_plain))
        errs = {}
        for name, a, b, c in zip(("out",) + SC_GRADS, got, again, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"sliding chunk {label}: kernel {name} "
                                     "not finite")
            if not torch.equal(a, b):
                raise AssertionError(f"sliding chunk {label}: {name} differs "
                                     "between two runs")
            s = max(c.float().abs().max().item(), 1e-6)
            errs[name] = (a.float() - c.float()).abs().max().item() / s
        bad = {n_: e for n_, e in errs.items() if e > TOL[dt]}
        if bad:
            raise AssertionError(f"sliding chunk {label}: errors {bad} above "
                                 f"{TOL[dt]}")
        tally["fwd"].err = max(tally["fwd"].err, errs["out"])
        tally["bwd"].err = max(tally["bwd"].err, *(errs[g] for g in SC_GRADS))
        del got, again, ref
        stages = sc.stage_errors(*inputs, do, **kw)
        bad = {n_: e for n_, e in stages.items() if e > TOL[dt]}
        if bad:
            raise AssertionError(f"sliding chunk {label}: kernel vs twin "
                                 f"errors {bad} above {TOL[dt]}")
        log(f"sliding-chunk-stages {label:14s} {dt}: " + ", ".join(
            f"{n_} {e:.2e}" for n_, e in stages.items())
            + f" (tol {TOL[dt]:.0e})")

        with torch.no_grad():
            t_fwd = _median_ms(torch, lambda: sc._fwd(*inputs, n, n, W))
            p_fwd = _median_ms(torch, lambda: sc.sliding_chunk_attention_plain(
                *inputs, **kw))
            _, stats = sc._fwd(*inputs, n, n, W)
        t_bwd = _median_ms(torch, lambda: sc._bwd(*inputs, stats, do, n, n, W))
        ts = [t.clone().requires_grad_() for t in inputs]
        out = sc.sliding_chunk_attention_plain(*ts, **kw)
        p_bwd = _median_ms(torch, lambda: torch.autograd.grad(
            out, ts, do, retain_graph=True))
        del out, ts

        # The library call: SDPA over the flattened grid, keys [globals |
        # grid], with the neighbourhood as a boolean mask (q is pre-scaled,
        # so scale 1). Its output is held to the plain one before timing.
        q3, k3, v3, do3 = (t.reshape(BH, n * n, M)
                           for t in (*inputs[:3], do))
        kk, vv = (torch.cat([g, t], 1).contiguous()
                  for g, t in ((inputs[3], k3), (inputs[4], v3)))
        mask = _sc_library_mask(torch, n, W, nglo, dev)
        with torch.no_grad():
            lib_out = F.scaled_dot_product_attention(q3, kk, vv,
                                                     attn_mask=mask, scale=1.0)
            plain_out = sc.sliding_chunk_attention_plain(*inputs, **kw)
            s = max(plain_out.float().abs().max().item(), 1e-6)
            lib_err = (lib_out.reshape(plain_out.shape).float()
                       - plain_out.float()).abs().max().item() / s
            if lib_err > TOL[dt]:
                raise AssertionError(f"sliding chunk {label}: the library "
                                     f"call is {lib_err:.2e} from plain")
            del lib_out, plain_out
            l_fwd = _median_ms(torch, lambda: F.scaled_dot_product_attention(
                q3, kk, vv, attn_mask=mask, scale=1.0))
        ts = [t.clone().requires_grad_() for t in (q3, kk, vv)]
        out = F.scaled_dot_product_attention(*ts, attn_mask=mask, scale=1.0)
        l_bwd = _median_ms(torch, lambda: torch.autograd.grad(
            out, ts, do3, retain_graph=True))
        del out, ts, kk, vv, mask

        # Bound: q k^T and p v over the valid keys (4 M flops per key), 10 M
        # in the backward (s and dp recomputed, dv, dq, dk); the grids and
        # globals read once, the outputs written once.
        keys = BH * _sc_keys(n, W, nglo)
        grid = BH * n * n * M * inputs[0].element_size()
        glo = 2 * BH * nglo * M * inputs[0].element_size()
        tally["fwd"].add(n_fwd, t_fwd, p_fwd, 4 * grid + glo, 4 * M * keys,
                         l_fwd)
        tally["bwd"].add(n_bwd, t_bwd, p_bwd, 7 * grid + 2 * glo,
                         10 * M * keys, l_bwd)
        log(f"sliding-chunk-vs-plain {label:14s} BH={BH:3d} {n}x{n} W={W} "
            f"M={M} nglo={nglo} {dt}: max err "
            + ", ".join(f"{k_} {e:.2e}" for k_, e in errs.items())
            + f" (tol {TOL[dt]:.0e}); all 6 results bit-identical on repeat; "
            f"sdpa out vs plain {lib_err:.2e}")
        rate = BF16_FLOP_PER_S if dt == "bf16" else FP32_FLOP_PER_S
        bound = {k: max(b / HBM_BYTES_PER_S, f / rate) * 1e3
                 for k, (b, f) in (("fwd", (4 * grid + glo, 4 * M * keys)),
                                   ("bwd", (7 * grid + 2 * glo,
                                            10 * M * keys)))}
        log(f"  time {label:14s} fwd kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms sdpa {l_fwd:.4f} ms bound {bound['fwd']:.4f} ms "
            f"| bwd kernel {t_bwd:.4f} ms plain {p_bwd:.4f} ms sdpa "
            f"{l_bwd:.4f} ms bound {bound['bwd']:.4f} ms")
        splits = {"fwd": kernel_split(torch, lambda: sc._fwd(*inputs, n, n,
                                                             W)),
                  "bwd": kernel_split(torch, lambda: sc._bwd(
                      *inputs, stats, do, n, n, W))}
        # The layout copies are timed at ViL-T's shapes (their heads in
        # SC_HEADS).
        layout = (_sc_layout_split(torch, BH, n, M, nglo, dtype, gen)
                  if W == 7 else (0.0, 0.0))
        for what, calls in (("fwd", n_fwd), ("bwd", n_bwd)):
            for name, ms in splits[what].items():
                key = _kernel_key(name)
                split_step[what][key] = (split_step[what].get(key, 0.0)
                                         + calls * ms)
            log(f"  split {label:14s} {what} "
                f"{sum(splits[what].values()):.4f} ms: "
                f"{_split_line(splits[what])}")
        split_step["layout fwd"] += n_fwd * layout[0]
        split_step["layout bwd"] += n_bwd * layout[1]
        if W == 7:
            log(f"  layout copies {label:14s} (models/vil_layers.py, around "
                f"one call): fwd {layout[0]:.4f} ms bwd {layout[1]:.4f} ms")
    for what in ("fwd", "bwd"):
        log(f"sliding chunk {what} split per ViL-T step (ms, torch.profiler): "
            + json.dumps({k: round(v, 4) for k, v in sorted(
                split_step[what].items(), key=lambda kv: -kv[1]) if v}))
    log(f"sliding chunk layout copies per ViL-T step (ms, torch.profiler): "
        f"fwd {split_step['layout fwd']:.4f} bwd "
        f"{split_step['layout bwd']:.4f}")
    return tally


def phase_vil_forward_parity(torch, C, sc):
    """The ViL-T backbone on the kernel route and the plain route
    (fused_sc='off'), fp32, same weights, 2 images at 224 and 96 px:
    relative error <= 1e-4."""
    from esvit_tpu_torch.models.vil import MsViT

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    kernel = MsViT(C.vil_tiny(), generator=gen).to(dev)
    plain = MsViT(C.vil_tiny(fused_sc="off")).to(dev)
    plain.load_state_dict(kernel.state_dict())
    for size in (224, 96):
        x = torch.randn(2, size, size, 3, generator=gen).to(dev)
        sc.launches["fwd"] = 0
        with torch.no_grad():
            a = kernel.forward_features(x)[1]
            if sc.launches["fwd"] != kernel.sliding_chunk_calls(size):
                raise AssertionError(
                    f"vil forward {size}px: {sc.launches['fwd']} launches, "
                    f"model-derived {kernel.sliding_chunk_calls(size)}")
            b = plain.forward_features(x)[1]
        err = ((a - b).abs().max() / b.abs().max()).item()
        if not (torch.isfinite(a).all() and err <= 1e-4):
            raise AssertionError(f"vil forward {size}px: kernel route vs "
                                 f"plain {err:.2e}")
        log(f"vil-t forward_features {size}px fp32: kernel route vs plain "
            f"rel err {err:.2e} (tol 1e-4), shape {tuple(a.shape)}")


def _derived_launches(cfg, steps):
    """Per-kernel launches of `steps` train steps, from the model's routing
    (its ``<kernel>_calls``; 0 for a kernel the backbone never calls): the
    teacher runs the 224 crops forward, the student all crops forward and
    backward."""
    from esvit_tpu_torch.models.registry import build_backbone

    probe = build_backbone(cfg.model)
    g, l = cfg.crops.global_size, cfg.crops.local_size
    want = {}
    for name, (_, kinds) in KERNELS.items():
        calls = getattr(probe, f"{name}_calls", lambda size: 0)
        per_step = {"fwd": 2 * calls(g) + calls(l), "bwd": calls(g) + calls(l)}
        want[name] = {k: per_step[k] * steps for k in kinds}
    return want


def _slice(torch, cfg, steps, counters, label, card, check_state,
           **train_kw):
    """train() for `steps` steps (on ``train_kw``'s data, else synthetic
    crops on the card) with every launch count set to 0 just before and
    read just after: finite losses, the launch counts of every kernel equal
    to the model's, and (check_state) student, teacher and both centers
    changed. Returns the counts and train()'s per-step records."""
    import gc

    from esvit_tpu_torch.train.train import train

    want = _derived_launches(cfg, steps)
    init = _initial_weights(torch, cfg) if check_state else None
    for launches in counters.values():
        for k in launches:
            launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    state, history = train(cfg, max_steps=steps, device="cuda", **train_kw)
    torch.cuda.synchronize()
    got = {name: dict(launches) for name, launches in counters.items()}
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    ms = statistics.mean(h["seconds"] for h in history[1:]) * 1e3
    ips = cfg.crops.ncrops * BATCH / (ms / 1e3)
    log(f"slice {label}: losses {losses}")
    log(f"slice {label}: launches {got}")
    log(f"slice {label}: W=7 B={BATCH} 2x224+8x96 DDINO out_dim 65536 "
        f"bf16: {ms:.1f} ms/step, {ips:.1f} img/s over steps 2-{steps}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB [{card}]")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, model-derived {want}")
    if check_state:
        moved = {
            "student": _max_change(torch, state.student, init),
            "teacher": _max_change(torch, state.teacher, init),
            "center": state.centers.center.abs().max().item(),
            "center_grid": state.centers.center_grid.abs().max().item(),
        }
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"{label}: state did not change: {moved}")
        log(f"slice {label}: max change {moved}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return got, history


def phase_slice(torch, C, counters, card, out_dir):
    """Swin-T on the default (fused) route for STEPS steps, then on the
    window-attention route for 3 and on the qkv-layout route for 3 (its
    backward is autograd of the plain version: forward launches only)."""
    cfg = C.swin_tiny_multicrop(BATCH, output_dir=out_dir)
    got, history = _slice(torch, cfg, STEPS, counters, "Swin-T fused route",
                          card, True)
    _slice(torch, cfg.replace(model=C.swin_tiny(fused_block_stages=())), 3,
           counters, "Swin-T window-attention route", card, False)
    _slice(torch, cfg.replace(model=C.swin_tiny(attention_impl="pallas",
                                                fused_block_stages=())), 3,
           counters, "Swin-T qkv-layout route", card, False)
    return got, statistics.mean(h["seconds"] for h in history[1:]) * 1e3


def phase_data_slice(torch, C, counters, card, out_dir, synthetic_ms):
    """Swin-T on the default route fed by MultiCropIterator over
    ProceduralShapesHard(256 px, DATA_IMAGES x B images), NUM_THREADS host
    threads, augmentation on the card, for DATA_STEPS steps through
    train(): the same checks as the synthetic slice, ms per step beside the
    synthetic one of this call, and the host's wait on the feed per step;
    the batch that train() consumed at step 1 (its record's 'inputs') on
    the card, fp32, finite, of the crops' shapes, each channel's mean and
    std in a band around the normalisation (DATA_MEAN_BAND,
    DATA_STD_BAND). Then the feed alone on the same data: the host
    batches per second of NUM_THREADS workers, and the device time of one
    batch's upload and augmentation (CUDA events)."""
    from esvit_tpu_torch.data import augment_device
    from esvit_tpu_torch.data.datasets import ProceduralShapesHard
    from esvit_tpu_torch.data.loader import MultiCropIterator

    cfg = C.swin_tiny_multicrop(BATCH, output_dir=out_dir)
    ds = ProceduralShapesHard(n=DATA_IMAGES * BATCH, size=256, seed=0)
    _, history = _slice(torch, cfg, DATA_STEPS, counters, "Swin-T data-fed",
                        card, True, dataset=ds)
    steady = history[1:]
    ms = statistics.mean(h["seconds"] for h in steady) * 1e3
    waits = [h["data_seconds"] * 1e3 for h in steady]
    log(f"slice Swin-T data-fed: {ms:.1f} ms/step over steps 2-{DATA_STEPS} "
        f"beside synthetic_device {synthetic_ms:.1f} ms/step in this call; "
        f"host wait on the feed {statistics.mean(waits):.2f} ms/step (max "
        f"{max(waits):.2f}); ProceduralShapesHard 256 px, {NUM_THREADS} "
        f"threads, augmentation on the card [{card}]")

    # The batch train() consumed at step 1, as train() read it.
    want = {"global": (2 * BATCH, cfg.crops.global_size),
            "local": (cfg.crops.local_crops_number * BATCH,
                      cfg.crops.local_size)}
    for name, x in history[0]["inputs"].items():
        n, side = want[name]
        mean, std = x["mean"], x["std"]
        if (x["device"] != "cuda" or x["dtype"] != "torch.float32"
                or x["shape"] != (n, side, side, 3) or not x["finite"]):
            raise AssertionError(f"data-fed step 1 {name}: {x}")
        if not (all(DATA_MEAN_BAND[0] <= m <= DATA_MEAN_BAND[1]
                    for m in mean)
                and all(DATA_STD_BAND[0] <= v <= DATA_STD_BAND[1]
                        for v in std)):
            raise AssertionError(
                f"data-fed step 1 {name}: channel means {mean}, stds {std} "
                f"outside {DATA_MEAN_BAND} / {DATA_STD_BAND}")
        log(f"data-fed step 1 {name} {x['shape']} on {x['device']}: "
            f"channel means {[round(m, 3) for m in mean]}, stds "
            f"{[round(v, 3) for v in std]}")

    # The feed alone on the same epoch: its rate, and the device time
    # of one batch's upload and augmentation.
    it = MultiCropIterator(ds, cfg.crops, BATCH, epoch=0, seed=cfg.seed,
                           num_threads=NUM_THREADS, device="cuda")
    t0 = time.perf_counter()
    host = [b for _, b in zip(range(DATA_STEPS), it.host_batches())]
    host_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed << 16)
    g_u8, l_u8 = host[0]
    aug_ms = _median_ms(torch, lambda: augment_device.augment_multicrop(
        g_u8.to("cuda", non_blocking=True), l_u8.to("cuda", non_blocking=True),
        gen))
    upload_ms = _median_ms(torch, lambda: (
        g_u8.to("cuda", non_blocking=True), l_u8.to("cuda", non_blocking=True)))
    mb = (g_u8.numel() + l_u8.numel()) / 1e6
    log(f"data feed alone: {len(host)} host batches of {BATCH} images in "
        f"{host_s:.2f} s ({len(host) / host_s:.2f} batches/s, "
        f"{NUM_THREADS} threads, the first included); uint8 upload "
        f"{mb:.1f} MB {upload_ms:.3f} ms; upload + augmentation "
        f"{aug_ms:.3f} ms per batch (CUDA events) [{card}]")


def phase_canary(torch, counters, card):
    """The learning gate's Swin leg (esvit_tpu_torch/validate_learning.py,
    nano Swin, shapes_hard) for CANARY_STEPS steps with every launch count
    set to 0 just before and read just after: a finite last loss and
    centres, the block-fused launches equal to the model's (the steps and
    the two k-NN evals' fp32 forwards), no other kernel. No gain gate."""
    from esvit_tpu_torch import validate_learning as vl
    from esvit_tpu_torch.models.registry import build_backbone

    cfg, _ = vl.build_config(steps=CANARY_STEPS)
    want = _derived_launches(cfg, CANARY_STEPS)
    # Two k-NN evals (before, after) of 512 + 256 images in batches of 32.
    knn_batches = 2 * (-(-512 // 32) + -(-256 // 32))
    probe = build_backbone(cfg.model)
    want["fused_block"]["fwd"] += knn_batches * probe.fused_block_calls(
        cfg.crops.global_size)
    for launches in counters.values():
        for k in launches:
            launches[k] = 0
    res = vl.validate(steps=CANARY_STEPS, backbone="swin", device="cuda")
    torch.cuda.synchronize()
    got = {name: dict(launches) for name, launches in counters.items()}
    log(f"canary nano Swin shapes_hard: {res['before']:.2f}% -> "
        f"{res['after']:.2f}% 10-NN in {res['steps']} steps, "
        f"{res['seconds']:.1f} s, last loss {res['last_loss']:.4f}, "
        f"|centres|max {res['center_max']}; launches {got} [{card}]")
    if not (res["steps"] == CANARY_STEPS and math.isfinite(res["last_loss"])
            and all(map(math.isfinite, res["center_max"].values()))):
        raise AssertionError(f"canary: {res}")
    if got != want:
        raise AssertionError(f"canary: launches {got}, model-derived {want}")


def phase_route_order(torch, C, card, out_dir):
    """The Swin-T default route and fused_block_stages=() in turns,
    ROUTE_ROUNDS rounds of ROUTE_STEPS steps each (the second route first
    in odd rounds), in this process: each route's median ms per step over
    steps 2..ROUTE_STEPS of its rounds, the spread, and which is faster."""
    import gc

    from esvit_tpu_torch.train.train import train

    cfg = C.swin_tiny_multicrop(BATCH, output_dir=out_dir)
    routes = {"default": cfg,
              "fused_block_stages=()": cfg.replace(
                  model=C.swin_tiny(fused_block_stages=()))}
    ms = {name: [] for name in routes}
    for rnd in range(ROUTE_ROUNDS):
        for name in list(routes)[::1 if rnd % 2 == 0 else -1]:
            _, history = train(routes[name], max_steps=ROUTE_STEPS,
                               device="cuda")
            torch.cuda.synchronize()
            steps = [h["seconds"] * 1e3 for h in history[1:]]
            ms[name] += steps
            log(f"route order round {rnd + 1} {name}: "
                + ", ".join(f"{t:.1f}" for t in steps) + " ms/step")
            gc.collect()
            torch.cuda.empty_cache()
    for name, steps in ms.items():
        log(f"route order {name}: median {statistics.median(steps):.1f} "
            f"ms/step, spread {min(steps):.1f}-{max(steps):.1f} over "
            f"{len(steps)} steps of {ROUTE_ROUNDS} rounds [{card}]")
    faster = min(ms, key=lambda n: statistics.median(ms[n]))
    log(f"route order: {faster} is faster by the median")


def phase_vil_slice(torch, C, counters, card, out_dir):
    """ViL-T for STEPS steps."""
    cfg = C.vil_tiny_multicrop(BATCH, output_dir=out_dir)
    return _slice(torch, cfg, STEPS, counters, "ViL-T", card, True)[0]


def phase_eval(torch, C, pwa, card, out_dir):
    """The eval slice: Swin-T on the qkv-layout route, fp32, random
    weights (seed 0), batch EVAL_BATCH, synthetic images through the PIL
    transforms: k-NN at k 10/20/100/200, then the linear probe on cached
    4-last-block features. Checks the features, the accuracies and the
    kernel's launches against the model-derived count; returns them."""
    import numpy as np

    from esvit_tpu_torch.data.datasets import SyntheticImages
    from esvit_tpu_torch.evals import knn, linear
    from esvit_tpu_torch.models.registry import build_backbone

    dev = torch.device("cuda")
    cfg = C.swin_tiny(attention_impl="pallas", fused_block_stages=())
    backbone = build_backbone(
        cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    train_ds = SyntheticImages(EVAL_TRAIN, EVAL_SIZE, EVAL_CLASSES, seed=0)
    val_ds = SyntheticImages(EVAL_VAL, EVAL_SIZE, EVAL_CLASSES, seed=1)
    images = EVAL_TRAIN + EVAL_VAL
    batches = -(-EVAL_TRAIN // EVAL_BATCH) + -(-EVAL_VAL // EVAL_BATCH)

    def run(label, fn, per_batch):
        pwa.launches["fwd"] = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, want = pwa.launches["fwd"], per_batch * batches
        if got != want:
            raise AssertionError(f"eval {label}: {got} launches, "
                                 f"model-derived {want}")
        log(f"eval {label}: {images} images in {seconds:.2f} s, "
            f"{images / seconds:.1f} img/s, {seconds * 1e3 / batches:.1f} ms "
            f"per batch of {EVAL_BATCH} (host PIL transform included); "
            f"launches {got} = {per_batch} x {batches} batches [{card}]")
        return result, got

    res, knn_launches = run("k-NN", lambda: knn.run_knn_eval(
        backbone, train_ds, val_ds, batch_size=EVAL_BATCH, dump_dir=out_dir,
        device=dev), backbone.pallas_window_attention_calls(224))
    for name, n in (("train", EVAL_TRAIN), ("test", EVAL_VAL)):
        f = np.load(os.path.join(out_dir, f"{name}feat.npy"))
        norm_err = np.abs(np.linalg.norm(f, axis=1) - 1).max()
        if f.shape != (n, cfg.num_features) or not (
                np.isfinite(f).all() and norm_err < 1e-5):
            raise AssertionError(f"eval k-NN {name} features {f.shape}, "
                                 f"|norm - 1| up to {norm_err:.2e}")
    if sorted(res) != [10, 20, 100, 200] or not all(
            0.0 <= a <= 100.0 for acc in res.values() for a in acc):
        raise AssertionError(f"eval k-NN results {res}")
    log(f"eval k-NN (random weights, {EVAL_CLASSES} classes): {res}")

    acc, probe_launches = run("linear probe", lambda: linear.run_linear_eval(
        backbone, train_ds, val_ds, n_last_blocks=4, epochs=5,
        feat_batch=EVAL_BATCH, cached_features=True, device=dev),
        backbone.pallas_window_attention_calls(224, capture=True))
    if not all(0.0 <= a <= 100.0 for a in acc):
        raise AssertionError(f"eval linear probe accuracies {acc}")
    log(f"eval linear probe (random weights, cached features, 5 epochs): "
        f"top1 {acc[0]:.2f} top5 {acc[1]:.2f}")

    x = torch.randn(EVAL_BATCH, 224, 224, 3, device=dev)
    with torch.inference_mode():
        feats = backbone.forward_return_n_last_blocks(x, 4)
        dim = linear.feature_dim_for(cfg, 4)
        if feats.shape != (EVAL_BATCH, dim) or not torch.isfinite(feats).all():
            raise AssertionError(f"eval probe features {tuple(feats.shape)}, "
                                 f"want ({EVAL_BATCH}, {dim})")
        t_knn = _median_ms(torch, lambda: backbone.forward_features(x))
        t_probe = _median_ms(torch, lambda: backbone.forward_return_n_last_blocks(
            x, 4))
    log(f"eval device forward, batch {EVAL_BATCH} fp32: forward_features "
        f"{t_knn:.2f} ms ({EVAL_BATCH / t_knn * 1e3:.1f} img/s), "
        f"forward_return_n_last_blocks {t_probe:.2f} ms "
        f"({EVAL_BATCH / t_probe * 1e3:.1f} img/s), {dim}-dim probe "
        f"features [{card}]")
    return {"fwd": knn_launches + probe_launches}


def _initial_weights(torch, cfg):
    """The student's initial weights, as train() draws them (seed cfg.seed)."""
    from esvit_tpu_torch.train.step import EsViTTrainer

    model = EsViTTrainer(cfg, device="cpu").build_model(
        torch.Generator().manual_seed(cfg.seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _max_change(torch, model, init):
    return max((p.detach().cpu() - init[n]).abs().max().item()
               for n, p in model.state_dict().items() if p.numel())


def main():
    if not os.path.isdir(os.path.join(ROOT, "esvit_tpu_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repo: "
                           "esvit_tpu_torch/ is not beside it")
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    card = phase_device(torch)
    from esvit_tpu_torch import config as C
    from esvit_tpu_torch.ops import cuda_build
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import pallas_window_attention as pwa
    from esvit_tpu_torch.ops import sliding_chunk as sc
    from esvit_tpu_torch.ops import window as wops
    from esvit_tpu_torch.ops import window_attention as wa

    phase_build(cuda_build, wa, sc)
    if sys.argv[1:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}")
    results = {"window_attention": phase_window_attention(torch, wa, wops),
               "fused_block": phase_fused(torch, fb, wa, wops),
               "sliding_chunk": phase_sliding_chunk(torch, sc),
               "pallas_window_attention": {
                   "fwd": phase_pallas_window_attention(torch, pwa, wops)}}
    phase_forward_parity(torch, C, fb, wa, pwa)
    phase_vil_forward_parity(torch, C, sc)
    counters = {"window_attention": wa.launches, "fused_block": fb.launches,
                "sliding_chunk": sc.launches,
                "pallas_window_attention": pwa.launches}
    with tempfile.TemporaryDirectory() as out_dir:
        swin, synthetic_ms = phase_slice(torch, C, counters, card, out_dir)
        phase_data_slice(torch, C, counters, card, out_dir, synthetic_ms)
        phase_route_order(torch, C, card, out_dir)
        vil = phase_vil_slice(torch, C, counters, card, out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        evals = phase_eval(torch, C, pwa, card, out_dir)
    phase_canary(torch, counters, card)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    launches = dict(swin, sliding_chunk=vil["sliding_chunk"],
                    pallas_window_attention=evals)
    record = {"kernels": [
        {"name": f"{name}_{k}", "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1][k], "launches": launches[name][k],
         **tally[k].record()}
        for name, tally in results.items() for k in KERNELS[name][1]]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
