#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Run from the root of a checkout. Phases, in order; any failure raises,
so the script exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit and the
   torch/CUDA versions; TF32 off for the parity checks.
2. Build the four kernel libraries from esvit_tpu_torch/csrc/ (one nvcc
   per source, all started together) and print nvcc's -Xptxas -v report; fail if a
   window-attention tile kernel's registers hold fewer warps per SM than
   ops/window_attention.py tile_plan assumes; the same for the
   large-window tile's forty kernels (N > 64: the block-fused pair's,
   the packed pair's and row 7's, each at KD = 2 and 4 head-dim steps,
   with the bias slice staged and not;
   printed with their spills, blocks and resident warps per SM at N=196);
   print each source's nvcc seconds, the block-fused pair's
   token-tile and weight-GEMM kernels' registers, spills and blocks per
   SM (their LayerNorm rows in registers up to C=512), and the
   sliding-chunk tensor-core kernels' registers, spills and blocks per SM.
3. Window attention vs plain PyTorch on the card at every full-window
   shape of the Swin-T W=7 B=32 multi-crop step (bf16, plus one fp32
   case) and of the Swin-B W=14 B=8 step's packed route (N=196 on the
   large-window tile, N=49 at C=1024; N=145 and an fp32 case): forward
   output and the q/k/v/bias gradients within 3e-2 (bf16) or 2e-5 (fp32)
   after normalising each by its max-abs; all five bit-identical on
   repeat; where a timed step launches the shape, median times over 20
   reps of kernel, plain and the library call
   (scaled_dot_product_attention), with each shape's bound, and the sums
   per Swin-B W=14 packed-route step. First, the tile kernels' shared memory (forward and
   backward) as the wrapper counts it equals the kernels' own count at
   every N up to 256 (the large tile above 64), head dim and dtype, and
   fits a block wherever the shape rules admit the shape.
4. The block-fused kernels vs their plain version at every block shape
   the default (fused) route gives them (Swin-T's at W=7 and at W=14:
   N=196 full and padded windows and the augmented 145, on the
   large-window tile, bf16 and fp32; and the learning gate's nano Swin's
   at W=4: C 32/64/128, N=16 and the augmented window of 5 tokens, bf16,
   and its fp32 eval; and Swin-B's at W=14: C 128 / 256 / 512 at N=196,
   the augmented 145 and 37, with C=512 also at W=7's N=49, on the
   augmented 145 and in fp32), shifted and unshifted, with
   drop-path scales that drop an image (bf16, plus one fp32 case): the
   output, dx and all 17 parameter gradients within the same tolerances
   (dbk, whose exact value is 0, at the scale of the largest gradient);
   every result bit-identical on repeat; each forward stage kernel (F1,
   A1, F2, F3, F4) and each backward stage kernel (T1, A1, T2, A2, T3)
   within the same tolerance of its plain twin on its own inputs; where a
   timed step launches the shape, median times over 20 reps; both
   passes' device time split by kernel
   (torch.profiler), per shape and per default step; beside the forward,
   a yardstick: torch.matmul (cuBLAS) of the block's four products at the
   shape, timed only; the sums per Swin-T W=7, Swin-T W=14 and Swin-B
   W=14 step, and the Swin-B step's C=512 blocks apart. First, both
   passes' token-tile blocks fit the card at every admitted width. Last,
   both fp32 backward kernels of the large-window tile at N=196 with the
   last key column's bias lifted by 16 (``phase_lifted_bias``: the packed
   pair, row 4, and the block-fused backward's attention half, A2): dq,
   dk, dv and dbias against autograd through window_attention_plain in
   float64 on the kernel's own inputs, each within max(2e-5, 2 x the fp32
   plain version's own error) of the fp64 gradient's max-abs, and
   bit-identical on repeat.
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
   shapes), at W=7 and at W=14 (N=196 on the large-window tile; sums per
   W=7 and per W=14 eval batch): the output within the same tolerances
   and bit-identical on repeat; d(qkv) and d(bias) through the autograd wrapper equal to the
   plain version's; median times over 20 reps of kernel, plain and the
   library call (scaled_dot_product_attention, the dense bias as its
   float attn_mask, its output first held to the plain one).
7. Forward parity, fp32, 224 and 96 px, same weights: the Swin-T default
   fused route, the window-attention route (fused_block_stages=()), the
   qkv-layout route (attention_impl='pallas', no fused stages) and the
   plain route (attention_impl='xla', no fused stages) agree within 1e-4
   relative, and so does forward_return_n_last_blocks(x, 4) on each of
   them; each kernel's launches equal the model-derived counts; the same
   at W=14 (stages 0-2 on the large tile on each kernel route); so do
   ViL-T's kernel route and its plain route
   (fused_sc='off').
8. The slices: esvit_tpu_torch.train.train.train() runs 5 steps of Swin-T
   W=7, B=32, 2x224 + 8x96 crops, out_dim 65536, DDINO, bf16, on-device
   synthetic data, on the default fused route; then 3 steps of the
   window-attention route and 3 of the qkv-layout route, then 5 steps of
   ViL-T on the same crops, in the same process. Losses must be finite;
   student, teacher and both centers must change (default route and
   ViL-T); each run's launch counts of every kernel must equal the
   per-step counts derived from the model times the steps. Then the
   route order: the default route and fused_block_stages=() alternate for
   2 rounds of 3 steps each, each on one trainer going on from its
   train() run's state; each route's median ms per step over steps 2-3 of
   its rounds and their spread. Between the two, the data-fed
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
10. The learning canary: 30 steps of esvit_tpu_torch.validate_learning's
   nano Swin leg on shapes_hard (k-NN before and after, no gain gate):
   a finite last loss and centres, and the block-fused launches equal to
   the model's (the steps and the two evals). The full gates are
   ``python -m esvit_tpu_torch.validate_learning --steps 6000``.
11. The entry phase: the pre-training CLI (``python -m
   esvit_tpu_torch.train.train --arch swin_tiny --data_kind synthetic``,
   Swin-T W=7 at full width, B=32, 2x224 + 8x96 crops, 65536-dim heads
   with the dense head, bf16, 8 steps an epoch) and the evals' CLIs in
   subprocesses, each kernel's launches read from the subprocess: 2
   epochs with per-epoch checkpoints, a resume to step 24, the SIGTERM
   save and a resume from it, the checkpoint restored on the card bit for
   bit, a world-size-1 NCCL run against the plain one, and k-NN and the
   linear probe with ``--pretrained`` on the run's checkpoint, in two
   waves of runs at once (see ``phase_entry``). The slices above call
   train() with resume=False: each starts from its own initial weights.
12. The real-image path (``phase_real_images``): 512 JPEGs of 500x375
   and 375x500 (quality 90, 16 classes, 8 of them grayscale) and 2 PNGs,
   drawn from seed 0 and written as a zip with its map file, a TSV with
   its .lineidx and a file list. It prints whether the native library
   (esvit_tpu_torch/native, built with g++ from csrc/datapath.cpp)
   decodes JPEGs itself or, without libjpeg's headers, only crops what
   PIL decoded. On 64 images, all ten boxes of the 224/96 multi-crop:
   the native views against PIL's (decode bit-identical, crop within 1
   LSB, the scaled decode within RMS 4 and mean 2.5); two loader
   batches, native against PIL: host pixels within 1 LSB, augmented on
   the card within mean 0.02. Then train() of Swin-T W=7 (default route,
   B=32, 2x224 + 8x96, 65536-wide heads with the dense head, bf16) fed
   from the zip for 6 steps with the native decode and 6 with PIL, each
   with the slice's checks (finite losses, weights and centres moved,
   launches as derived) and the decode counts (native: the JPEGs read,
   PIL: the PNGs; the PIL leg: every image); ms/step (steps 2-6) beside
   this call's synthetic one, the wait on the feed, and the feed's host
   batches/s alone. Then the train CLI for 4 steps from the zip, and
   from the TSV with --host_aug --use_mixup --num_mixup_views 2: finite
   losses, launches as derived, a checkpoint. Last the k-NN eval of a
   random Swin-T (qkv-layout route, fp32) from the zip against the file
   list through the native eval transform: the decode counts and row 7's
   launches.
13. The CvT and ViT families (``phase_families``): cvt_tiny (CvT-T,
   BatchNorm in every block's q/k/v projection) and deit_small (DeiT-S/16)
   at full width, plain PyTorch (esvit_tpu runs their attention as plain
   XLA: no TPU kernel lies on this path). The train CLI's runs below
   start first, and the parity runs beside them: the fp32 forward on the
   card (TF32 off) against the CPU on the same seeded weights, at 224 px (4
   images) and 96 px (8), features within 1e-4 of the largest |feature|,
   CvT's on running and on batch statistics, its running buffers after
   each bn_train forward within 1e-4 of the largest |buffer|; then
   train() of cvt_tiny_multicrop and deit_small_multicrop (B=32, 2x224 +
   8x96, 65536-wide heads with the dense head, bf16, synthetic crops on
   the card) for 6 steps each: finite losses, student, teacher and centres
   moved, for CvT every BatchNorm's running mean and variance moved in
   both nets and the teacher's apart from the student's, and no launch of
   the seven kernels; ms/step (steps 2-6) and peak memory. The train
   CLI in subprocesses: cvt_tiny 4 steps and deit_small 2 at once, the
   CvT checkpoint restored on the card with every BatchNorm buffer equal
   to the file's; then at once a resume for a fifth step and the k-NN and
   linear-probe CLIs on a copy of the step-4 checkpoint; no kernel
   launches.
14. The training options (``phase_options``): (a) the K-streamed DDINO
   loss: fp32 (TF32 off) Swin-T at B=4, one batch and one set of
   weights, the streamed loss, both centres and the heads' gradients
   within 1e-4 relative of the dense loss's; then train() at full width
   (B=32, 2x224 + 8x96, 65536-wide heads, bf16), 3 steps each of dense
   and streamed for Swin-T and DeiT-S, ms/step and peak memory, failing
   unless DeiT-S's streamed peak is below its dense one; (b) remat: the
   fp32 B=4 Swin-T loss and every gradient on fused_block_stages=() with
   remat='block' against 'none' from one generator seed within 1e-6, then
   3 full-width bf16 steps of each, ms/step and peak memory (the
   window-attention forward launched again in each recompute, as
   derived); (c) Swin-T with drop_rate = attn_drop_rate = 0.1 for 3
   steps: finite losses, every kernel's launches as derived (none: any
   dropout keeps the fused routes off, attention dropout both
   window-attention kernels); (d) frozen_layers ('patch_embed',
   'layers_0') for 3 steps: those student parameters bit-identical to
   their start, the rest moved; (e) ResNet-50 (torchvision layout, cuDNN
   convolutions): the fp32 forward on the card against the CPU at 224 px
   (4 images) and 96 px (8) within 1e-4, on running statistics the whole
   network, on batch statistics each block on the CPU's input to it (the
   whole network printed: fp32 statistics round differently on the two
   devices and compound through 16 blocks), and the running buffers after
   each bn_train pass; train() at full width
   with LARS and BatchNorm heads for 5 steps and with SGD for 3: finite
   losses, student, teacher and centres moved, every backbone BatchNorm
   buffer moved in both nets and the head's in the student only, no
   launch of the seven kernels, ms/step and peak memory; k-NN and the
   linear probe through the API on synthetic images; (f) the CLI with
   ``--optimizer lars --use_bn_in_head --frozen_layers patch_embed`` for
   2 steps in a subprocess, its checkpoint restored on the card with the
   LARS trace equal to the file's bit for bit, and a resume for a third
   step.
15. The rest of ViL (``phase_vil_options``), each leg ViL-T at full
   width through train() (B=32, 2x224 + 8x96, 65536-wide heads, bf16,
   one epoch of 8 steps), printing ms/step and peak memory: (a) the
   neighbour-mode schedule, ``vil_tiny(mode=1, mode_switch=0.5)`` for 8
   steps: steps 0-3 draw a neighbour per net and launch no sliding-chunk
   kernel, steps 4-7 launch what the mode-0 step does, each half's
   ms/step and peak; (b) per-layer draws (``per_layer_mode``), (c)
   relative position bias on the two sparse stages (the card's fp32
   forward against the CPU's at 2 images of 224 and 96 px within 1e-4
   first), (d) Performer, SRFormer and Linformer (on the global crops
   only: its sequence length is fixed at the 224 px grid, as in
   esvit_tpu), 2 steps each, no sliding-chunk launch; (e) the k-NN and
   linear-probe CLIs on leg (a)'s checkpoint, their launches as derived.
16. The last modules (``phase_last_modules``): (a) the analysis CLI
   (``python -m esvit_tpu_torch.analysis.cli``) in subprocesses, fp32,
   on 16 seeded 256 px PNGs in two classes: ``measure_entropy`` and
   ``measure_correspondence`` of Swin-T W=7 at 224 px from a
   reference-layout .pth written from a seeded Swin-T,
   ``measure_correspondence`` of a seeded ViL-T, and ``vis_attention``
   where matplotlib is installed (the phase says whether it ran); each
   run's launches of rows 1, 3 and 5 equal to the model-derived counts,
   its log.txt record finite; then in-process on the same weights, the
   last block's attention maps and both models' flip features on the
   card against the CPU within 1e-4, their launches as derived. (b)
   ``AxialAttention``, ``CrissCrossAttention``, ``ConvQKVAttention``
   (``conv``, ``dw_bn_glu_pw``, ``pw_glu_conv_bn_swish_pw``),
   ``DownAttention`` and ``CrossScaleAttention`` (stride 2) at a DeiT-S
   block's width (dim 384, 6 heads, 14x14 + CLS, B=64), ``T2TModule`` at
   T2T-ViT-14's (embed 384, token_dim 64, 224 px, B=32), ``SELayer2D``,
   ``DyReLU2``, ``FrozenBatchNorm`` and ``DropBlock`` (block 7) at
   ResNet-50's stage-2 map (28x28x512, B=64), BatchNorm statistics
   drawn away from their init: forward and backward, fp32 output and
   every gradient on the card within 1e-4 of the CPU's (relative to the
   largest value), bf16 finite, the median ms of 5 forward + backward
   passes and the peak GiB. (c) ``utils/flops.py`` ``summarize`` of
   Swin-T, ViL-T and DeiT-S at 224 px (counted on the CPU). (d) The
   BASELINE runbook (``python -m esvit_tpu_torch.reproduce_baseline
   --arch swin_tiny --linear_epochs 2``, the gate on) at Swin-T W=7's full
   width and 224 px, fp32, on a reference-layout .pth of the port's
   Swin-T init (seed 0) over 256 train / 64 val noise PNGs in 4 classes,
   and the k-NN CLI on the same files, both at once with (a)'s runs: the
   runbook exits 1 with its four stages, FAIL and ``gate_pass`` false
   (random weights sit near chance, far under the published 75.7), its
   k-NN top-1 at each k equal to the k-NN CLI's, and each run's launches
   of rows 1 and 3 (k-NN's forwards, the probe's 4-last-block capture
   forwards) equal to the model-derived counts.

17. Swin-T at W=14 (``phase_swin_w14``, after the route order): the
   Swin-T multi-crop recipe with window_size=14 (B=32, 2x224 + 8x96,
   65536-wide heads, DDINO, bf16, seed 0, synthetic crops on the card),
   3 steps on the kernel route (the block-fused pair on the large-window
   tile at stages 0-2; launches as derived, 30 forward and 20 backward a
   step: 22 / 12 at N=196, 2 / 2 at N=145, 6 / 6 at N=37; finite losses,
   state moved), 3 on the plain route (fused_block_stages=(),
   attention_impl='xla': no kernel), each with its peak memory, then 2
   alternating rounds of 3 steps on one trainer per route: each route's
   median ms/step and spread (the routes side by side on one line), and
   its device time by kernel group (torch.profiler); the fp32 eval
   forward on the
   qkv-layout route (batch 64 at 224 px: row 7's launches as derived,
   the ms per batch); the k-NN CLI at --window_size 14 in fp32 on noise
   images, the card's features within 1e-4 of the CPU's.
18. Swin-B at W=14 (``phase_swin_b_w14``, after phase 17): the same
   recipe with model=swin_base(window_size=14) at B=8 (bench.py's
   swin_base_w14), on three routes through train(), 3 steps each with the
   slice's checks (finite losses, state moved, launches as derived): the
   kernel route (the block-fused pair at C=128/256/512, 66 forward and 44
   backward launches a step, 54 / 36 at C=512; the packed pair 4 / 2 at
   stage 3), the packed route (fused_block_stages=(): the packed pair 50
   / 26, 46 / 24 at N=196 on the large-window tile) and the plain route
   (also attention_impl='xla': no kernel); each run's ms/step and peak
   memory; then 2 alternating rounds of 3 steps on one trainer per route:
   each route's median ms/step and spread (side by side on one line), and
   its device time by kernel group (torch.profiler).
19. The DINO head's tensor parallelism (``phase_head_tp``): the Swin-T
   W=7 B=32 recipe (one step an epoch, no warm-up, the last layer free,
   lr 3.2e-5 from step 1) through train() for 1 step and, resumed from
   its checkpoint, to 3, once in this process at model=1 and once in two
   spawned processes sharing cuda:0 over gloo at data=1 x model=2
   (``--mesh_model 2``: each rank half of both heads' last layers, of
   their moments, of the centers and of the region logits): the losses
   at every step within 1e-3; after step 1 every parameter within 2e-4
   / 1e-4 and the centers within 1e-5 / 1e-7; after steps 1 and 3 the
   student's and the teacher's change from the initial weights and each
   parameter's AdamW moments within 0.1 of their own norms, every
   parameter but the pinned weight_g moved; the replicated parameters
   bit-identical on both ranks, the block-fused and window-attention
   launches as derived in every run; each rank's peak memory beside the
   model=1 run's, and the ms/step of two processes sharing one card
   (not a tensor-parallel speed). Then the two ranks take one step with
   each of two planted faults (a summing backward of the model group's
   sum; the replicated gradients unsummed), and each must fail those
   gates. With two cards or more the same over NCCL; else one line says
   that leg waits for such a machine.
20. Only with ``--parent DIR`` (a checkout of an earlier commit, e.g. a
   ``git archive`` under the gitignored _archive/): the large-window
   tile's rows (rows 1-2 per Swin-T and Swin-B W=14 step, rows 3-4 per
   Swin-B W=14 packed-route step, row 7 per W=14 eval batch) timed by
   utils/fwd_compare.py's large worker in DIR (its kernels built there)
   and here, side by side; DIR's sums go into the kernels line as
   ``parent_ms`` (null without DIR, and on the rows of N <= 64).

Each phase's seconds are printed after it (``phase <n> ...: <s> s``).
The script's time is bounded (the card's check stops it at 1200 s), so
from phase 11 on, subprocesses that do not depend on each other run at
once, and beside this process's work where it does not need their
results: phase 11's two waves; phase 12's two train CLIs beside its
k-NN eval; phase 13's two train CLIs beside its parity, its resume with
its evals; phase 14's LARS CLI beside (c)-(d) and its resume beside
(e); phase 15's evals beside legs (b)-(d); phase 16's analysis commands,
the runbook and its k-NN CLI beside its in-process checks; phase 17's
two k-NN runs; phase 19's gloo ranks beside the model=1 runs. A run's
line says which runs went with it, and a time this process prints while
subprocesses run names them ("beside ..."). Phases 1-10 and the timed
rounds of 8, 17 and 18 run alone. The in-process train() slices check that train() asked for its
checkpoint after the last step and do not write it (``_slice``), except
phase 15's schedule leg, whose checkpoint its evals read: the CLI runs
and phase 19 write checkpoints and check what they read back.

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
The ``*_w14_*`` entries are the same for the W=14 cell: the block-fused
pair per W=14 step (launches from phase 17's kernel-route steps) and row
7 per W=14 eval batch (launches from phase 17's eval forward). The
``*_swin_b_w14_*`` entries: the block-fused pair per Swin-B W=14 step
(launches from phase 18's kernel route) and the packed pair per Swin-B
W=14 packed-route step (launches from phase 18's packed route).
The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
STEPS = 5
REPS = 20
# Calls per torch.profiler session of the block-fused phase's per-shape
# splits.
SPLIT_REPS = 10
# The route order: rounds of the default route and fused_block_stages=()
# in turns, and steps per round.
ROUTE_ROUNDS, ROUTE_STEPS = 2, 3
# The data-fed Swin-T slice: steps, images per batch of the procedural
# dataset, host threads (train()'s feed has MultiCropIterator's default
# 4), and the band each channel's mean and std must fall in after
# normalisation (ProceduralShapesHard is dark, mean ~ -0.8).
DATA_STEPS, DATA_IMAGES, NUM_THREADS = 6, 8, 4
DATA_MEAN_BAND, DATA_STD_BAND = (-1.5, 1.5), (0.3, 1.5)
# The nano learning canary's steps.
CANARY_STEPS = 30
# The kernels line's W=14 rows: the block-fused pair on the large tile
# (rows 1-2, launches from phase 17's kernel-route steps) and row 7 on it
# (launches from phase 17's qkv-layout eval forward), beside the W=7 rows.
KERNELS_W14 = ("fused_block", "pallas_window_attention")
# The Swin-B W=14 rows: the block-fused pair at C 128-512 (launches from
# phase 18's kernel route) and the packed pair on the large-window tile
# (launches from phase 18's packed route).
KERNELS_B14 = ("fused_block", "window_attention")
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
# none runs in a Swin-T step. An 11th entry, where there is one, is the
# shape's (forward, backward) calls per Swin-T W=14 step (phase 17's cell):
# the "w14" shapes are W=14's blocks (N = 196 full windows, the 96 px
# stage 0 padded from 24 to 28 tokens a side, its stage 1 the augmented
# window of 145 tokens), and its stage 2 at 96 px is W=7's augmented
# window of 37 tokens.
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
    ("96 s2 augmented", 256, 384, 12, 6, False, "bf16", 6, 6, 7, (6, 6)),
    ("224 s1 shifted fp32", 64, 192, 6, 28, True, "fp32", 0, 0, 7),
    ("w14 224 s0", 64, 96, 3, 56, False, "bf16", 0, 0, 14, (2, 1)),
    ("w14 224 s0 shifted", 64, 96, 3, 56, True, "bf16", 0, 0, 14, (2, 1)),
    ("w14 224 s1", 64, 192, 6, 28, False, "bf16", 0, 0, 14, (2, 1)),
    ("w14 224 s1 shifted", 64, 192, 6, 28, True, "bf16", 0, 0, 14, (2, 1)),
    ("w14 224 s2", 64, 384, 12, 14, False, "bf16", 0, 0, 14, (12, 6)),
    ("w14 96 s0 padded", 256, 96, 3, 24, False, "bf16", 0, 0, 14, (1, 1)),
    ("w14 96 s0 padded shifted", 256, 96, 3, 24, True, "bf16", 0, 0, 14,
     (1, 1)),
    ("w14 96 s1 augmented", 256, 192, 6, 12, False, "bf16", 0, 0, 14, (2, 2)),
    ("w14 224 s0 shifted fp32", 16, 96, 3, 56, True, "fp32", 0, 0, 14),
    ("w14 224 s2 fp32", 16, 384, 12, 14, False, "fp32", 0, 0, 14),
    ("w14 96 s0 padded shifted fp32", 32, 96, 3, 24, True, "fp32", 0, 0, 14),
    ("w14 96 s1 augmented fp32", 32, 192, 6, 12, False, "fp32", 0, 0, 14),
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
# stage resolution H, shifted, dtype name, calls per eval forward batch,
# window size ws, calls per Swin-T W=14 eval forward batch).
# fp32: the eval slice, B=64 images at 224 px (12 calls per forward);
# bf16: the qkv-layout train route's shapes, the 224 crops (2B images)
# and the 96 crops (8B images; stages 2-3 take the sub-window path). The
# "w14" shapes are the same slices at W=14 (N = 196; stage 2 one window
# an image, unshifted; stage 3 is W=7's): 12 calls per eval batch.
PWA_SHAPES = [
    ("224 s0", 4096, 96, 3, 56, False, "fp32", 1),
    ("224 s0 shifted", 4096, 96, 3, 56, True, "fp32", 1),
    ("224 s1", 1024, 192, 6, 28, False, "fp32", 1),
    ("224 s1 shifted", 1024, 192, 6, 28, True, "fp32", 1),
    ("224 s2", 256, 384, 12, 14, False, "fp32", 3),
    ("224 s2 shifted", 256, 384, 12, 14, True, "fp32", 3),
    ("224 s3", 64, 768, 24, 7, False, "fp32", 2, 7, 2),
    ("w14 224 s0", 1024, 96, 3, 56, False, "fp32", 0, 14, 1),
    ("w14 224 s0 shifted", 1024, 96, 3, 56, True, "fp32", 0, 14, 1),
    ("w14 224 s1", 256, 192, 6, 28, False, "fp32", 0, 14, 1),
    ("w14 224 s1 shifted", 256, 192, 6, 28, True, "fp32", 0, 14, 1),
    ("w14 224 s2", 64, 384, 12, 14, False, "fp32", 0, 14, 6),
    ("w14 224 s0 shifted", 1024, 96, 3, 56, True, "bf16", 0, 14, 0),
    ("w14 96 s0 padded shifted", 1024, 96, 3, 24, True, "bf16", 0, 14, 0),
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
# Rows 3-4 at Swin-B's W=14 shapes (phase 18's packed route,
# fused_block_stages=(), B=8: the 224 crops 2B = 16 images, the 96 crops
# 8B = 64): (label, windows B_, C, nH, stage resolution H, shifted, dtype
# name, calls per Swin-B W=14 step: forward, backward, tokens per window
# N). N=196 on the large-window tile at stages 0-2 (stage 2 one window an
# image, unshifted; the 96 px stage 0 padded from 24 to 28 tokens a side);
# the 224 px stage 3 at W=7 (N=49, C=1024); N=145 (a 12 x 12 window + 1,
# the augmented window's size, which no packed call of the step gives)
# and the fp32 case are checked only.
WA_SHAPES_B14 = [
    ("b14 224 s0", 256, 128, 4, 56, False, "bf16", 2, 1, 196),
    ("b14 224 s0 shifted", 256, 128, 4, 56, True, "bf16", 2, 1, 196),
    ("b14 224 s1", 64, 256, 8, 28, False, "bf16", 2, 1, 196),
    ("b14 224 s1 shifted", 64, 256, 8, 28, True, "bf16", 2, 1, 196),
    ("b14 224 s2", 16, 512, 16, 14, False, "bf16", 36, 18, 196),
    ("b14 224 s3", 16, 1024, 32, 7, False, "bf16", 4, 2, 49),
    ("b14 96 s0 padded", 256, 128, 4, 24, False, "bf16", 1, 1, 196),
    ("b14 96 s0 padded shifted", 256, 128, 4, 24, True, "bf16", 1, 1, 196),
    ("b14 145", 64, 256, 8, 12, False, "bf16", 0, 0, 145),
    ("b14 224 s1 shifted fp32", 16, 256, 8, 28, True, "fp32", 0, 0, 196),
]
# The block-fused pair at Swin-B's shapes (C 128 / 256 / 512, nH 4 / 8 /
# 16, head dim 32, M = 4C), FUSED_SHAPES' format with the 11th entry the
# shape's (forward, backward) calls per Swin-B W=14 step (phase 18's
# kernel route, B=8: 2B = 16 images at 224 px, 8B = 64 at 96 px; stage 2
# is one 14 x 14 window at 224 px, so its 18 blocks are unshifted, and the
# augmented 6 x 6 + 1 at 96 px). "b 224 s2" is Swin-B's stage 2 at W=7
# (N=49, four windows an image), "b 145 augmented" the augmented 12 x 12
# + 1 at C=512, and the fp32 case: checked only.
FUSED_SHAPES_B14 = [
    ("b14 224 s0", 16, 128, 4, 56, False, "bf16", 0, 0, 14, (2, 1)),
    ("b14 224 s0 shifted", 16, 128, 4, 56, True, "bf16", 0, 0, 14, (2, 1)),
    ("b14 224 s1", 16, 256, 8, 28, False, "bf16", 0, 0, 14, (2, 1)),
    ("b14 224 s1 shifted", 16, 256, 8, 28, True, "bf16", 0, 0, 14, (2, 1)),
    ("b14 224 s2", 16, 512, 16, 14, False, "bf16", 0, 0, 14, (36, 18)),
    ("b14 96 s0 padded", 64, 128, 4, 24, False, "bf16", 0, 0, 14, (1, 1)),
    ("b14 96 s0 padded shifted", 64, 128, 4, 24, True, "bf16", 0, 0, 14,
     (1, 1)),
    ("b14 96 s1 augmented", 64, 256, 8, 12, False, "bf16", 0, 0, 14, (2, 2)),
    ("b14 96 s2 augmented", 64, 512, 16, 6, False, "bf16", 0, 0, 14,
     (18, 18)),
    ("b 224 s2", 16, 512, 16, 14, False, "bf16", 0, 0, 7),
    ("b 224 s2 shifted", 16, 512, 16, 14, True, "bf16", 0, 0, 7),
    ("b 145 augmented", 16, 512, 16, 12, False, "bf16", 0, 0, 14),
    ("b14 224 s2 fp32", 4, 512, 16, 14, False, "fp32", 0, 0, 14),
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


def ptxas_spills(report):
    """{mangled kernel name: (spill store bytes, spill load bytes)} from
    nvcc's -Xptxas -v report."""
    spills, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            spills[entry] = (int(m.group(1)), int(m.group(2)))
    return spills


def large_tile_registers(wa, regs, spills):
    """Lines for the large-window tile's kernels (N > 64: the block-fused
    pair's and the packed pair's forward and backward tiles, each dtype,
    from csrc/fused_block_large*.cu and csrc/window_attention_large*.cu,
    and row 7's forward tile, each dtype; each at KD = 2 and 4, with the
    bias slice staged and not): registers, spills, the warps an SM holds
    by registers (held to tile_plan's _SM_WARPS_MAX_LARGE, as
    check_tile_registers holds the small tiles) and, for the instance the
    plan launches at Swin's N=196 (head dim 16 KD), the blocks and warps
    an SM holds by shared memory."""
    lines = []
    for name, n in regs.items():
        m = re.search(r"window_attention_large_(bwd_)?kernelI(13__nv_bfloat16|f)"
                      r".*Li(\d)ELb([01])EEEv", name)
        if not m:
            continue
        backward, itemsize = m.group(1) is not None, 2 if m.group(2) != "f" else 4
        kd, staged_kernel = int(m.group(3)), m.group(4) == "1"
        fits = wa._SM_REGS // (-(-n // 8) * 8 * 32)
        cap = wa._SM_WARPS_MAX_LARGE[itemsize]
        if fits < cap:
            raise AssertionError(f"{name}: {n} registers hold {fits} warps per "
                                 f"SM, but tile_plan assumes {cap}")
        hd = 16 * kd
        plan = wa.tile_plan(64, 196, hd, 12, 1, itemsize, backward=backward)
        by_smem = SM_SMEM_BYTES // (plan.smem + 1024)
        staged = wa.large_bias_staged(196, hd, itemsize, plan.warps, backward)
        where = (f"the N=196 hd={hd} plan's instance: {by_smem} blocks of "
                 f"{plan.warps} warps per SM by shared memory ({plan.smem} "
                 f"bytes), {min(by_smem * plan.warps, fits)} warps resident"
                 if staged == staged_kernel else
                 f"not the N=196 hd={hd} plan's instance")
        lines.append(f"{name[:70]} KD={kd} staged={int(staged_kernel)} {n} "
                     f"regs, spills {spills.get(name, (0, 0))} bytes (stores, "
                     f"loads): {fits} warps/SM >= plan {cap}; {where}")
    return sorted(lines)


def fused_block_registers(wa, regs, spills):
    """Lines for the block-fused pair's own kernels (the forward's token
    tiles F1-F4, the backward's T1-T3, the weight GEMMs; each dtype):
    registers, spills and the 256-thread blocks an SM holds by registers.
    The token kernels ask for two blocks per SM (__launch_bounds__(256,
    2): at most 128 registers a thread), their LayerNorm rows held in
    registers up to C=512."""
    lines = []
    for name, n in regs.items():
        m = re.search(r"(fused_bwd_t\d_kernel|fused_block_fwd_\w+?_kernel|"
                      r"wgrad_\w*kernel)(?:(I.*?E)E)?", name)
        if not m:
            continue
        by_regs = wa._SM_REGS // (-(-n // 8) * 8 * 256)
        lines.append(f"{m.group(1)}{m.group(2) or ''} {n} regs, spills "
                     f"{spills.get(name, (0, 0))} bytes (stores, loads): "
                     f"{by_regs} blocks of 256 threads/SM by registers")
    return sorted(lines)


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
    regs, spills = {}, {}
    for name, (lib, report) in cuda_build.build_all(KERNELS).items():
        log(f"built {lib.name}")
        for line in report.splitlines():
            if ("Compiling entry" in line or "Used" in line or "spill" in line
                    or line.startswith("nvcc ")):
                log("  " + line.strip())
        regs.update(ptxas_registers(report))
        spills.update(ptxas_spills(report))
    log(f"build: {time.perf_counter() - t0:.2f} s")
    lines = check_tile_registers(wa, regs)
    if regs and len(lines) < 10:
        raise AssertionError(f"found {len(lines)} tile kernels in the "
                             "ptxas report, expected 10")
    for line in lines:
        log(f"registers {line}")
    large = large_tile_registers(wa, regs, spills)
    if regs and len(large) != 40:
        raise AssertionError(f"found {len(large)} large-window tile kernels "
                             "in the ptxas report, expected 40")
    for line in large + fused_block_registers(wa, regs, spills):
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
    attn_mask; its backward gives dq, dk, dv, not dbias) at the shapes
    with calls on a timed step (others are checked, not timed). Returns
    two {"fwd", "bwd"} Tallies: per Swin-T W=7 default step (SHAPES) and
    per Swin-B W=14 packed-route step (WA_SHAPES_B14: N=196 on the
    large-window tile)."""
    F = torch.nn.functional
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = wa._lib()
    # Every window the tiles take: N <= 64 on the small tiles, 64 < N <=
    # 256 on the large one, whose plan must fit where its shape rule
    # (large_tile_fits) admits the shape.
    for N in range(1, wa._LARGE_MAX_N + 1):
        for hd in range(1, 65):
            for itemsize in (2, 4):
                for backward in (False, True):
                    count = (lib.esvit_window_attention_bwd_smem_bytes
                             if backward else
                             lib.esvit_window_attention_tile_smem_bytes)
                    top = (wa._LARGE_MAX_WARPS if N > wa._SMALL_MAX_N
                           else 8)
                    for warps in range(1, top + 1):
                        want = count(N, hd, itemsize, warps)
                        if want != wa.tile_smem_bytes(N, hd, itemsize, warps,
                                                      backward):
                            raise AssertionError(
                                f"tile_smem_bytes({N}, {hd}, {itemsize}, "
                                f"{warps}, {backward}) is not the kernel's "
                                f"{want}")
                    if N > wa._SMALL_MAX_N and not wa.large_tile_fits(
                            N, hd, backward):
                        continue
                    plan = wa.tile_plan(64, N, hd, 3, 1, itemsize,
                                        backward=backward)
                    if plan.smem > limit:
                        raise AssertionError(
                            f"tile plan {plan} at N={N} hd={hd} (backward "
                            f"{backward}) needs more than {limit} bytes")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tally = {"fwd": Tally(library=True), "bwd": Tally(library=True)}
    tally_b14 = {"fwd": Tally(library=True), "bwd": Tally(library=True)}
    # (shape, its cell, calls per step of the W=7 cell, of the Swin-B one)
    cases = ([(s[:7] + (49,), tally, s[7:9], (0, 0)) for s in SHAPES]
             + [(s[:7] + s[9:], tally_b14, (0, 0), s[7:9])
                for s in WA_SHAPES_B14])
    for (label, B_, C, nH, H, shifted, dt, N), own, calls, calls_b14 in cases:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        ws = math.isqrt(N)
        region = (torch.as_tensor(wops.window_region_ids(H, H, ws, ws // 2),
                                  device=dev) if shifted else None)
        q, k, v, do = (torch.randn(B_ * N, C, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        bias = 0.3 * torch.randn(nH, N, N, generator=gen, device=dev)
        scale = (C // nH) ** -0.5

        def grads(fn):
            ts = [t.clone().requires_grad_() for t in (q, k, v, bias)]
            out = fn(*ts, region, N, nH, scale)
            g = torch.autograd.grad(out, ts, do)
            return [out.detach()] + list(g)

        got = grads(wa._WindowAttention.apply)
        again = grads(wa._WindowAttention.apply)
        ref = grads(wa.window_attention_plain)
        errs = []
        for name, a, a2, b in zip(("out", "dq", "dk", "dv", "dbias"), got,
                                  again, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: kernel {name} not finite")
            if not torch.equal(a, a2):
                raise AssertionError(f"{label}: {name} differs between two "
                                     "runs")
            s = max(b.float().abs().max().item(), 1e-6)
            errs.append((a.float() - b.float()).abs().max().item() / s)
        if max(errs) > TOL[dt]:
            raise AssertionError(f"{label}: errors {errs} above {TOL[dt]}")
        own["fwd"].err = max(own["fwd"].err, errs[0])
        own["bwd"].err = max(own["bwd"].err, *errs[1:])
        log(f"kernel-vs-plain {label:24s} B_={B_:5d} N={N:3d} C={C:4d} "
            f"nH={nH:2d} {dt}: max err out {errs[0]:.2e} dq {errs[1]:.2e} "
            f"dk {errs[2]:.2e} dv {errs[3]:.2e} dbias {errs[4]:.2e} "
            f"(tol {TOL[dt]:.0e}); all five bit-identical on repeat")
        if not any(calls + calls_b14):
            continue        # checked; no timed step launches this shape

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
        for cell, (n_fwd, n_bwd) in ((tally, calls), (tally_b14, calls_b14)):
            cell["fwd"].add(n_fwd, t_fwd, p_fwd, *work["fwd"], l_fwd)
            cell["bwd"].add(n_bwd, t_bwd, p_bwd, *work["bwd"], l_bwd)
        rate = FP32_FLOP_PER_S if dt == "fp32" else BF16_FLOP_PER_S
        bound = {k: max(b / HBM_BYTES_PER_S, f / rate) * 1e3
                 for k, (b, f) in work.items()}
        log(f"  time {label:24s} fwd kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms sdpa {l_fwd:.4f} ms bound {bound['fwd']:.4f} ms "
            f"| bwd kernel {t_bwd:.4f} ms plain {p_bwd:.4f} ms sdpa "
            f"{l_bwd:.4f} ms bound {bound['bwd']:.4f} ms")
    rec = {k: t.record() for k, t in tally_b14.items()}
    log(f"window attention per Swin-B W=14 packed-route step: fwd kernel "
        f"{rec['fwd']['ms']:.4f} ms plain {rec['fwd']['plain_ms']:.4f} ms sdpa "
        f"{rec['fwd']['library_ms']:.4f} ms bound {rec['fwd']['bound_ms']:.4f}"
        f" ms | bwd kernel {rec['bwd']['ms']:.4f} ms plain "
        f"{rec['bwd']['plain_ms']:.4f} ms sdpa {rec['bwd']['library_ms']:.4f}"
        f" ms bound {rec['bwd']['bound_ms']:.4f} ms")
    return tally, tally_b14


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
    block shapes, Swin-T's at W=7 and W=14 and Swin-B's at W=14 (and C=512
    at W=7), timed where a timed step launches the shape. Returns three
    {"fwd", "bwd"} Tallies, the Swin-T W=7 step's, the Swin-T W=14 step's
    and the Swin-B W=14 step's: per-kernel max error and the per-step
    kernel/plain milliseconds; logs the C=512 blocks' share of the Swin-B
    step."""
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
    cells = {name: {"fwd": Tally(), "bwd": Tally()}
             for name in ("W=7 default", "W=14", "Swin-B W=14",
                          "Swin-B W=14 C=512")}
    tally, tally14, tally_b14, tally_b512 = cells.values()
    split_step = {"fwd": {}, "bwd": {}}
    cublas_step = dict.fromkeys(cells, 0.0)
    # (shape, the cell its 11th entry counts for)
    cases = ([(s, "W=14") for s in FUSED_SHAPES]
             + [(s, "Swin-B W=14") for s in FUSED_SHAPES_B14])
    for (label, B, C, nH, H, shifted, dt, n_fwd, n_bwd, ws, *extra), other \
            in cases:
        e_fwd, e_bwd = extra[0] if extra else (0, 0)
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
        # the cells whose error this shape counts in: a Swin-T shape's W=7
        # or W=14 cell by its window, and W=14's where its 11th entry
        # counts calls there; a Swin-B shape's cell, and its C=512 part
        if other == "W=14":
            own = [tally14 if ws == 14 else tally]
            if extra and ws != 14:
                own.append(tally14)
        else:
            own = [tally_b14] + ([tally_b512] if C == 512 else [])
        for cell in own:
            cell["fwd"].err = max(cell["fwd"].err, errs["out"])
            cell["bwd"].err = max(cell["bwd"].err,
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
            log(f"fused-stages {label:24s} {dt} {what}: " + ", ".join(
                f"{n} {e:.2e}" for n, e in stages.items())
                + f" (tol {TOL[dt]:.0e})")
        top = sorted(((n if n == "out" else f"d{n}", e)
                      for n, e in errs.items()), key=lambda kv: -kv[1])[:3]
        log(f"fused-vs-plain {label:24s} B={B:3d} W={ws} N={N} nW={nW:2d} "
            f"C={C:3d} nH={nH:2d} {dt}: max err out {errs['out']:.2e} dx "
            f"{errs['x']:.2e}, largest {', '.join(f'{n} {e:.2e}' for n, e in top)}"
            f" (tol {TOL[dt]:.0e}); all 19 results bit-identical on repeat")
        if not (n_fwd or n_bwd or e_fwd or e_bwd):
            continue        # checked; no timed step launches this shape

        with torch.no_grad():
            t_fwd = _median_ms(torch, lambda: fb._fwd(
                x, params, k1, k2, region, pad, geo))
            p_fwd = _median_ms(torch, lambda: fb.fused_swin_block_plain(
                x, params, k1, k2, **kw))
            t_cublas = _cublas_ms(torch, x, params)
        t_bwd = _median_ms(torch, lambda: fb._bwd(
            x, params, k1, k2, region, pad, do, geo))
        # the split over SPLIT_REPS calls (its total is the events'
        # median's cross-check, not the number the tallies take)
        splits = {"fwd": kernel_split(torch, lambda: fb._fwd(
                      x, params, k1, k2, region, pad, geo), SPLIT_REPS),
                  "bwd": kernel_split(torch, lambda: fb._bwd(
                      x, params, k1, k2, region, pad, do, geo), SPLIT_REPS)}
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
        counted = [("W=7 default", (n_fwd, n_bwd)), (other, (e_fwd, e_bwd))]
        if other != "W=14" and C == 512:
            counted.append(("Swin-B W=14 C=512", (e_fwd, e_bwd)))
        for name, (c_fwd, c_bwd) in counted:
            cells[name]["fwd"].add(c_fwd, t_fwd, p_fwd,
                                   2 * rows + pbytes + tables, flops)
            cells[name]["bwd"].add(c_bwd, t_bwd, p_bwd,
                                   3 * rows + 2 * pbytes + tables, 3 * flops)
            cublas_step[name] += c_fwd * t_cublas
        bound = {k: max(b / HBM_BYTES_PER_S, f / BF16_FLOP_PER_S
                        if dt == "bf16" else f / FP32_FLOP_PER_S) * 1e3
                 for k, (b, f) in (("fwd", (2 * rows + pbytes + tables, flops)),
                                   ("bwd", (3 * rows + 2 * pbytes + tables,
                                            3 * flops)))}
        log(f"  time {label:24s} fwd kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms bound {bound['fwd']:.4f} ms cublas four products "
            f"{t_cublas:.4f} ms | bwd kernel {t_bwd:.4f} ms plain "
            f"{p_bwd:.4f} ms bound {bound['bwd']:.4f} ms")
        for what in ("fwd", "bwd"):
            log(f"  split {label:24s} {what} "
                f"{sum(splits[what].values()):.4f} ms: "
                f"{_split_line(splits[what])}")
    for what in ("fwd", "bwd"):
        log(f"fused {what} split per default step (ms, torch.profiler): "
            + json.dumps({k: round(v, 4) for k, v in sorted(
                split_step[what].items(), key=lambda kv: -kv[1]) if v}))
    for name, cell in cells.items():
        rec = {k: t.record() for k, t in cell.items()}
        log(f"fused per {name} step: fwd kernel {rec['fwd']['ms']:.4f} ms "
            f"plain {rec['fwd']['plain_ms']:.4f} ms bound "
            f"{rec['fwd']['bound_ms']:.4f} ms ({rec['fwd']['bound_by']}); bwd "
            f"kernel {rec['bwd']['ms']:.4f} ms plain {rec['bwd']['plain_ms']:.4f}"
            f" ms bound {rec['bwd']['bound_ms']:.4f} ms "
            f"({rec['bwd']['bound_by']}); max err fwd "
            f"{rec['fwd']['max_abs_err']:.2e} bwd {rec['bwd']['max_abs_err']:.2e}"
            f"; beside cublas four products {cublas_step[name]:.4f} ms "
            "(timed only)")
    return tally, tally14, tally_b14


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


# The fp32 large-tile backward with the last key column's bias lifted by
# LIFT at N = LIFT_N (tests/test_torch_cuda_kernels.py holds lifts 8-24 at
# N 145-256): p at that column tends to 1, so its ds is a difference of
# nearly equal fp32 numbers. Each gradient against autograd through
# window_attention_plain in float64 on the kernel's own inputs, within
# max(FP64_GATE, 2 x the fp32 plain version's own error) of the fp64
# gradient's max-abs.
LIFT, LIFT_N, FP64_GATE = 16.0, 196, 2e-5


def _lift_check(torch, wa, label, runs, args, card):
    """Holds the first of two runs' (dq, dk, dv, dbias) to the fp64 gate
    and the second to it bit for bit; logs both errors."""
    for name, a, b in zip(wa.GRAD_NAMES, *runs):
        if not torch.isfinite(a).all():
            raise AssertionError(f"lifted bias {label}: {name} not finite")
        if not torch.equal(a, b):
            raise AssertionError(f"lifted bias {label}: {name} differs "
                                 "between two runs")
    kernel = wa.fp64_grad_errors(runs[0], *args)
    plain = wa.fp64_grad_errors(wa.plain_grads(*args), *args)
    for name in wa.GRAD_NAMES:
        gate = max(FP64_GATE, 2 * plain[name])
        if kernel[name] > gate:
            raise AssertionError(f"lifted bias {label}: {name} "
                                 f"{kernel[name]:.3e} against fp64, gate "
                                 f"{gate:.3e}")
    log(f"lifted bias {label} fp32 N={LIFT_N} lift {LIFT:g} vs fp64: "
        + ", ".join(f"{n} kernel {kernel[n]:.3e} plain {plain[n]:.3e}"
                    for n in wa.GRAD_NAMES)
        + f" (gate max({FP64_GATE:g}, 2 x plain)); bit-identical on repeat "
        f"[{card}]")


def phase_lifted_bias(torch, fb, wa, wops, card):
    """Both fp32 backward kernels of the large-window tile at N=196 with
    the last key column's bias lifted by LIFT, against fp64: the packed
    pair (row 4) at Swin-B's W=14 stage-1 width over 64 windows, and the
    block-fused backward's attention half (row 2's A2) at Swin-T's W=14
    stage 2 (16 images of one window); unshifted, so no -100 mask lowers
    the lifted column."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    B_, C, nH = 64, 256, 8
    q, k, v, do = (torch.randn(B_ * LIFT_N, C, generator=gen, device=dev)
                   for _ in range(4))
    bias = 0.3 * torch.randn(nH, LIFT_N, LIFT_N, generator=gen, device=dev)
    bias[:, :, -1] += LIFT
    args = (q, k, v, do, bias, None, LIFT_N, nH, (C // nH) ** -0.5)
    runs = [wa._bwd(q, k, v, bias, None, do, LIFT_N, nH, args[-1])
            for _ in range(2)]
    _lift_check(torch, wa, "packed pair (row 4)", runs, args, card)
    x, params, keep1, keep2, region, pad, geometry, do = _fused_case(
        torch, wops, 16, 384, 12, 14, False, torch.float32, gen, ws=14)
    N, nH, nW, scale, eps = geometry
    params["bias"][:, :, -1] += LIFT
    kw = dict(N=N, nH=nH, nW=nW, scale=scale, region=region, pad=pad,
              eps=eps)
    io = [fb.attention_bwd_io(x, params, keep1, keep2, do, **kw)
          for _ in range(2)]
    args = (*io[0][0], params["bias"], region, N, nH, scale)
    _lift_check(torch, wa, "block-fused A2 (row 2)", [out for _, out in io],
                args, card)


def phase_pallas_window_attention(torch, pwa, wops):
    """Row 7 vs its plain version at the eval slice's and the train
    route's shapes, W=7's and W=14's, and the library call
    (scaled_dot_product_attention, the dense bias as its float
    attn_mask). Returns the Tallies of the forward, summed per eval
    forward batch (fp32 peak for the bound), of W=7 and of W=14."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tally = Tally(library=True, flop_rate=FP32_FLOP_PER_S)
    tally14 = Tally(library=True, flop_rate=FP32_FLOP_PER_S)
    for label, B_, C, nH, H, shifted, dt, calls, *w14 in PWA_SHAPES:
        ws, calls14 = w14 if w14 else (7, 0)
        N = ws * ws
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        hd, scale = C // nH, (C // nH) ** -0.5
        qkv = torch.randn(B_, N, 3 * C, generator=gen, device=dev).to(dtype)
        do = torch.randn(B_, N, C, generator=gen, device=dev).to(dtype)
        bias = 0.3 * torch.randn(1, nH, N, N, generator=gen, device=dev)
        if shifted:
            mask = torch.as_tensor(
                wops.shifted_window_mask(H, H, ws, ws // 2), device=dev)
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
        for cell, n in ((tally, ws == 7), (tally14, ws == 14 or calls14)):
            if n:
                cell.err = max(cell.err, err)
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
        tally14.add(calls14, t_fwd, p_fwd, nbytes, flops, l_fwd)
        rate = FP32_FLOP_PER_S if dt == "fp32" else BF16_FLOP_PER_S
        bound = max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3
        log(f"pallas-vs-plain {label:16s} B_={B_:5d} N={N:3d} C={C:3d} nH={nH:2d} "
            f"nWm={nWm:2d} {dt}: max err out {err:.2e} (tol {TOL[dt]:.0e}); "
            f"out bit-identical on repeat; dqkv, dbias equal to plain; sdpa "
            f"out vs plain {lib_err:.2e}")
        log(f"  time {label:16s} {dt} kernel {t_fwd:.4f} ms plain "
            f"{p_fwd:.4f} ms sdpa {l_fwd:.4f} ms bound {bound:.4f} ms "
            f"(calls per eval batch {calls}, per W=14 eval batch {calls14})")
    for name, cell in (("W=7", tally), ("W=14", tally14)):
        rec = cell.record()
        log(f"pallas per {name} eval batch: kernel {rec['ms']:.4f} ms plain "
            f"{rec['plain_ms']:.4f} ms sdpa {rec['library_ms']:.4f} ms bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); max err "
            f"{rec['max_abs_err']:.2e}")
    return tally, tally14


def phase_forward_parity(torch, C, fb, wa, pwa, window_size=7):
    """The Swin-T backbone (at ``window_size``) on the default fused
    route, on the window-attention route, on the qkv-layout route and on
    the plain route, fp32, same weights, 2 images at 224 and 96 px:
    relative error <= 1e-4 to the plain one, for forward_features and for
    forward_return_n_last_blocks(x, 4) (the probe's features, which every
    route computes in its classic block loop); each kernel's launches
    equal to the model-derived count. At W=14 the window-attention route
    runs stages 0-2 on the packed pair's large-window tile (N=196) and
    stage 3 (N=49) on its small tiles."""
    from esvit_tpu_torch.models.swin import SwinTransformer

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def swin(**kw):
        return C.swin_tiny(window_size=window_size, drop_path_rate=0.0, **kw)

    fused = SwinTransformer(swin(), generator=gen).to(dev)
    routes = {
        "fused": fused,
        "window-attention": SwinTransformer(swin(
            fused_block_stages=())).to(dev),
        "qkv-layout": SwinTransformer(swin(
            attention_impl="pallas", fused_block_stages=())).to(dev),
        "plain": SwinTransformer(swin(
            attention_impl="xla", fused_block_stages=())).to(dev),
    }
    for model in routes.values():
        model.load_state_dict(fused.state_dict())
    kernel_routes = ("fused", "window-attention", "qkv-layout")

    tag = f"swin-t W={window_size}"

    def check(what, a, b):
        err = ((a - b).abs().max() / b.abs().max()).item()
        if not (torch.isfinite(a).all() and err <= 1e-4):
            raise AssertionError(f"{tag} {what}: {err:.2e} from plain")
        log(f"{tag} {what} fp32: rel err vs plain {err:.2e} (tol 1e-4), "
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
            raise AssertionError(f"{tag} {what} {size}px: launches {got}, "
                                 f"model-derived {want}")
        for name in kernel_routes:
            check(f"{what} {size}px: {name} route", out[name], out["plain"])
        log(f"{tag} {what} {size}px: forward launches {got}")

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


@functools.lru_cache(maxsize=8)
def _probe(model_cfg):
    """The backbone of a model config, built once: the launch counts below
    read its routes, which depend on shapes alone, never its weights."""
    from esvit_tpu_torch.models.registry import build_backbone

    return build_backbone(model_cfg)


def _derived_launches(cfg, steps, modes=None):
    """Per-kernel launches of `steps` train steps, from the model's routing
    (its ``<kernel>_calls``; 0 for a kernel the backbone never calls): the
    teacher runs the 224 crops forward (deterministic), the student all
    crops forward and backward (ViL's route under attention dropout
    depends on which, and at each step on the nets' neighbour modes,
    ``modes`` = train()'s per-step (mode, teacher_mode), all (0, 0) when
    not given). Under Swin's remat='block' the student's window
    attention forwards run again in the backward's recompute; the fused
    routes are not rematerialised. With frozen_layers the backward stops
    before the leading stages that hold no trainable parameter
    (SwinTransformer.frozen_stages)."""
    import inspect

    from esvit_tpu_torch.train.optim import freeze_mask_by_prefix

    probe = _probe(cfg.model)
    g, l = cfg.crops.global_size, cfg.crops.local_size
    remat = getattr(cfg.model, "remat", "none") == "block"
    skip = 0
    if cfg.optim.frozen_layers and hasattr(probe, "frozen_stages"):
        skip = probe.frozen_stages(freeze_mask_by_prefix(
            dict(probe.named_parameters()), cfg.optim.frozen_layers,
            cfg.model.name))
    sizes = [g] + ([l] if cfg.crops.local_crops_number else [])
    modes = modes or [(0, 0)] * steps
    if len(modes) != steps:
        raise AssertionError(f"{len(modes)} steps' modes for {steps} steps")
    want = {}
    for name, (_, kinds) in KERNELS.items():
        fn = getattr(probe, f"{name}_calls", lambda size: 0)
        params = inspect.signature(fn).parameters

        def calls(size, det, first=0, mode=0, fn=fn, params=params):
            kw = {"deterministic": det} if "deterministic" in params else {}
            if "from_stage" in params:
                kw["from_stage"] = first
            if "mode" in params:
                kw["mode"] = mode
            return fn(size, **kw)
        want[name] = {k: 0 for k in kinds}
        for mode, t_mode in modes:
            student = sum(calls(s, False, mode=mode) for s in sizes)
            again = student if remat and name != "fused_block" else 0
            per_step = {"fwd": calls(g, True, mode=t_mode) + student + again,
                        "bwd": sum(calls(s, False, skip, mode)
                                   for s in sizes)}
            for k in kinds:
                want[name][k] += per_step[k]
    return want


def _slice(torch, cfg, steps, counters, label, card, check_state,
           check_more=None, keep_state=False, write_checkpoint=False,
           **train_kw):
    """train() for `steps` steps (on ``train_kw``'s data, else synthetic
    crops on the card) with every launch count set to 0 just before and
    read just after: finite losses, the launch counts of every kernel equal
    to the model's, and (check_state) student, teacher and both centers
    changed, and ``check_more(state, init)`` where given. Returns the
    counts and train()'s per-step records, and with ``keep_state`` the
    final TrainState (a route stepper goes on from it). The peak memory it
    prints is the run's: above what was allocated when it started.

    train() saves checkpoint.pth at each epoch's end. The slice checks
    that it asked for the save after its last step, and writes the file
    only with ``write_checkpoint``: a full-width write takes ~2.4 s, no
    other slice reads it, and the CLI runs of phases 11-15 and phase 19's
    runs write checkpoints and check what they read back."""
    import gc

    from esvit_tpu_torch.train import train as train_lib

    init = _initial_weights(torch, cfg) if check_state else None
    for launches in counters.values():
        for k in launches:
            launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    saves, save = [], train_lib.save_checkpoint
    if not write_checkpoint:
        train_lib.save_checkpoint = (
            lambda ckpt, state, mesh, **kw: saves.append(state.step))
    try:
        # checkpoint.pth only: no run here reads a numbered copy (the
        # entry phase's CLI runs check those)
        state, history = train_lib.train(
            cfg.replace(save_every_epochs=0), max_steps=steps,
            device="cuda", resume=False, **train_kw)
    finally:
        train_lib.save_checkpoint = save
    torch.cuda.synchronize()
    got = {name: dict(launches) for name, launches in counters.items()}
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    if not write_checkpoint:
        if not saves or saves[-1] != steps:
            raise AssertionError(f"{label}: saves asked for at steps "
                                 f"{saves}, want the last at {steps}")
        log(f"slice {label}: checkpoint.pth asked for at step {steps}, "
            f"not written")
    want = _derived_launches(cfg, steps, [h["modes"] for h in history])
    ms = statistics.mean(h["seconds"] for h in history[1:]) * 1e3
    B = cfg.optim.batch_size_per_device
    ips = cfg.crops.ncrops * B / (ms / 1e3)
    log(f"slice {label}: losses {losses}")
    log(f"slice {label}: launches {got}")
    log(f"slice {label}: B={B} 2x224+8x96 DDINO out_dim 65536 "
        f"bf16: {ms:.1f} ms/step, {ips:.1f} img/s over steps 2-{steps}, "
        f"peak device memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB"
        f"{_beside()} [{card}]")
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
    if check_more is not None:
        check_more(state, init)
    if keep_state:
        return got, history, state
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return got, history


def phase_slice(torch, C, counters, card, out_dir):
    """Swin-T on the default (fused) route for STEPS steps, then on the
    window-attention route for 3 and on the qkv-layout route for 3 (its
    backward is autograd of the plain version: forward launches only).
    Returns the default route's launches and ms/step, and the first two
    routes' {name: (config, final TrainState)} for the route order."""
    cfg = C.swin_tiny_multicrop(BATCH, output_dir=out_dir)
    wa_cfg = cfg.replace(model=C.swin_tiny(fused_block_stages=()))
    got, history, state = _slice(torch, cfg, STEPS, counters,
                                 "Swin-T fused route", card, True,
                                 keep_state=True)
    *_, wa_state = _slice(torch, wa_cfg, 3, counters,
                          "Swin-T window-attention route", card, False,
                          keep_state=True)
    _slice(torch, cfg.replace(model=C.swin_tiny(attention_impl="pallas",
                                                fused_block_stages=())), 3,
           counters, "Swin-T qkv-layout route", card, False)
    return (got, statistics.mean(h["seconds"] for h in history[1:]) * 1e3,
            {"default": (cfg, state),
             "fused_block_stages=()": (wa_cfg, wa_state)})


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


def phase_route_order(torch, card, routes):
    """The Swin-T default route and fused_block_stages=() in turns,
    ROUTE_ROUNDS rounds of ROUTE_STEPS steps each (the second route first
    in odd rounds), in this process, each route on one trainer going on
    from its train() run's state (``routes``: {name: (config, state)}):
    each route's median ms per step over steps 2..ROUTE_STEPS of its
    rounds, the spread, and which is faster."""
    import gc

    steppers = {name: _route_stepper(torch, cfg, state)
                for name, (cfg, state) in routes.items()}
    routes.clear()          # the steppers hold the states now
    ms = {name: [] for name in steppers}
    for rnd in range(ROUTE_ROUNDS):
        for name in list(steppers)[::1 if rnd % 2 == 0 else -1]:
            steps = [steppers[name]() for _ in range(ROUTE_STEPS)][1:]
            ms[name] += steps
            log(f"route order round {rnd + 1} {name}: "
                + ", ".join(f"{t:.1f}" for t in steps) + " ms/step")
    del steppers
    gc.collect()
    torch.cuda.empty_cache()
    for name, steps in ms.items():
        log(f"route order {name}: median {statistics.median(steps):.1f} "
            f"ms/step, spread {min(steps):.1f}-{max(steps):.1f} over "
            f"{len(steps)} steps of {ROUTE_ROUNDS} rounds [{card}]")
    faster = min(ms, key=lambda n: statistics.median(ms[n]))
    log(f"route order: {faster} is faster by the median")


# Phase 17, Swin-T at W=14, the configuration EsViT publishes as its best
# Swin (BASELINE.md): steps per run, the alternating rounds after the two
# checked runs, and the k-NN CLI's noise images (two classes).
W14 = 14
W14_STEPS, W14_ROUNDS = 3, 2
# Phase 18, Swin-B at W=14 (EsViT's best published model; the root
# bench.py's swin_base_w14 preset at the reference recipe's per-card batch,
# 4 nodes x 16 GPUs x 8): the batch, steps per run, and the alternating
# rounds after the checked runs.
B14_BATCH = 8
B14_STEPS, B14_ROUNDS = 3, 2
W14_KNN_TRAIN, W14_KNN_VAL, W14_KNN_SIZE, W14_KNN_BATCH = 16, 8, 128, 16


def _fused_n_split(cfg, by="N"):
    """{"fwd", "bwd"}: {N: launches} of the block-fused kernel in one
    train step of cfg, by window size (``by="C"``: by the stage's width),
    from the model's stage routes (a fused stage's windows are ws^2
    tokens, a fused sub-window stage's the augmented H*W + 1); the teacher
    runs the global crops forward, the student every crop forward and
    backward."""
    probe = _probe(cfg.model)
    out = {"fwd": {}, "bwd": {}}
    sizes = [(cfg.crops.global_size, 2)]
    if cfg.crops.local_crops_number:
        sizes.append((cfg.crops.local_size, 1))
    for size, forwards in sizes:
        for stage, L, route in probe._stage_routes(size):
            if route not in ("fused", "fused_subwindow"):
                continue
            N = stage.window_size ** 2 if route == "fused" else L + 1
            key = N if by == "N" else stage.dim
            for kind, times in (("fwd", forwards), ("bwd", 1)):
                out[kind][key] = (out[kind].get(key, 0)
                                  + times * len(stage.blocks))
    return out


def _packed_n_split(cfg):
    """{"fwd", "bwd"}: {N: launches} of the packed window-attention pair
    (rows 3-4) in one train step of cfg, by window size: the stages that
    the model's own count (``_attention_calls``) takes, per image size,
    with the teacher and student as in :func:`_fused_n_split`."""
    probe = _probe(cfg.model)
    out = {"fwd": {}, "bwd": {}}
    sizes = [(cfg.crops.global_size, 2)]
    if cfg.crops.local_crops_number:
        sizes.append((cfg.crops.local_size, 1))
    for size, forwards in sizes:
        for i, (stage, L, _) in enumerate(probe._stage_routes(size)):
            calls = (probe.window_attention_calls(size, from_stage=i)
                     - probe.window_attention_calls(size, from_stage=i + 1))
            N = stage.window_size ** 2
            for kind, times in (("fwd", forwards), ("bwd", 1)):
                if calls:
                    out[kind][N] = out[kind].get(N, 0) + times * calls
    return out


def _route_stepper(torch, cfg, state):
    """One EsViTTrainer of cfg on the card, going on from ``state`` (a
    train() run's, on the card) with one synthetic batch: a function that
    takes one train step and returns its ms on the host clock, to the
    loss's fetch (which must be finite)."""
    from esvit_tpu_torch.data.loader import synthetic_batches
    from esvit_tpu_torch.train.step import EsViTTrainer

    dev = torch.device("cuda")
    B = cfg.optim.batch_size_per_device
    trainer = EsViTTrainer(cfg, total_batch_size=B, device=dev)
    holder = [state]
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = next(iter(synthetic_batches(cfg.crops, B, steps=1,
                                        device=dev)))

    def step():
        t0 = time.perf_counter()
        holder[0], metrics = trainer.train_step(holder[0], batch, gen)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"step loss {loss}")
        return (time.perf_counter() - t0) * 1e3
    return step


def _step_groups(torch, step):
    """Device ms of one train step by kernel group (utils/profile.py's
    groups), from kernel_split over 1 step; the step's esvit/* spans
    (their GPU-timeline lengths, not kernels) left out, as
    utils/profile.py leaves them."""
    from esvit_tpu_torch.utils.profile import _kernel_group

    groups = {}
    for name, ms in kernel_split(torch, step, reps=1).items():
        if name.startswith("esvit/"):
            continue
        group = _kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def _w14_knn(C, card, root):
    """The k-NN CLI at --window_size 14 on seeded noise PNGs, fp32, on the
    card and on the CPU (subprocesses through ENTRY_RUN, at once): the
    card's launches as derived from the model (none on the CPU), and the
    card's dumped features within 1e-4 of the CPU's."""
    import numpy as np
    from PIL import Image

    from esvit_tpu_torch.models.registry import build_backbone

    rng = np.random.default_rng(0)
    dirs = {}
    for split, n in (("train", W14_KNN_TRAIN), ("val", W14_KNN_VAL)):
        dirs[split] = os.path.join(root, split)
        for i in range(n):
            d = os.path.join(dirs[split], f"class{i % 2}")
            os.makedirs(d, exist_ok=True)
            pixels = rng.integers(0, 256, (W14_KNN_SIZE, W14_KNN_SIZE, 3),
                                  dtype=np.uint8)
            Image.fromarray(pixels).save(os.path.join(d, f"{i:03d}.png"))
    probe = build_backbone(C.swin_tiny(window_size=W14))
    batches = (-(-W14_KNN_TRAIN // W14_KNN_BATCH)
               + -(-W14_KNN_VAL // W14_KNN_BATCH))
    feats = {}
    devices = ("cuda", "cpu")
    done = _entry_runs([
        (f"w14 k-NN --device {device}", "esvit_tpu_torch.evals.knn",
         ["--arch", "swin_tiny", "--window_size", str(W14),
          "--train_path", dirs["train"], "--val_path", dirs["val"],
          "--batch_size", str(W14_KNN_BATCH), "--nb_knn", "5",
          "--dump_features", os.path.join(root, f"features_{device}"),
          "--output_dir", os.path.join(root, f"out_{device}"), "--device",
          device], None, 0) for device in devices])
    for device, (_, rec) in zip(devices, done):
        dump = os.path.join(root, f"features_{device}")
        want = {name: {k: 0 for k in kinds}
                for name, (_, kinds) in KERNELS.items()}
        if device == "cuda":
            want["fused_block"]["fwd"] = probe.fused_block_calls(224) * batches
            want["window_attention"]["fwd"] = (
                probe.window_attention_calls(224) * batches)
        _entry_launches(f"w14 k-NN --device {device}", rec["launches"], want)
        feats[device] = [np.load(os.path.join(dump, f"{n}feat.npy"))
                         for n in ("train", "test")]
    err = max(float(np.abs(a - b).max())
              for a, b in zip(feats["cuda"], feats["cpu"]))
    if not (err <= 1e-4 and all(np.isfinite(f).all() for f in feats["cuda"])):
        raise AssertionError(f"w14 k-NN: card features {err:.2e} from the "
                             "CPU's (tol 1e-4)")
    log(f"w14 k-NN CLI fp32: {W14_KNN_TRAIN} + {W14_KNN_VAL} noise images, "
        f"card features vs CPU max abs {err:.2e} (tol 1e-4) [{card}]")


def _side_by_side(what, ms, card):
    """One line of the routes' median ms/step and spreads, the kernel
    route first, and which route is faster by the median."""
    med = {name: statistics.median(steps) for name, steps in ms.items()}
    cells = " | ".join(f"{name} {med[name]:.1f} ({min(s):.1f}-{max(s):.1f})"
                       for name, s in ms.items())
    return (f"{what} side by side, median ms/step (spread): {cells}; "
            f"faster: {min(med, key=med.get)} [{card}]")


def phase_swin_w14(torch, C, counters, card, out_dir):
    """Swin-T at W=14 (swin_tiny_multicrop's recipe with window_size=14:
    B=32, 2x224 + 8x96, 65536-wide heads, DDINO, bf16, seed 0, synthetic
    crops on the card). W14_STEPS steps on the kernel route (the default
    fused stages: the block-fused pair on the large-window tile, N=196 /
    145 / 37) with the slice's checks (finite losses, state moved,
    launches as derived: 30 forward / 20 backward block-fused launches a
    step, split by N), then on the plain route (fused_block_stages=(),
    attention_impl='xla': no kernel), both through train() (the slices
    print each run's ms/step and peak memory); then W14_ROUNDS
    alternating rounds of W14_STEPS steps on one trainer per route, going
    on from its train() run's state: each route's median ms/step over
    steps 2..W14_STEPS of its
    rounds and the spread, and its device time by kernel group
    (torch.profiler, 1 step). Then the fp32 eval forward on the
    qkv-layout route (attention_impl='pallas', no fused stages, batch
    EVAL_BATCH at 224 px): row 7's launches as derived, finite features,
    the ms per batch; then the k-NN CLI at --window_size 14, card against
    CPU. Returns the W=14 kernels' launches: the block-fused pair's from
    the kernel-route steps, row 7's from the eval forward."""
    import gc

    from esvit_tpu_torch.models.registry import build_backbone

    base = C.swin_tiny_multicrop(BATCH, output_dir=out_dir)
    routes = {"kernel": base.replace(model=C.swin_tiny(window_size=W14)),
              "plain": base.replace(model=C.swin_tiny(
                  window_size=W14, fused_block_stages=(),
                  attention_impl="xla"))}
    per_step = _derived_launches(routes["kernel"], 1)
    split = _fused_n_split(routes["kernel"])
    log(f"w14 kernel route, derived launches per step: {per_step}; "
        f"block-fused launches by N: {split}")
    if (per_step["fused_block"] != {"fwd": 30, "bwd": 20}
            or sum(split["fwd"].values()) != 30
            or sum(split["bwd"].values()) != 20):
        raise AssertionError(f"w14: derived block-fused launches "
                             f"{per_step['fused_block']}, by N {split}")
    got, _, state = _slice(torch, routes["kernel"], W14_STEPS, counters,
                           "Swin-T W=14 kernel route", card, True,
                           keep_state=True)
    *_, plain_state = _slice(torch, routes["plain"], W14_STEPS, counters,
                             "Swin-T W=14 plain route", card, False,
                             keep_state=True)
    steppers = {"kernel": _route_stepper(torch, routes["kernel"], state),
                "plain": _route_stepper(torch, routes["plain"], plain_state)}
    del state, plain_state
    ms = {name: [] for name in routes}
    for rnd in range(W14_ROUNDS):
        for name in (("plain", "kernel") if rnd % 2 == 0
                     else ("kernel", "plain")):
            steps = [steppers[name]() for _ in range(W14_STEPS)][1:]
            ms[name] += steps
            log(f"w14 round {rnd + 1} {name} route: "
                + ", ".join(f"{t:.1f}" for t in steps) + " ms/step")
    for name, steps in ms.items():
        log(f"w14 {name} route: median {statistics.median(steps):.1f} "
            f"ms/step, spread {min(steps):.1f}-{max(steps):.1f} over "
            f"{len(steps)} steps of {W14_ROUNDS} alternating rounds [{card}]")
    log(_side_by_side("w14 routes", ms, card))
    for name, step in steppers.items():
        log(f"w14 {name} route, device ms per step by kernel group "
            f"(torch.profiler): " + json.dumps(
                {g: round(v, 3) for g, v in _step_groups(torch, step).items()}))
    del steppers
    gc.collect()
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    backbone = build_backbone(
        C.swin_tiny(window_size=W14, attention_impl="pallas",
                    fused_block_stages=()),
        generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(EVAL_BATCH, 224, 224, 3,
                    generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    for launches in counters.values():
        for k in launches:
            launches[k] = 0
    with torch.inference_mode():
        feats = backbone.forward_features(x)[0]
    torch.cuda.synchronize()
    row7 = {name: dict(launches) for name, launches in counters.items()}
    want = {name: {k: 0 for k in kinds} for name, (_, kinds) in KERNELS.items()}
    want["pallas_window_attention"]["fwd"] = (
        backbone.pallas_window_attention_calls(224))
    if row7 != want or not torch.isfinite(feats).all() or tuple(
            feats.shape) != (EVAL_BATCH, 768):
        raise AssertionError(f"w14 eval forward: launches {row7}, derived "
                             f"{want}, features {tuple(feats.shape)}")
    with torch.inference_mode():
        t_eval = _median_ms(torch, lambda: backbone.forward_features(x))
    log(f"w14 eval forward, qkv-layout route, fp32, batch {EVAL_BATCH} at "
        f"224 px: {t_eval:.2f} ms ({EVAL_BATCH / t_eval * 1e3:.1f} img/s), "
        f"launches {row7['pallas_window_attention']} as derived [{card}]")
    del backbone, x, feats
    gc.collect()
    torch.cuda.empty_cache()
    _w14_knn(C, card, os.path.join(out_dir, "w14_knn"))
    return {"fused_block": got["fused_block"],
            "pallas_window_attention": row7["pallas_window_attention"]}


def phase_swin_b_w14(torch, C, counters, card, out_dir):
    """Swin-B at W=14 (swin_tiny_multicrop's recipe with
    model=swin_base(window_size=14): B=8, 2x224 + 8x96, 65536-wide heads,
    DDINO, bf16, seed 0, synthetic crops on the card) on three routes: the
    kernel route (the default fused stages: the block-fused pair at C
    128 / 256 / 512 on N=196, 145 and 37, the packed pair at N=49 in stage
    3), the packed route (fused_block_stages=(): rows 3-4 at N=196 in
    stages 0-2 at 224 px and the 96 px stage 0, N=49 in stage 3) and the
    plain route (also attention_impl='xla': no kernel). B14_STEPS steps of
    each through train() with the slice's checks (finite losses, state
    moved, every kernel's launches as derived: 66 / 44 block-fused a step
    on the kernel route, 54 / 36 of them at C=512; 50 / 26 packed on the
    packed route, 46 / 24 of them at N=196), each run's ms/step and peak
    memory; then B14_ROUNDS alternating rounds of B14_STEPS steps on one
    trainer per route, going on from its train() run's state: each route's
    median ms/step over steps 2..B14_STEPS of its rounds and the spread,
    and its device time by
    kernel group (torch.profiler, 1 step). Returns the launches of the
    kernel route's block-fused pair and of the packed route's pair."""
    import gc

    base = C.swin_tiny_multicrop(B14_BATCH, output_dir=out_dir)
    routes = {
        "kernel": base.replace(model=C.swin_base(window_size=W14)),
        "packed": base.replace(model=C.swin_base(window_size=W14,
                                                 fused_block_stages=())),
        "plain": base.replace(model=C.swin_base(
            window_size=W14, fused_block_stages=(), attention_impl="xla"))}
    per_step = {name: _derived_launches(cfg, 1)
                for name, cfg in routes.items()}
    by_n = _fused_n_split(routes["kernel"])
    by_c = _fused_n_split(routes["kernel"], by="C")
    packed_n = _packed_n_split(routes["packed"])
    log(f"swin-b w14 derived launches per step: {per_step}; kernel route "
        f"block-fused by N {by_n}, by C {by_c}; packed route rows 3-4 by N "
        f"{packed_n}")
    none = {"fwd": 0, "bwd": 0}
    if (per_step["kernel"]["fused_block"] != {"fwd": 66, "bwd": 44}
            or (by_c["fwd"].get(512), by_c["bwd"].get(512)) != (54, 36)
            or per_step["kernel"]["window_attention"] != {"fwd": 4, "bwd": 2}
            or per_step["packed"]["fused_block"] != none
            or per_step["packed"]["window_attention"] != {"fwd": 50,
                                                         "bwd": 26}
            or packed_n != {"fwd": {196: 46, 49: 4}, "bwd": {196: 24, 49: 2}}
            or any(v for kinds in per_step["plain"].values()
                   for v in kinds.values())):
        raise AssertionError(f"swin-b w14: derived launches {per_step}, "
                             f"block-fused by C {by_c}, packed by N "
                             f"{packed_n}")
    got, peak, steppers = {}, {}, {}
    for name, cfg in routes.items():
        base = torch.cuda.memory_allocated()
        got[name], _, state = _slice(torch, cfg, B14_STEPS, counters,
                                     f"Swin-B W=14 {name} route", card, True,
                                     keep_state=True)
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        steppers[name] = _route_stepper(torch, cfg, state)
        del state
    ms = {name: [] for name in routes}
    for rnd in range(B14_ROUNDS):
        for name in list(routes)[::1 if rnd % 2 == 0 else -1]:
            steps = [steppers[name]() for _ in range(B14_STEPS)][1:]
            ms[name] += steps
            log(f"swin-b w14 round {rnd + 1} {name} route: "
                + ", ".join(f"{t:.1f}" for t in steps) + " ms/step")
    for name, steps in ms.items():
        log(f"swin-b w14 {name} route: median {statistics.median(steps):.1f} "
            f"ms/step, spread {min(steps):.1f}-{max(steps):.1f} over "
            f"{len(steps)} steps of {B14_ROUNDS} alternating rounds, peak "
            f"{peak[name]:.2f} GiB in its train() run [{card}]")
    log(_side_by_side("swin-b w14 routes", ms, card))
    for name, step in steppers.items():
        log(f"swin-b w14 {name} route, device ms per step by kernel group "
            f"(torch.profiler): " + json.dumps(
                {g: round(v, 3) for g, v in _step_groups(torch, step).items()})
            + f" [{card}]")
    del steppers
    gc.collect()
    torch.cuda.empty_cache()
    return {"fused_block": got["kernel"]["fused_block"],
            "window_attention": got["packed"]["window_attention"]}


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


# The entry phase: the CLIs run in subprocesses as a user runs them,
# through this wrapper, which sets every kernel's launch count to 0, runs
# the module as __main__ and at exit prints the counts and the seconds the
# module's main took (atexit: also after sys.exit).
ENTRY_RUN = """\
import atexit, json, runpy, sys, time
from esvit_tpu_torch.ops import (fused_block, pallas_window_attention,
                                 sliding_chunk, window_attention)
counters = {"window_attention": window_attention.launches,
            "fused_block": fused_block.launches,
            "sliding_chunk": sliding_chunk.launches,
            "pallas_window_attention": pallas_window_attention.launches}
for c in counters.values():
    for k in c:
        c[k] = 0
t0 = time.perf_counter()
atexit.register(lambda: print("entry-record " + json.dumps({
    "launches": {n: dict(c) for n, c in counters.items()},
    "seconds": time.perf_counter() - t0}), flush=True))
module, sys.argv = sys.argv[1], sys.argv[1:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
TRAIN_MODULE = "esvit_tpu_torch.train.train"
# Swin-T W=7 at full width through the CLI's defaults (B=32 per card,
# 2x224 + 8x96 crops, 65536-dim heads with the dense head, bf16) on its
# synthetic kind: SyntheticImages' 256 images, 8 steps an epoch.
ENTRY_ARGS = ["--arch", "swin_tiny", "--data_kind", "synthetic"]
ENTRY_IMAGES = 256
ENTRY_DEVICE = "cuda"
ENTRY_EVAL_ARGS = ["--arch", "swin_tiny"]
ENTRY_TIMEOUT = 600
# The evals' ImageFolder: procedural shapes (16 classes) of 128 px.
ENTRY_EVAL_TRAIN, ENTRY_EVAL_VAL, ENTRY_EVAL_SIZE = 512, 128, 128
# Two runs of one route may differ in the last bits: the backward of the
# region matching's gather is a scatter-add with atomics.
ENTRY_LOSS_RTOL = 1e-6


def _entry_env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1")
    env.update(extra)
    return env


def _entry_record(label, text):
    """The wrapper's record in a run's output."""
    for line in text.splitlines():
        if line.startswith("entry-record "):
            return json.loads(line[len("entry-record "):])
    raise AssertionError(f"entry {label}: no launch record:\n{text[-4000:]}")


def _entry_run(label, module, args, env=None, want_rc=0):
    """One CLI run through ENTRY_RUN: (output, record), failing on another
    exit code than ``want_rc``."""
    return _entry_runs([(label, module, args, env, want_rc)])[0]


def _entry_runs(runs):
    """CLI runs through ENTRY_RUN, all at once (_EntryRuns): their
    (output, record) in order."""
    with _EntryRuns(runs) as started:
        return started.finish()


# The labels of the subprocesses going on while this process works: the
# times this process prints then say so (_beside).
_BESIDE = []


def _beside():
    """' (beside <labels>)' while subprocesses started in the background
    run, else ''."""
    return f" (beside {', '.join(_BESIDE)})" if _BESIDE else ""


class _EntryRuns:
    """CLI runs through ENTRY_RUN, each (label, module, args, env or None,
    want_rc), all started on entering the block; ``finish()`` waits for
    them and returns their (output, record) in order, failing on another
    exit code or after ENTRY_TIMEOUT. Leaving the block kills a run still
    going. Work this process does between the two goes on beside them
    (``beside`` names it in the runs' lines; its own times say so through
    _beside). Runs that go together share the card and the host, so what
    they time of themselves is not a time of one run alone."""

    def __init__(self, runs, beside=None):
        self.runs, self.beside = runs, beside
        self.procs, self.labels = [], []
        self.stack = contextlib.ExitStack()

    def __enter__(self):
        self.t0 = time.perf_counter()
        try:
            for label, module, args, env, _ in self.runs:
                out, err = (self.stack.enter_context(
                    tempfile.TemporaryFile("w+")) for _ in range(2))
                self.procs.append((subprocess.Popen(
                    [sys.executable, "-c", ENTRY_RUN, module, *args],
                    cwd=ROOT, env=env or _entry_env(), stdout=out,
                    stderr=err, text=True), out, err))
        except BaseException:
            self.__exit__()
            raise
        self.labels = [r[0] for r in self.runs]
        _BESIDE.extend(self.labels)
        return self

    def _stop(self):
        for proc, _, _ in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        for label in self.labels:
            _BESIDE.remove(label)
        self.labels = []

    def __exit__(self, *exc):
        try:
            self._stop()
        finally:
            self.stack.close()

    def finish(self):
        ends = [None] * len(self.procs)
        try:
            while None in ends:
                if time.perf_counter() - self.t0 > ENTRY_TIMEOUT:
                    raise AssertionError(
                        f"entry {[r[0] for r in self.runs]}: over "
                        f"{ENTRY_TIMEOUT} s")
                for i, (proc, _, _) in enumerate(self.procs):
                    if ends[i] is None and proc.poll() is not None:
                        ends[i] = time.perf_counter()
                time.sleep(0.05)
        finally:
            self._stop()
        results = []
        for (label, _, _, _, want_rc), (proc, out, err), end in zip(
                self.runs, self.procs, ends):
            out.seek(0)
            err.seek(0)
            text = out.read() + err.read()
            if proc.returncode != want_rc:
                raise AssertionError(f"entry {label}: exit {proc.returncode}"
                                     f", want {want_rc}:\n{text[-6000:]}")
            others = [r[0] for r in self.runs if r[0] != label]
            log(f"entry {label}: exit {proc.returncode} in "
                f"{end - self.t0:.1f} s"
                + (f" (at once with {', '.join(others)})" if others else "")
                + (f" (beside {self.beside} in this process)"
                   if self.beside else ""))
            results.append((text, _entry_record(label, text)))
        return results


def _entry_launches(label, got, want):
    if got != want:
        raise AssertionError(f"entry {label}: launches {got}, model-derived "
                             f"{want}")
    log(f"entry {label}: launches {got}, as derived from the model")


def _checkpoint_lines(text):
    """(files, step, bytes, seconds) of each 'checkpoint:' line."""
    out = []
    for m in re.finditer(r"^checkpoint: (.*) at step (\d+), (\d+) bytes, "
                         r"([0-9.]+) s$", text, re.M):
        out.append((m.group(1), int(m.group(2)), int(m.group(3)),
                    float(m.group(4))))
    return out


def _load_tree(torch, path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _tree_tensors(tree):
    out = {}
    for part in ("student", "teacher", "mu", "nu"):
        out.update({f"{part}.{k}": v for k, v in tree[part].items()})
    out.update({f"centers.{k}": v for k, v in tree["centers"].items()})
    return out


def _eval_folder(root, n, seed):
    """``n`` procedural 16-class PNGs under root/<class>/."""
    from esvit_tpu_torch.data.datasets import ProceduralShapesHard

    ds = ProceduralShapesHard(n=n, size=ENTRY_EVAL_SIZE, seed=seed)
    for i in range(n):
        img, label = ds[i]
        d = os.path.join(root, f"class{label:02d}")
        os.makedirs(d, exist_ok=True)
        img.save(os.path.join(d, f"{i:05d}.png"))
    return root


class _SigtermRun:
    """The train CLI through ENTRY_RUN with ``args``, sent SIGTERM from a
    reader thread once it prints ``first`` (its first step's log line),
    started on entering the block; ``finish()`` waits for its exit and
    returns (exit code, output), failing if it ended before that line or
    ran past ENTRY_TIMEOUT. Leaving the block kills it if it still
    runs."""

    def __init__(self, args, first):
        self.args, self.first = args, first
        self.lines, self.sent = [], False

    def __enter__(self):
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, "-c", ENTRY_RUN, TRAIN_MODULE, *self.args],
            cwd=ROOT, env=_entry_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        _BESIDE.append("sigterm")
        return self

    def _read(self):
        import signal

        for line in self.proc.stdout:
            self.lines.append(line)
            if not self.sent and line.startswith(self.first):
                self.sent = True
                self.proc.send_signal(signal.SIGTERM)

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)
        if "sigterm" in _BESIDE:
            _BESIDE.remove("sigterm")

    def finish(self):
        try:
            self.proc.wait(ENTRY_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"entry sigterm: over {ENTRY_TIMEOUT} s")
        finally:
            self.__exit__()
        self.reader.join(60)
        text = "".join(self.lines)
        if not self.sent:
            raise AssertionError("entry sigterm: exited before its first "
                                 "step:\n" + "".join(self.lines[-50:]))
        return self.proc.returncode, text


def phase_entry(torch, C, card):
    """The pre-training entry point and the evals on its checkpoint, as a
    user runs them (``python -m ...`` in subprocesses, through ENTRY_RUN),
    at Swin-T's full width on the default route, in a temporary directory
    removed at the end. The runs go in two waves, each wave's runs at
    once: (1) train, SIGTERM, plain and NCCL; (2) resume, the SIGTERM
    rerun, k-NN and the linear probe.

    - train: 2 epochs of 8 steps (--saveckp_freq 2): exit 0,
      checkpoint.pth and checkpoint0000.pth, two finite log.txt lines,
      the kernels' launches as derived from the model for 16 steps; ms per
      step from the log, each checkpoint's size and save time; the
      checkpoint's counts of parameters (student = backbone + two heads;
      student, teacher, mu and nu);
    - SIGTERM after the first step's log line: exit 0 and checkpoint.pth
      at the step it names; a rerun resumes from it;
    - NCCL: two runs of --max_steps 2, one under --distributed with
      WORLD_SIZE=1 RANK=0 (NCCL runs the step's all-reduce, which gives
      back its input), one without: their losses within ENTRY_LOSS_RTOL,
      and the largest difference of the two checkpoints;
    - the round trip: train's checkpoint restored into a state on the
      card (drawn from another seed) equals the file bit for bit, every
      tensor, and a save of that state writes the same tensors;
    - resume to --epochs 3: 'resumed from step 16', 8 more steps to 24,
      checkpoint0002.pth;
    - the k-NN and linear-probe CLIs with --pretrained on a copy of
      train's checkpoint.pth over a PNG ImageFolder of procedural shapes:
      top-1, img/s over the CLI's main, and the launches as derived."""
    import socket

    from esvit_tpu_torch.train import train as train_cli

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        d_train = os.path.join(tmp, "train")
        args = [*ENTRY_ARGS, "--output_dir", d_train]
        cfg = train_cli.config_from_args(
            train_cli.get_args_parser().parse_args(args))
        spe = ENTRY_IMAGES // cfg.optim.batch_size_per_device
        d_term = os.path.join(tmp, "sigterm")
        term_args = [*ENTRY_ARGS, "--output_dir", d_term]
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        legs = (("plain", [], _entry_env()),
                ("nccl", ["--distributed"], _entry_env(
                    WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=port)))

        # Wave 1: train for 2 epochs, the run that gets SIGTERM, and the
        # plain and NCCL 2-step runs, at once; the evals' PNGs are
        # written meanwhile.
        wave = [("train", TRAIN_MODULE,
                 [*args, "--epochs", "2", "--saveckp_freq", "2"], None, 0)]
        wave += [(f"{name} 2 steps", TRAIN_MODULE,
                  [*ENTRY_ARGS, "--output_dir", os.path.join(tmp, name),
                   "--max_steps", "2", *extra], env, 0)
                 for name, extra, env in legs]
        first = f"Epoch: [0/{cfg.optim.epochs}] [0]"
        with _SigtermRun(term_args, first) as term, _EntryRuns(
                wave, beside="the sigterm run and the evals' PNGs being "
                "written") as started:
            t0 = time.perf_counter()
            train_dir = _eval_folder(os.path.join(tmp, "eval_train"),
                                     ENTRY_EVAL_TRAIN, seed=7)
            val_dir = _eval_folder(os.path.join(tmp, "eval_val"),
                                   ENTRY_EVAL_VAL, seed=13)
            log(f"entry evals: {ENTRY_EVAL_TRAIN} + {ENTRY_EVAL_VAL} PNGs of "
                f"{ENTRY_EVAL_SIZE} px written in "
                f"{time.perf_counter() - t0:.1f} s")
            (text, rec), *done = started.finish()
            term_rc, term_text = term.finish()

        # Train: 2 epochs.
        if not text.startswith("git: "):
            raise AssertionError(f"entry train: no git line: {text[:200]}")
        _entry_launches("train", rec["launches"],
                        _derived_launches(cfg, 2 * spe))
        files = sorted(os.listdir(d_train))
        if files != ["checkpoint.pth", "checkpoint0000.pth", "log.txt"]:
            raise AssertionError(f"entry train: files {files}")
        logs = [json.loads(x) for x in
                open(os.path.join(d_train, "log.txt")).read().splitlines()]
        if ([r["epoch"] for r in logs] != [0, 1]
                or not all(math.isfinite(r["train_loss"]) for r in logs)):
            raise AssertionError(f"entry train: log.txt {logs}")
        images = cfg.crops.ncrops * cfg.optim.batch_size_per_device
        ms = [1e3 * images / r["train_img_per_sec"] for r in logs]
        saves = _checkpoint_lines(text)
        log(f"entry train: log.txt losses "
            f"{[round(r['train_loss'], 4) for r in logs]}; ms/step from the "
            f"log's img/s: epoch 0 {ms[0]:.1f} (first step included), "
            f"epoch 1 {ms[1]:.1f}, the wave's runs at once [{card}]")
        for files_, step, size, secs in saves:
            log(f"entry train: checkpoint {files_} at step {step}: {size} "
                f"bytes ({size / 2**30:.3f} GiB), saved in {secs:.3f} s, "
                f"the wave's runs at once [{card}]")
        if [s[1] for s in saves] != [spe, 2 * spe]:
            raise AssertionError(f"entry train: saves {saves}")
        from esvit_tpu_torch.train.step import EsViTTrainer

        tree = _load_tree(torch, os.path.join(d_train, "checkpoint.pth"))
        n = {part: sum(v.numel() for v in tree[part].values())
             for part in ("student", "teacher", "mu", "nu")}
        heads = {h: sum(v.numel() for k, v in tree["mu"].items()
                        if k.startswith(h + "."))
                 for h in ("head", "head_dense")}
        backbone = n["mu"] - sum(heads.values())
        total = sum(n.values())
        model = EsViTTrainer(cfg, device="cpu").build_model()
        params = sum(p.numel() for p in model.parameters())
        entries = sum(v.numel() for v in model.state_dict().values())
        del model
        log(f"entry train: parameters {n['mu']} (backbone {backbone}, head "
            f"{heads['head']}, head_dense {heads['head_dense']}); tensors "
            f"in the checkpoint {total} = student {n['student']} + teacher "
            f"{n['teacher']} + mu {n['mu']} + nu {n['nu']}, "
            f"{4 * total / 2**30:.3f} GiB of fp32")
        if (tree["step"] != 2 * spe or n["mu"] != params
                or n["nu"] != params or n["student"] != entries
                or n["teacher"] != entries):
            raise AssertionError(f"entry train: checkpoint counts {n}, the "
                                 f"model's {params} parameters, {entries} "
                                 f"state entries, step {tree['step']}")

        # SIGTERM after the first step's log line.
        m = re.search(r"checkpointed at step (\d+)", term_text)
        if term_rc != 0 or m is None:
            raise AssertionError(f"entry sigterm: exit {term_rc}:\n"
                                 f"{term_text[-4000:]}")
        term_step = int(m.group(1))
        tree_t = _load_tree(torch, os.path.join(d_term, "checkpoint.pth"))
        if tree_t["step"] != term_step:
            raise AssertionError(f"entry sigterm: checkpoint at step "
                                 f"{tree_t['step']}, printed {term_step}")
        log(f"entry sigterm: exit 0, checkpoint.pth at step {term_step}")

        # NCCL at world size 1 against the plain run.
        runs = {}
        for (name, _, _), (text_, _) in zip(legs, done):
            d = os.path.join(tmp, name)
            loss = json.loads(open(os.path.join(d, "log.txt")).read()
                              .splitlines()[-1])["train_loss"]
            runs[name] = (text_, loss, _tree_tensors(
                _load_tree(torch, os.path.join(d, "checkpoint.pth"))))
        backend = ("nccl on cuda:0" if ENTRY_DEVICE == "cuda"
                   else "gloo on cpu")
        if f"torch.distributed: process 0/1, {backend}" not in \
                runs["nccl"][0]:
            raise AssertionError("entry nccl: no NCCL group line:\n"
                                 + runs["nccl"][0][-3000:])
        (_, loss_a, ta), (_, loss_b, tb) = runs["plain"], runs["nccl"]
        diff = max((ta[k].float() - tb[k].float()).abs().max().item()
                   for k in ta if ta[k].numel())
        log(f"entry nccl: world size 1 on NCCL, mean loss of 2 steps "
            f"{loss_b!r} vs {loss_a!r} without --distributed (difference "
            f"{abs(loss_a - loss_b):.3e}); largest difference of the two "
            f"checkpoints {diff:.3e}. NCCL takes one rank per card: a run "
            f"of two or more ranks needs a machine with that many cards")
        if abs(loss_a - loss_b) > ENTRY_LOSS_RTOL * abs(loss_a):
            raise AssertionError(f"entry nccl: losses {loss_b} vs {loss_a}")
        del runs, ta, tb

        # Round trip on the card, of train's checkpoint.
        from esvit_tpu_torch.io.checkpoint import (CheckpointManager,
                                                   state_to_dict)

        saved = _tree_tensors(tree)
        trainer = EsViTTrainer(cfg.replace(steps_per_epoch=spe),
                               device=ENTRY_DEVICE)
        state = trainer.init_state(torch.Generator().manual_seed(1))
        t0 = time.perf_counter()
        CheckpointManager(d_train).restore(state)
        restore_s = time.perf_counter() - t0
        live = {f"student.{k}": v for k, v in
                state.student.state_dict().items()}
        live.update({f"teacher.{k}": v for k, v in
                     state.teacher.state_dict().items()})
        live.update({f"mu.{k}": v for k, v in state.mu.items()})
        live.update({f"nu.{k}": v for k, v in state.nu.items()})
        live["centers.center"], live["centers.center_grid"] = state.centers
        if set(live) != set(saved) or any(
                v.device.type != ENTRY_DEVICE
                or not torch.equal(v.cpu(), saved[k])
                for k, v in live.items()):
            raise AssertionError("entry round trip: the state on the card "
                                 "differs from the file")
        again = _tree_tensors(state_to_dict(state))
        if any(not torch.equal(again[k], v) for k, v in saved.items()):
            raise AssertionError("entry round trip: a save of the restored "
                                 "state differs")
        log(f"entry round trip: {len(saved)} tensors restored on the card "
            f"bit for bit in {restore_s:.2f} s; saved again bit for bit")
        del state, trainer, live, saved, again, tree
        torch.cuda.empty_cache()

        # Wave 2: the resume, the rerun from the SIGTERM save and the two
        # evals on a copy of train's checkpoint (the resume rewrites
        # checkpoint.pth), at once.
        trained = os.path.join(tmp, "trained.pth")
        shutil.copyfile(os.path.join(d_train, "checkpoint.pth"), trained)
        from esvit_tpu_torch.models.registry import build_backbone

        probe = build_backbone(cfg.model)
        batches = (-(-ENTRY_EVAL_TRAIN // EVAL_BATCH)
                   + -(-ENTRY_EVAL_VAL // EVAL_BATCH))
        images = ENTRY_EVAL_TRAIN + ENTRY_EVAL_VAL
        common = [*ENTRY_EVAL_ARGS, "--pretrained", trained, "--train_path",
                  train_dir, "--val_path", val_dir, "--output_dir",
                  os.path.join(tmp, "eval")]
        zero = {name: {k: 0 for k in kinds}
                for name, (_, kinds) in KERNELS.items()}
        evals = (
            ("k-NN", "esvit_tpu_torch.evals.knn",
             ["--batch_size", str(EVAL_BATCH)],
             {"fused_block": probe.fused_block_calls(224),
              "window_attention": probe.window_attention_calls(224)},
             r"^10-NN classifier result: Top1: ([0-9.]+)"),
            ("linear probe", "esvit_tpu_torch.evals.linear",
             ["--batch_size", str(EVAL_BATCH), "--epochs", "10",
              "--cached_features"],
             {"window_attention": probe.window_attention_calls(
                 224, capture=True)},
             r"^Linear probe: Top1 ([0-9.]+)"))
        del probe
        (text, rec), (rerun_text, _), *done = _entry_runs([
            ("resume", TRAIN_MODULE,
             [*args, "--epochs", "3", "--saveckp_freq", "2"], None, 0),
            ("sigterm rerun", TRAIN_MODULE,
             [*term_args, "--max_steps", str(term_step + 1)], None, 0),
            *((label, module, [*common, *extra], None, 0)
              for label, module, extra, _, _ in evals)])

        # Resume: a third epoch.
        _entry_launches("resume", rec["launches"],
                        _derived_launches(cfg, spe))
        step = _load_tree(torch, os.path.join(d_train, "checkpoint.pth"))[
            "step"]
        if (f"resumed from step {2 * spe}" not in text or step != 3 * spe
                or not os.path.exists(os.path.join(d_train,
                                                   "checkpoint0002.pth"))):
            raise AssertionError(f"entry resume: step {step}:\n"
                                 f"{text[-3000:]}")
        log(f"entry resume: resumed from step {2 * spe}, ended at step "
            f"{step}, checkpoint0002.pth written")

        # The rerun from the SIGTERM save.
        step = _load_tree(torch, os.path.join(d_term, "checkpoint.pth"))[
            "step"]
        if f"resumed from step {term_step}" not in rerun_text or \
                step != term_step + 1:
            raise AssertionError(f"entry sigterm rerun: step {step}:\n"
                                 f"{rerun_text[-3000:]}")
        log(f"entry sigterm rerun: resumed from step {term_step}, ended at "
            f"step {step}")

        # The evals on train's checkpoint.
        for (label, _, _, want_fwd, pattern), (text, rec) in zip(evals,
                                                                  done):
            want = {name: dict(kinds) for name, kinds in zero.items()}
            for name, calls in want_fwd.items():
                want[name]["fwd"] = calls * batches
            _entry_launches(label, rec["launches"], want)
            m = re.search(pattern, text, re.M)
            if m is None or not 0.0 <= float(m.group(1)) <= 100.0:
                raise AssertionError(f"entry {label}: no result:\n"
                                     f"{text[-3000:]}")
            log(f"entry {label} on the trained checkpoint: top-1 "
                f"{float(m.group(1)):.2f}% (16 classes), {images} images in "
                f"{rec['seconds']:.1f} s of main(), {images / rec['seconds']:.1f} "
                f"img/s (model build and checkpoint load included; the "
                f"wave's four runs at once) [{card}]")


# Phase 12, the real-image path: JPEGs written once from a seed into the
# run's directory at ImageNet's commonest sizes, packed as a zip with its
# map file, a TSV (base64 image, JSON label) with its .lineidx and a file
# list; grayscale JPEGs and PNGs among them, which the feed must decode
# and count.
REAL_IMAGES, REAL_CLASSES, REAL_QUALITY, REAL_SEED = 512, 16, 90, 0
REAL_SIZES = ((500, 375), (375, 500))          # (width, height)
REAL_GRAY = frozenset(range(7, REAL_IMAGES, 64))    # 8 grayscale JPEGs
REAL_PNG = frozenset((100, 301))
REAL_CHECK, REAL_STEPS, REAL_CLI_STEPS = 64, 6, 4
REAL_FEED_BATCHES = 6


def _real_image(i):
    """(name, encoded bytes, label) of image i: a smooth colour field,
    shapes and fine texture, so that a decode costs what a photograph's
    does; grayscale JPEG or PNG at REAL_GRAY / REAL_PNG."""
    import io

    import numpy as np
    from PIL import Image, ImageDraw

    rng = np.random.default_rng([REAL_SEED, i])
    w, h = REAL_SIZES[i % 2]
    field = rng.integers(0, 256, (h // 40 + 2, w // 40 + 2, 3), np.uint8)
    img = Image.fromarray(field).resize((w, h), Image.BICUBIC)
    draw = ImageDraw.Draw(img)
    for _ in range(int(rng.integers(4, 9))):
        x0, y0 = int(rng.integers(0, w - 40)), int(rng.integers(0, h - 40))
        x1 = x0 + int(rng.integers(30, w // 2))
        y1 = y0 + int(rng.integers(30, h // 2))
        fill = tuple(int(c) for c in rng.integers(0, 256, 3))
        (draw.ellipse if rng.random() < 0.5 else draw.rectangle)(
            [x0, y0, x1, y1], fill=fill)
    arr = np.asarray(img, np.int16) + rng.integers(-20, 21, (h, w, 3))
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    out = io.BytesIO()
    label = i % REAL_CLASSES
    if i in REAL_PNG:
        img.save(out, "PNG")
        return f"c{label:02d}/{i:05d}.png", out.getvalue(), label
    if i in REAL_GRAY:
        img = img.convert("L")
    img.save(out, "JPEG", quality=REAL_QUALITY)
    return f"c{label:02d}/{i:05d}.jpg", out.getvalue(), label


def _real_stores(root):
    """The images packed three ways under root: {'zip': ZipData, 'tsv':
    TSVDataset, 'filelist': FileListDataset}, and the items."""
    from esvit_tpu_torch.data import datasets, stores

    items = [_real_image(i) for i in range(REAL_IMAGES)]
    stores.write_zip(items, os.path.join(root, "images.zip"),
                     os.path.join(root, "map.txt"))
    stores.write_tsv(items, os.path.join(root, "images.tsv"))
    stores.write_filelist(items, os.path.join(root, "files"),
                          os.path.join(root, "list.txt"))
    return {"zip": datasets.ZipData(os.path.join(root, "images.zip"),
                                    os.path.join(root, "map.txt")),
            "tsv": datasets.TSVDataset(os.path.join(root, "images.tsv")),
            "filelist": datasets.FileListDataset(
                os.path.join(root, "files"), os.path.join(root, "list.txt"))
            }, items


def _real_views_check(lib, items, crops):
    """On the first REAL_CHECK images, all ten boxes: the native views
    against PIL's within the reference's bounds (decode bit-identical,
    crop within 1 LSB, the scaled decode within RMS 4 and mean 2.5)."""
    import io
    import random

    import numpy as np
    from PIL import Image

    from esvit_tpu_torch.data.augment_host import sample_multicrop_boxes

    worst = {"crop": 0, "rms": 0.0, "mean": 0.0}
    n = 0
    for i, (name, data, _) in enumerate(items[:REAL_CHECK]):
        if not name.endswith(".jpg"):
            continue
        with Image.open(io.BytesIO(data)) as img:
            pil = img.convert("RGB")
        pixels = np.asarray(pil)
        boxes, sizes = sample_multicrop_boxes(crops, random.Random(i),
                                              pil.width, pil.height)
        want = [np.asarray(pil.resize((s, s), Image.BICUBIC,
                                      box=(l, t, l + w, t + h)), np.int16)
                for (t, l, h, w), s in zip(boxes, sizes)]
        if lib.jpeg and not np.array_equal(lib.jpeg_decode(data), pixels):
            raise AssertionError(f"real {name}: native decode differs from "
                                 "PIL's")
        views = {}
        for scaled in (False, True):      # without libjpeg: never scaled
            outs = [np.zeros((1, s, s, 3), np.uint8) for s in sizes]
            if lib.crops([lib.source(data)[0]], boxes[None], sizes, outs, [0],
                         allow_scaled=scaled)[0]:
                raise AssertionError(f"real {name}: native crops failed")
            views[scaled] = [o[0] for o in outs]
        for g, s_, w_ in zip(views[False], views[True], want):
            worst["crop"] = max(worst["crop"],
                                int(np.abs(g.astype(np.int16) - w_).max()))
            d = np.abs(s_.astype(np.float64) - g.astype(np.float64))
            worst["rms"] = max(worst["rms"], float(np.sqrt((d ** 2).mean())))
            worst["mean"] = max(worst["mean"], float(d.mean()))
        n += 1
    if worst["crop"] > 1 or worst["rms"] >= 4.0 or worst["mean"] >= 2.5:
        raise AssertionError(f"real views vs PIL: {worst}")
    return n, worst


def phase_real_images(torch, C, counters, card, synthetic_ms):
    """The real-image path (see the module docstring, phase 12): the
    native views and the loader's native batches against PIL's; train()
    fed from the zip for REAL_STEPS steps with the native decode, then
    with PIL, each with the slice's checks and the decode counts; the
    train CLI on the zip and on the TSV (host_aug and mixup); the k-NN
    eval on the stores through the native eval transform."""
    import numpy as np

    from esvit_tpu_torch import native
    from esvit_tpu_torch.data.loader import MultiCropIterator
    from esvit_tpu_torch.evals import knn
    from esvit_tpu_torch.models.registry import build_backbone
    from esvit_tpu_torch.train import train as train_cli

    lib = native.library()
    mode = ("decode and crop (libjpeg)" if lib.jpeg else
            "crop only, PIL decodes: no libjpeg headers on this machine ("
            + (native.jpeg_note() or "").splitlines()[0] + ")")
    log(f"real images: native library {lib.path.name}: {mode}")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = C.swin_tiny_multicrop(BATCH, output_dir=tmp)
        t0 = time.perf_counter()
        ds, items = _real_stores(tmp)
        kinds = [name.rsplit(".", 1)[1] for name, _, _ in items]
        mb = sum(len(d) for _, d, _ in items) / 1e6
        log(f"real images: {REAL_IMAGES} images ({kinds.count('jpg')} JPEG "
            f"of which {len(REAL_GRAY)} grayscale, {kinds.count('png')} "
            f"PNG), {mb:.1f} MB encoded, written as zip, TSV and file list "
            f"in {time.perf_counter() - t0:.1f} s")

        n, worst = _real_views_check(lib, items, cfg.crops)
        log(f"real views: {n} JPEGs x 10 boxes, native vs PIL: crop max "
            f"|d| {worst['crop']} LSB (bound 1), scaled decode RMS "
            f"{worst['rms']:.3f} (bound 4), mean {worst['mean']:.3f} "
            f"(bound 2.5)")
        # The loader's batches, native against PIL: the same geometry,
        # each host view within the scaled decode's bounds (within 1 LSB
        # where no view allows a scaled decode), the augmented batches
        # within 0.02.
        its = {nat: MultiCropIterator(ds["zip"], cfg.crops, BATCH,
                                      seed=cfg.seed, native_decode=nat,
                                      num_threads=NUM_THREADS, device="cuda")
               for nat in (True, False)}
        host = {nat: [b for _, b in zip(range(2), it.host_batches())]
                for nat, it in its.items()}
        host_d = {"max": 0, "rms": 0.0, "mean": 0.0}
        for (gn, ln), (gp, lp) in zip(host[True], host[False]):
            for a, b in ((gn, gp), (ln, lp)):
                if a.shape != b.shape:
                    raise AssertionError(f"real loader: native {a.shape}, "
                                         f"PIL {b.shape}")
                d = (a.double() - b.double()).abs().flatten(1)
                host_d["max"] = max(host_d["max"], int(d.max()))
                host_d["rms"] = max(host_d["rms"],
                                    float(d.pow(2).mean(1).sqrt().max()))
                host_d["mean"] = max(host_d["mean"], float(d.mean(1).max()))
        if host_d["rms"] >= 4.0 or host_d["mean"] >= 2.5:
            raise AssertionError(f"real loader: native host views vs PIL's "
                                 f"{host_d}")
        dev = {nat: [b for _, b in zip(range(2), iter(MultiCropIterator(
            ds["zip"], cfg.crops, BATCH, seed=cfg.seed, native_decode=nat,
            num_threads=NUM_THREADS, device="cuda")))] for nat in (True, False)}
        diff = max(float((a - b).abs().mean())
                   for (gn, ln), (gp, lp) in zip(dev[True], dev[False])
                   for a, b in ((gn, gp), (ln, lp)))
        if diff >= 0.02:
            raise AssertionError(f"real loader: augmented batches differ by "
                                 f"mean {diff} (bound 0.02)")
        log(f"real loader: 2 batches of {BATCH}, native vs PIL: host views "
            f"max |d| {host_d['max']} LSB, per view RMS up to "
            f"{host_d['rms']:.3f} (bound 4), mean up to {host_d['mean']:.3f} "
            f"(bound 2.5); augmented on the card mean |d| {diff:.5f} "
            f"(bound 0.02)")

        # train() from the zip: the native leg, then the PIL leg.
        png = {i for i, (name, _, _) in enumerate(items)
               if name.endswith(".png")}
        taken = MultiCropIterator(ds["zip"], cfg.crops, BATCH, epoch=0,
                                  seed=cfg.seed, native_decode=False,
                                  device="cuda").indices[:REAL_STEPS * BATCH]
        n_png = sum(int(i) in png for i in taken)
        for nat in (True, False):
            label = f"Swin-T zip, {'native' if nat else 'PIL'} decode"
            _, history = _slice(torch, cfg, REAL_STEPS, counters, label, card,
                                True, dataset=ds["zip"], native_decode=nat)
            got = (sum(h["native_images"] for h in history),
                   sum(h["pil_images"] for h in history))
            want = ((REAL_STEPS * BATCH - n_png, n_png) if nat
                    else (0, REAL_STEPS * BATCH))
            if got != want:
                raise AssertionError(f"{label}: decoded (native, PIL) {got}, "
                                     f"the images read {want}")
            steady = history[1:]
            ms = statistics.mean(h["seconds"] for h in steady) * 1e3
            wait = statistics.mean(h["data_seconds"] for h in steady) * 1e3
            it = MultiCropIterator(ds["zip"], cfg.crops, BATCH, epoch=1,
                                   seed=cfg.seed, native_decode=nat,
                                   num_threads=NUM_THREADS, device="cuda")
            t0 = time.perf_counter()
            fed = sum(1 for _ in zip(range(REAL_FEED_BATCHES),
                                     it.host_batches()))
            rate = fed / (time.perf_counter() - t0)
            log(f"slice {label}: {ms:.1f} ms/step over steps 2-{REAL_STEPS} "
                f"beside synthetic_device {synthetic_ms:.1f} ms/step in this "
                f"call ({ms / synthetic_ms:.3f}x); host wait on the feed "
                f"{wait:.2f} ms/step; decoded native {got[0]}, PIL {got[1]}; "
                f"the feed alone {rate:.2f} host batches/s ({NUM_THREADS} "
                f"threads, {fed} batches, the first included) [{card}]")

        # The train CLI in subprocesses, from the zip and from the TSV, at
        # once, while this process runs the k-NN eval.
        clis = []
        for label, extra in (
                ("zip", ["--data_kind", "zip", "--data_path",
                         os.path.join(tmp, "images.zip"), "--zip_map_file",
                         os.path.join(tmp, "map.txt")]),
                ("tsv host_aug mixup", [
                    "--data_kind", "tsv", "--data_path",
                    os.path.join(tmp, "images.tsv"), "--host_aug",
                    "--use_mixup", "--num_mixup_views", "2"])):
            out = os.path.join(tmp, "cli-" + label.split()[0])
            clis.append((label, out, [
                "--arch", "swin_tiny", "--output_dir", out, "--epochs", "1",
                "--max_steps", str(REAL_CLI_STEPS), *extra]))
        with _EntryRuns([(f"real {label}", TRAIN_MODULE, args, None, 0)
                         for label, _, args in clis],
                        beside="the k-NN eval") as started:
            # k-NN through the native eval transform: the zip against the
            # file list (the same images: the decode paths are what is
            # checked).
            model = C.swin_tiny(attention_impl="pallas",
                                fused_block_stages=())
            backbone = build_backbone(
                model, generator=torch.Generator().manual_seed(0)).to("cuda")
            counts = {}
            counters["pallas_window_attention"]["fwd"] = 0
            t0 = time.perf_counter()
            res = knn.run_knn_eval(backbone, ds["zip"], ds["filelist"],
                                   ks=(10, 20), batch_size=EVAL_BATCH,
                                   device="cuda", counts=counts)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            beside = _beside()
            batches = 2 * -(-REAL_IMAGES // EVAL_BATCH)
            want = backbone.pallas_window_attention_calls(224) * batches
            got = counters["pallas_window_attention"]["fwd"]
            n_jpg = 2 * (REAL_IMAGES - len(REAL_PNG))
            if (counts != {"native": n_jpg, "pil": 2 * len(REAL_PNG)}
                    or got != want or sorted(res) != [10, 20]
                    or not all(0.0 <= a <= 100.0 for acc in res.values()
                               for a in acc)):
                raise AssertionError(f"real k-NN: counts {counts}, launches "
                                     f"{got} (derived {want}), results "
                                     f"{res}")
            log(f"real k-NN (random weights, {REAL_CLASSES} classes; the "
                f"val set is the same images through the file list: a check "
                f"of the decode path, not an accuracy): {res}; "
                f"{2 * REAL_IMAGES} images in {seconds:.2f} s "
                f"({2 * REAL_IMAGES / seconds:.1f} img/s{beside}), decoded "
                f"native {counts['native']}, PIL {counts['pil']}; launches "
                f"{got} [{card}]")
            del backbone
            torch.cuda.empty_cache()
            done = started.finish()
        for (label, out, args), (text, rec) in zip(clis, done):
            run_cfg = train_cli.config_from_args(
                train_cli.get_args_parser().parse_args(args))
            _entry_launches(f"real {label}", rec["launches"],
                            _derived_launches(run_cfg, REAL_CLI_STEPS))
            logs = [json.loads(x) for x in
                    open(os.path.join(out, "log.txt")).read().splitlines()]
            saves = _checkpoint_lines(text)
            if (len(logs) != 1 or not math.isfinite(logs[0]["train_loss"])
                    or [s[1] for s in saves] != [REAL_CLI_STEPS]
                    or not os.path.exists(os.path.join(out,
                                                       "checkpoint.pth"))):
                raise AssertionError(f"real CLI {label}: log {logs}, saves "
                                     f"{saves}:\n{text[-3000:]}")
            images = run_cfg.crops.ncrops * run_cfg.optim.batch_size_per_device
            log(f"real CLI {label}: loss {logs[0]['train_loss']:.4f}, "
                f"{1e3 * images / logs[0]['train_img_per_sec']:.1f} ms/step "
                f"from the log's img/s (first step included; both CLI runs "
                f"at once, beside the k-NN eval), checkpoint at step "
                f"{saves[0][1]} [{card}]")


# Phase 13, the CvT and ViT families at full width: the fp32 parity of the
# card against the CPU ((crop side, images) per batch; tolerance of the
# largest |feature| or |buffer|, fp32 sums in another order through 12
# blocks), train()'s steps per family, and the CLI's (steps, then the
# resume's) and the evals' image folders.
FAMILY_PARITY = ((224, 4), (96, 8))
FAMILY_TOL = 1e-4
FAMILY_STEPS = 6
FAMILY_CLI_STEPS = 4
FAMILY_EVAL_TRAIN, FAMILY_EVAL_VAL = 256, 64


def _bn_buffers(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _check_bn_moved(torch, label, student, teacher, init):
    """Every BatchNorm buffer moved from its initial value in both nets,
    and the teacher's differ from the student's (each net's own)."""
    s, t = _bn_buffers(student), _bn_buffers(teacher)
    if not s or set(s) != set(t):
        raise AssertionError(f"{label}: BatchNorm buffers {sorted(s)}")
    for k, v in s.items():
        a, b, i = v.detach().cpu(), t[k].detach().cpu(), init[k]
        if not ((a - i).abs().max() > 0 and (b - i).abs().max() > 0
                and not torch.equal(a, b)):
            raise AssertionError(f"{label}: BatchNorm buffer {k} did not "
                                 "move in both nets, or the nets share it")
    log(f"{label}: all {len(s)} BatchNorm buffers moved in the student and "
        "in the teacher, each net's its own")


def _family_parity(torch, C, name, card, cfg=None):
    """fp32 forward_features of ``name`` (a preset, or ``cfg``) on the card
    (TF32 off) against the CPU, same weights, at each FAMILY_PARITY batch;
    a BatchNorm backbone on running and on batch statistics, its buffers
    held after each bn_train forward."""
    import copy

    from esvit_tpu_torch.models.registry import build_backbone

    cfg = cfg or C.get_model_config(name)
    cpu = build_backbone(cfg, generator=torch.Generator().manual_seed(0))
    dev = copy.deepcopy(cpu).cuda()
    modes = (False, True) if cfg.name in ("cvt", "resnet") else (False,)
    for size, n in FAMILY_PARITY:
        x = torch.randn(n, size, size, 3,
                        generator=torch.Generator().manual_seed(size))
        for bn_train in modes:
            with torch.no_grad():
                want = cpu.forward_features(x, bn_train=bn_train)
                got = dev.forward_features(x.cuda(), bn_train=bn_train)
            torch.cuda.synchronize()
            errs = [(a.cpu() - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(got, want)]
            if bn_train and cfg.name == "resnet":
                # fp32 batch statistics round differently on the two
                # devices and the differences compound through 16 blocks
                # (tests/test_torch_resnet.py): the whole network is
                # printed, each block is held on the CPU's input to it.
                log(f"families {name} fp32 {n}x{size}px bn_train=True: "
                    f"whole network card vs CPU cls {errs[0]:.2e}, region "
                    f"{errs[1]:.2e} (not held) [{card}]")
                errs[:2] = _resnet_block_errors(torch, cpu, dev, x)
            if bn_train:
                bw, bg = (_bn_buffers(m.state_dict()) for m in (cpu, dev))
                errs.append(max((bg[k].cpu() - v).abs().max().item()
                                / v.abs().max().item()
                                for k, v in bw.items()))
            if max(errs) > FAMILY_TOL:
                raise AssertionError(f"{name} {size}px bn_train={bn_train}: "
                                     f"card vs CPU {errs}")
            per_block = bn_train and cfg.name == "resnet"
            log(f"families {name} fp32 {n}x{size}px bn_train={bn_train}: "
                + ("each block on the CPU's input, card vs CPU rel err up "
                   f"to {errs[0]:.2e}" if per_block else
                   f"card vs CPU rel err cls {errs[0]:.2e}, region "
                   f"{errs[1]:.2e}")
                + (f", running buffers {errs[2]:.2e}" if bn_train else "")
                + f" (tol {FAMILY_TOL}), region {tuple(got[1].shape)} "
                f"[{card}]")
    del dev


def _resnet_block_errors(torch, cpu, dev, x):
    """The largest error of the stem and of each bottleneck on the card
    (batch statistics) against the CPU's, each run on the CPU's input to
    it (relative to its largest output), and the same for the pooled
    feature; both models' buffers move as in a whole forward."""
    import torch.nn.functional as F

    def stem(model, x):
        y = F.relu(model.bn1(model.conv1(x), True))
        return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(
            0, 2, 3, 1)

    errs = []
    with torch.no_grad():
        y = stem(cpu, x)
        errs.append(_rel(torch, stem(dev, x.cuda()).cpu(), y))
        blocks = zip([b for layer in cpu.layers() for b in layer],
                     [b for layer in dev.layers() for b in layer])
        for b_cpu, b_dev in blocks:
            out = b_cpu(y, True)
            errs.append(_rel(torch, b_dev(y.cuda(), True).cpu(), out))
            y = out
    torch.cuda.synchronize()
    return [max(errs), max(errs)]


def phase_families(torch, C, counters, card):
    """Phase 13 (see the module docstring)."""
    from esvit_tpu_torch.io.checkpoint import CheckpointManager
    from esvit_tpu_torch.train import train as train_cli
    from esvit_tpu_torch.train.step import EsViTTrainer

    zero = {name: {k: 0 for k in kinds}
            for name, (_, kinds) in KERNELS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        # The train CLI: cvt_tiny and deit_small at once, while this
        # process holds both families' forwards on the card to the CPU's
        # and writes the evals' PNGs.
        d_cvt, d_vit = os.path.join(tmp, "cvt"), os.path.join(tmp, "deit")
        args = ["--arch", "cvt_tiny", "--data_kind", "synthetic",
                "--output_dir", d_cvt, "--epochs", "1"]
        with _EntryRuns([
                ("cvt_tiny train", TRAIN_MODULE,
                 [*args, "--max_steps", str(FAMILY_CLI_STEPS)], None, 0),
                ("deit_small train", TRAIN_MODULE,
                 ["--arch", "deit_small", "--data_kind", "synthetic",
                  "--output_dir", d_vit, "--epochs", "1", "--max_steps",
                  "2"], None, 0)],
                beside="the families' card-vs-CPU parity") as started:
            for name in ("cvt_tiny", "deit_small"):
                _family_parity(torch, C, name, card)
            torch.cuda.empty_cache()
            train_dir = _eval_folder(os.path.join(tmp, "eval_train"),
                                     FAMILY_EVAL_TRAIN, seed=7)
            val_dir = _eval_folder(os.path.join(tmp, "eval_val"),
                                   FAMILY_EVAL_VAL, seed=13)
            (text, rec), deit = started.finish()

        for label, make in (("CvT-T (cvt_tiny)", C.cvt_tiny_multicrop),
                            ("DeiT-S (deit_small)", C.deit_small_multicrop)):
            cfg = make(BATCH, output_dir=os.path.join(tmp, "slice"))
            bn = cfg.model.name == "cvt"
            _slice(torch, cfg, FAMILY_STEPS, counters, label, card, True,
                   check_more=(lambda state, init, label=label:
                               _check_bn_moved(torch, label, state.student
                                               .state_dict(), state.teacher
                                               .state_dict(), init))
                   if bn else None)
            log(f"slice {label}: no launch of the seven kernels in "
                f"{FAMILY_STEPS} steps, as derived")

        _entry_launches("cvt_tiny train", rec["launches"], zero)
        ckpt = os.path.join(d_cvt, "checkpoint.pth")
        tree = _load_tree(torch, ckpt)
        cfg = train_cli.config_from_args(
            train_cli.get_args_parser().parse_args(args))
        init = _initial_weights(torch, cfg)
        if tree["step"] != FAMILY_CLI_STEPS:
            raise AssertionError(f"cvt_tiny CLI: step {tree['step']}")
        _check_bn_moved(torch, "cvt_tiny CLI checkpoint", tree["student"],
                        tree["teacher"], init)
        state = EsViTTrainer(cfg, device="cuda").init_state(
            torch.Generator().manual_seed(1))
        CheckpointManager(d_cvt).restore(state)
        for part in ("student", "teacher"):
            live = getattr(state, part).state_dict()
            for k, v in _bn_buffers(tree[part]).items():
                if not torch.equal(live[k].cpu(), v):
                    raise AssertionError(f"cvt_tiny restore: {part} {k}")
        del state, tree
        torch.cuda.empty_cache()
        logs = [json.loads(x) for x in
                open(os.path.join(d_cvt, "log.txt")).read().splitlines()]
        images = cfg.crops.ncrops * cfg.optim.batch_size_per_device
        log(f"entry cvt_tiny: {FAMILY_CLI_STEPS} steps, loss "
            f"{logs[-1]['train_loss']:.4f}, "
            f"{1e3 * images / logs[-1]['train_img_per_sec']:.1f} ms/step "
            f"from log.txt's img/s (first step included, beside "
            f"deit_small's run and the parity); checkpoint "
            f"{_checkpoint_lines(text)[-1][2]} bytes; every BatchNorm buffer "
            f"of student and teacher restored on the card equal to the "
            f"file's [{card}]")

        text, rec = deit
        _entry_launches("deit_small train", rec["launches"], zero)
        logs = [json.loads(x) for x in
                open(os.path.join(d_vit, "log.txt")).read().splitlines()]
        if (_load_tree(torch, os.path.join(d_vit, "checkpoint.pth"))["step"]
                != 2 or not math.isfinite(logs[-1]["train_loss"])):
            raise AssertionError(f"deit_small CLI: {logs}\n{text[-3000:]}")
        log(f"entry deit_small: 2 steps, loss {logs[-1]['train_loss']:.4f}, "
            f"{1e3 * images / logs[-1]['train_img_per_sec']:.1f} ms/step "
            f"from log.txt's img/s (first step included, beside "
            f"cvt_tiny's run and the parity) [{card}]")

        # The CvT run's resume and the evals' CLIs on a copy of its
        # checkpoint (the resume rewrites checkpoint.pth), at once.
        trained = os.path.join(tmp, "cvt_trained.pth")
        shutil.copyfile(ckpt, trained)
        common = ["--arch", "cvt_tiny", "--pretrained", trained,
                  "--train_path", train_dir, "--val_path", val_dir,
                  "--output_dir", os.path.join(tmp, "eval")]
        images = FAMILY_EVAL_TRAIN + FAMILY_EVAL_VAL
        evals = (("cvt_tiny k-NN", "esvit_tpu_torch.evals.knn",
                  ["--batch_size", str(EVAL_BATCH)],
                  r"^10-NN classifier result: Top1: ([0-9.]+)"),
                 ("cvt_tiny linear probe", "esvit_tpu_torch.evals.linear",
                  ["--batch_size", str(EVAL_BATCH), "--epochs", "10",
                   "--cached_features"],
                  r"^Linear probe: Top1 ([0-9.]+)"))
        (text, rec), *done = _entry_runs([
            ("cvt_tiny resume", TRAIN_MODULE,
             [*args, "--max_steps", str(FAMILY_CLI_STEPS + 1)], None, 0),
            *((label, module, [*common, *extra], None, 0)
              for label, module, extra, _ in evals)])
        _entry_launches("cvt_tiny resume", rec["launches"], zero)
        step = _load_tree(torch, ckpt)["step"]
        if (f"resumed from step {FAMILY_CLI_STEPS}" not in text
                or step != FAMILY_CLI_STEPS + 1):
            raise AssertionError(f"cvt_tiny resume: step {step}:\n"
                                 f"{text[-3000:]}")
        log(f"entry cvt_tiny resume: resumed from step {FAMILY_CLI_STEPS}, "
            f"ended at step {step}")
        for (label, _, _, pattern), (text, rec) in zip(evals, done):
            _entry_launches(label, rec["launches"], zero)
            m = re.search(pattern, text, re.M)
            if m is None or not 0.0 <= float(m.group(1)) <= 100.0:
                raise AssertionError(f"entry {label}: no result:\n"
                                     f"{text[-3000:]}")
            log(f"entry {label} on the CLI run's step-{FAMILY_CLI_STEPS} "
                f"checkpoint: top-1 {float(m.group(1)):.2f}% (16 classes), "
                f"{images} images in {rec['seconds']:.1f} s of main(), "
                f"{images / rec['seconds']:.1f} img/s (the resume and both "
                f"evals at once) [{card}]")


# Phase 14, the training options. Steps of each full-width train() run,
# ResNet-50's LARS and SGD runs, the fp32 parity batch (B, the Swin-T
# step's crops) and its tolerances (relative to each tensor's largest
# |value|), and the API evals' synthetic image counts.
OPT_STEPS = 3
RESNET_LARS_STEPS, RESNET_SGD_STEPS = 5, 3
OPT_PARITY_B = 4
STREAMED_TOL, REMAT_TOL = 1e-4, 1e-6
OPT_EVAL_TRAIN, OPT_EVAL_VAL = 256, 64


def _rel(torch, a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _loss_and_grads(torch, trainer, state, batch, seed, deterministic):
    """One step's loss, new centres and every student gradient (by name),
    without the update: the step's forwards and loss as train_step runs
    them, drop-path from a generator seeded ``seed``."""
    cfg = trainer.cfg
    B = batch[0].shape[0] // 2
    ncrops = 2 + batch[1].shape[0] // B
    streamed = cfg.loss.use_dense_prediction and cfg.loss.streamed
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        t_out = state.teacher((batch[0],), deterministic=True, batch_size=B,
                              bn_train=True, bottleneck_outputs=streamed)
    s_out = state.student(batch, deterministic=deterministic, generator=gen,
                          batch_size=B, bottleneck_outputs=streamed)
    loss, centers = trainer._loss(state, s_out, t_out,
                                  trainer.teacher_temp_fn(0), ncrops, B, None)
    named = dict(state.student.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return (loss.detach(), centers,
            {n: g for n, g in zip(named, grads) if g is not None})


def _parity_batch(torch, C):
    gen = torch.Generator().manual_seed(14)
    c = C.CropConfig()
    return (torch.randn(2 * OPT_PARITY_B, c.global_size, c.global_size, 3,
                        generator=gen).cuda(),
            torch.randn(c.local_crops_number * OPT_PARITY_B, c.local_size,
                        c.local_size, 3, generator=gen).cuda())


def _options_parity(torch, C, label, cfg_a, cfg_b, keep, tol, deterministic,
                    card):
    """fp32 loss, centres and the gradients of the parameters ``keep``
    takes, from one state (seed 0) and batch under cfg_a and cfg_b, within
    ``tol`` of cfg_a's."""
    from esvit_tpu_torch.train.step import EsViTTrainer

    batch = _parity_batch(torch, C)
    out = []
    for cfg in (cfg_a, cfg_b):
        trainer = EsViTTrainer(cfg, device="cuda")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        loss, centers, grads = _loss_and_grads(torch, trainer, state, batch,
                                               1, deterministic)
        out.append((loss, centers, {n: g for n, g in grads.items()
                                    if keep(n)}))
        del trainer, state
        torch.cuda.empty_cache()
    (la, ca, ga), (lb, cb, gb) = out
    if set(ga) != set(gb) or not ga:
        raise AssertionError(f"{label}: gradients of {sorted(set(ga) ^ set(gb))}")
    errs = {"loss": _rel(torch, lb, la),
            "center": max(_rel(torch, b, a) for a, b in zip(ca, cb)),
            "grads": max(_rel(torch, gb[n], ga[n]) for n in ga)}
    if not (math.isfinite(la.item()) and max(errs.values()) <= tol):
        raise AssertionError(f"{label}: {errs} (tol {tol})")
    log(f"options {label}: fp32 B={OPT_PARITY_B} 2x224+8x96, loss "
        f"{la.item():.6f} vs {lb.item():.6f}; rel err loss {errs['loss']:.2e}, "
        f"centres {errs['center']:.2e}, {len(ga)} gradients up to "
        f"{errs['grads']:.2e} (tol {tol}) [{card}]")


def _timed_slice(torch, cfg, steps, counters, label, card, check_state,
                 check_more=None):
    """_slice, then its ms/step over steps 2-N and its peak memory."""
    _, history = _slice(torch, cfg, steps, counters, label, card,
                        check_state, check_more)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.mean(h["seconds"] for h in history[1:]) * 1e3
    return ms, peak


def _with_loss(cfg, **kw):
    return cfg.replace(loss=dataclasses.replace(cfg.loss, **kw))


def _with_optim(cfg, **kw):
    return cfg.replace(optim=dataclasses.replace(cfg.optim, **kw))


def _check_frozen(prefixes):
    def check(state, init):
        held, moved = 0, 0
        for name, p in state.student.named_parameters():
            change = (p.detach().cpu() - init[name]).abs().max().item()
            if name.startswith(prefixes):
                if change != 0:
                    raise AssertionError(f"frozen {name} moved by {change}")
                held += 1
            elif name.startswith(("layers.1.", "layers.2.", "layers.3.",
                                  "head")):
                moved += change > 0
        if not held or not moved:
            raise AssertionError(f"frozen layers: {held} held, {moved} moved")
        log(f"options frozen_layers: {held} student parameters "
            f"bit-identical to their start, {moved} of the later stages' "
            "and the heads' moved")
    return check


def _check_resnet_buffers(label):
    """Every backbone BatchNorm buffer moved in both nets; the heads' in
    the student only (the teacher's head normalises by its running
    statistics, esvit_tpu/models/heads.py:98-100)."""
    def check(state, init):
        s, t = (_bn_buffers(m.state_dict()) for m in (state.student,
                                                      state.teacher))
        head = [k for k in s if k.startswith("head")]
        backbone = [k for k in s if not k.startswith("head")]
        if len(backbone) != 2 * 53 or not head:
            raise AssertionError(f"{label}: buffers {len(backbone)}, "
                                 f"{len(head)}")
        for k in backbone + head:
            i = init[k]
            s_moved = (s[k].cpu() - i).abs().max() > 0
            t_moved = (t[k].cpu() - i).abs().max() > 0
            if not s_moved or t_moved != (k in backbone):
                raise AssertionError(f"{label}: buffer {k} student moved "
                                     f"{bool(s_moved)}, teacher {bool(t_moved)}")
        log(f"{label}: all {len(backbone)} backbone BatchNorm buffers moved "
            f"in the student and in the teacher; the {len(head)} head "
            "buffers in the student only")
    return check


def phase_options(torch, C, counters, card):
    """Phase 14 (see the module docstring)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _options_streamed(torch, C, counters, card, tmp)
        _options_remat(torch, C, counters, card, tmp)
        # (f)'s two CLI runs go beside (c)-(d) and (e).
        d, args, cfg = _options_cli_args(C, tmp)
        with _EntryRuns([("lars cli", TRAIN_MODULE,
                          [*args, "--max_steps", "2"], None, 0)],
                        beside="the dropout and frozen_layers slices"
                        ) as started:
            _options_dropout(torch, C, counters, card, tmp)
            _options_frozen(torch, C, counters, card, tmp)
            (_, rec), = started.finish()
        n = _options_cli_checkpoint(torch, cfg, d, rec)
        with _EntryRuns([("lars cli resume", TRAIN_MODULE,
                          [*args, "--max_steps", "3"], None, 0)],
                        beside="the ResNet-50 part") as started:
            _options_resnet(torch, C, counters, card, tmp)
            (text, rec), = started.finish()
        _options_cli_resume(torch, cfg, d, text, rec, n, card)
    log(f"options phase: {time.perf_counter() - t0:.1f} s")


def _fp32_parity_cfg(torch, C):
    return C.swin_tiny_multicrop(OPT_PARITY_B).replace(dtype=torch.float32)


def _options_streamed(torch, C, counters, card, tmp):
    """(a) The K-streamed loss: fp32 parity with the dense loss, then
    full-width ms/step and peak memory of both on Swin-T and DeiT-S."""
    fp32 = _fp32_parity_cfg(torch, C)
    _options_parity(torch, C, "streamed vs dense loss", fp32,
                    _with_loss(fp32, streamed=True),
                    lambda n: n.startswith("head"), STREAMED_TOL, True, card)
    summary = {}
    for label, make in (("Swin-T", C.swin_tiny_multicrop),
                        ("DeiT-S", C.deit_small_multicrop)):
        for streamed in (False, True):
            cfg = _with_loss(make(BATCH, output_dir=tmp),
                             streamed=streamed)
            name = f"{label} {'streamed' if streamed else 'dense'} loss"
            summary[name] = _timed_slice(torch, cfg, OPT_STEPS, counters,
                                         name, card, False)
    for label in ("Swin-T", "DeiT-S"):
        (dm, dp), (sm, sp) = (summary[f"{label} {k} loss"]
                              for k in ("dense", "streamed"))
        log(f"options {label} B={BATCH} bf16: dense loss {dm:.1f} ms/step, "
            f"peak {dp:.2f} GiB; streamed ({C.LossConfig().stream_chunks} "
            f"chunks) {sm:.1f} ms/step, peak {sp:.2f} GiB [{card}]")
    dense_peak = summary["DeiT-S dense loss"][1]
    if not summary["DeiT-S streamed loss"][1] < dense_peak:
        raise AssertionError(f"DeiT-S streamed peak not below dense: "
                             f"{summary}")


def _options_remat(torch, C, counters, card, tmp):
    """(b) remat='block' against 'none': fp32 parity of every gradient,
    then full-width ms/step and peak memory of both."""
    fp32 = _fp32_parity_cfg(torch, C)
    wa_cfg = fp32.replace(model=C.swin_tiny(fused_block_stages=()))
    _options_parity(torch, C, "remat='block' vs 'none'", wa_cfg,
                    wa_cfg.replace(model=C.swin_tiny(
                        fused_block_stages=(), remat="block")),
                    lambda n: True, REMAT_TOL, False, card)
    for remat in ("none", "block"):
        cfg = C.swin_tiny_multicrop(BATCH, output_dir=tmp).replace(
            model=C.swin_tiny(fused_block_stages=(), remat=remat))
        ms, peak = _timed_slice(torch, cfg, OPT_STEPS, counters,
                                f"Swin-T remat={remat!r}", card, False)
        log(f"options Swin-T fused_block_stages=() remat={remat!r} "
            f"B={BATCH} bf16: {ms:.1f} ms/step, peak {peak:.2f} GiB "
            f"[{card}]")


def _options_dropout(torch, C, counters, card, tmp):
    """(c) Swin-T with backbone dropout: finite losses, launches as
    derived."""
    cfg = C.swin_tiny_multicrop(BATCH, output_dir=tmp).replace(
        model=C.swin_tiny(drop_rate=0.1, attn_drop_rate=0.1))
    got, _ = _slice(torch, cfg, OPT_STEPS, counters,
                    "Swin-T dropout 0.1", card, False)
    log(f"options dropout: launches {got} as derived (any dropout keeps "
        "the fused routes off, attention dropout both window-attention "
        "kernels)")


def _options_frozen(torch, C, counters, card, tmp):
    """(d) frozen_layers: the frozen student parameters bit-identical to
    their start, the rest moved."""
    cfg = _with_optim(C.swin_tiny_multicrop(BATCH, output_dir=tmp),
                      frozen_layers=("patch_embed", "layers_0"))
    _slice(torch, cfg, OPT_STEPS, counters, "Swin-T frozen_layers", card,
           True, _check_frozen(("patch_embed.", "layers.0.")))


def _options_resnet(torch, C, counters, card, tmp):
    """(e) ResNet-50: card against CPU, LARS and SGD runs, the evals
    through the API."""
    import numpy as np

    from esvit_tpu_torch.data.datasets import SyntheticImages
    from esvit_tpu_torch.evals import knn, linear
    from esvit_tpu_torch.models.registry import build_backbone

    zero = {name: {k: 0 for k in kinds}
            for name, (_, kinds) in KERNELS.items()}
    _family_parity(torch, C, "resnet50", card, C.ResNetConfig(depth=50))
    torch.cuda.empty_cache()
    resnet = C.TrainConfig(
        model=C.ResNetConfig(depth=50), head=C.HeadConfig(use_bn=True),
        optim=C.OptimConfig(optimizer="lars",
                            batch_size_per_device=BATCH),
        output_dir=tmp)
    for opt, steps in (("lars", RESNET_LARS_STEPS),
                       ("sgd", RESNET_SGD_STEPS)):
        cfg = _with_optim(resnet, optimizer=opt)
        label = f"ResNet-50 {opt.upper()} BN heads"
        ms, peak = _timed_slice(torch, cfg, steps, counters, label, card,
                                True, _check_resnet_buffers(label))
        log(f"options {label} B={BATCH} 2x224+8x96 bf16: {ms:.1f} "
            f"ms/step over steps 2-{steps}{_beside()}, peak {peak:.2f} GiB, "
            f"no launch of the seven kernels [{card}]")
    backbone = build_backbone(
        C.ResNetConfig(depth=50),
        generator=torch.Generator().manual_seed(0)).cuda()
    train_ds = SyntheticImages(OPT_EVAL_TRAIN, EVAL_SIZE, EVAL_CLASSES, 0)
    val_ds = SyntheticImages(OPT_EVAL_VAL, EVAL_SIZE, EVAL_CLASSES, 1)
    for launches in counters.values():
        for k in launches:
            launches[k] = 0
    res = knn.run_knn_eval(backbone, train_ds, val_ds, ks=(10, 20),
                           batch_size=EVAL_BATCH, dump_dir=tmp,
                           device="cuda")
    f = np.load(os.path.join(tmp, "trainfeat.npy"))
    acc = linear.run_linear_eval(backbone, train_ds, val_ds,
                                 n_last_blocks=4, epochs=5,
                                 feat_batch=EVAL_BATCH,
                                 cached_features=True, device="cuda")
    got = {n: dict(c) for n, c in counters.items()}
    if (f.shape != (OPT_EVAL_TRAIN, 2048) or not np.isfinite(f).all()
            or sorted(res) != [10, 20] or got != zero
            or not all(0 <= a <= 100 for a in acc)):
        raise AssertionError(f"ResNet-50 evals: features {f.shape}, "
                             f"k-NN {res}, probe {acc}, launches {got}")
    log(f"options ResNet-50 evals through the API (random weights, "
        f"{OPT_EVAL_TRAIN} + {OPT_EVAL_VAL} images): k-NN {res}, linear "
        f"probe top1 {acc[0]:.2f} on {linear.feature_dim_for(C.ResNetConfig(), 4)}"
        f"-dim pooled features, no kernel launches [{card}]")
    del backbone
    torch.cuda.empty_cache()


def _options_cli_args(C, tmp):
    """(f) The CLI with LARS, BatchNorm heads and a frozen patch
    embedding: its output directory, arguments and config."""
    from esvit_tpu_torch.train import train as train_cli

    d = os.path.join(tmp, "cli")
    args = [*ENTRY_ARGS, "--optimizer", "lars", "--use_bn_in_head",
            "--frozen_layers", "patch_embed", "--output_dir", d,
            "--epochs", "1"]
    return d, args, train_cli.config_from_args(
        train_cli.get_args_parser().parse_args(args))


def _options_cli_checkpoint(torch, cfg, d, rec):
    """(f) The 2-step run's launches and checkpoint: the patch embedding
    bit-identical to its start, the LARS trace restored on the card bit
    for bit. Returns the trace's values."""
    from esvit_tpu_torch.io.checkpoint import CheckpointManager
    from esvit_tpu_torch.train.step import EsViTTrainer

    _entry_launches("lars cli", rec["launches"], _derived_launches(cfg, 2))
    tree = _load_tree(torch, os.path.join(d, "checkpoint.pth"))
    init = _initial_weights(torch, cfg)
    frozen = [k for k in tree["student"] if k.startswith("patch_embed.")]
    if (tree["optimizer"] != "lars" or tree["step"] != 2 or tree["mu"]
            or not tree["trace"] or not frozen or not all(
                torch.equal(tree["student"][k], init[k]) for k in frozen)):
        raise AssertionError(f"lars cli checkpoint: {tree['optimizer']}, "
                             f"step {tree['step']}")
    state = EsViTTrainer(cfg, device="cuda").init_state(
        torch.Generator().manual_seed(1))
    CheckpointManager(d).restore(state)
    for k, v in tree["trace"].items():
        if not torch.equal(state.trace[k].cpu(), v):
            raise AssertionError(f"lars cli restore: trace {k}")
    del state
    torch.cuda.empty_cache()
    return sum(v.numel() for v in tree["trace"].values())


def _options_cli_resume(torch, cfg, d, text, rec, n, card):
    """(f) The resume for a third step."""
    _entry_launches("lars cli resume", rec["launches"],
                    _derived_launches(cfg, 1))
    if ("resumed from step 2" not in text
            or _load_tree(torch, os.path.join(d, "checkpoint.pth"))["step"]
            != 3):
        raise AssertionError(f"lars cli resume:\n{text[-3000:]}")
    log(f"options CLI --optimizer lars --use_bn_in_head --frozen_layers "
        f"patch_embed: 2 steps, the patch embedding bit-identical to its "
        f"start, the LARS trace ({n} values) restored on the card equal "
        f"to the file's, resumed from step 2 to 3 [{card}]")


# Phase 15, the rest of ViL: the schedule leg's steps (the switch at half
# of them), the other legs' steps (2: the whole script has run past 830
# s, so each leg times its second step only), leg (c)'s arch (ViL-T with
# relative position bias on its two sparse stages; full attention's rpe
# takes the native grid only) and its card-vs-CPU tolerance, as
# phase_vil_forward_parity's.
VIL_SWITCH_STEPS, VIL_LEG_STEPS = 8, 2
VIL_RPE_ARCH = ("l1,h1,d48,n1,s1,g1,p4,f7,a0_l2,h3,d96,n1,s1,g1,p2,f7,a0_"
                "l3,h3,d192,n9,s0,g1,p2,f7_l4,h6,d384,n1,s0,g0,p2,f7")
VIL_PARITY_TOL = 1e-4


class _StepRecorder:
    """EsViTTrainer.train_step wrapped while it is entered: each step's
    (mode, teacher_mode), the launches of every kernel in it, and the peak
    device memory since the last reset, which it makes before step 0 and
    before step ``split``."""

    def __init__(self, torch, counters, split):
        self.torch, self.counters, self.split = torch, counters, split
        self.steps = []

    def __enter__(self):
        from esvit_tpu_torch.train import step as step_lib

        self.cls, self.real = step_lib.EsViTTrainer, \
            step_lib.EsViTTrainer.train_step
        rec = self

        def train_step(trainer, state, batch, *a, **kw):
            if len(rec.steps) in (0, rec.split):
                rec.torch.cuda.reset_peak_memory_stats()
            before = {n: dict(c) for n, c in rec.counters.items()}
            out = rec.real(trainer, state, batch, *a, **kw)
            rec.steps.append({
                "modes": (kw.get("mode", 0), kw.get("teacher_mode", 0)),
                "launches": {n: {k: c[k] - before[n][k] for k in c}
                             for n, c in rec.counters.items()},
                "peak": rec.torch.cuda.max_memory_allocated() / 2**30})
            return out
        self.cls.train_step = train_step
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.real


def _vil_leg(torch, C, cfg, steps, counters, label, card):
    """train() for ``steps`` steps through _slice (launches as derived
    from each step's modes, state moved); its ms/step over steps 2-N and
    peak GiB printed, and no sliding-chunk launch."""
    ms, peak = _timed_slice(torch, cfg, steps, counters, label, card, True)
    if any(counters["sliding_chunk"].values()):
        raise AssertionError(f"{label}: sliding-chunk launches "
                             f"{counters['sliding_chunk']}")
    log(f"vil {label} B={BATCH} bf16: {ms:.1f} ms/step over steps "
        f"2-{steps}{_beside()}, peak {peak:.2f} GiB, no sliding-chunk "
        f"launch [{card}]")


def phase_vil_options(torch, C, counters, card):
    """Phase 15 (see the module docstring)."""
    t0 = time.perf_counter()
    base = _with_optim(C.vil_tiny_multicrop(BATCH), epochs=1).replace(
        steps_per_epoch=VIL_SWITCH_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = _vil_schedule_leg(torch, C, base.replace(output_dir=tmp),
                                 counters, card)
        legs = (
            ("per-layer draws", base.replace(model=C.vil_tiny(
                mode=1, per_layer_mode=True))),
            ("rpe", base.replace(model=C.vil_from_arch(VIL_RPE_ARCH))),
            ("performer", base.replace(model=C.vil_tiny(
                attn_type="performer"))),
            ("srformer", base.replace(model=C.vil_tiny(
                attn_type="srformer"))),
            # esvit_tpu's Linformer fixes the sequence length at the 224 px
            # grid: it cannot run the 96 px crops either.
            ("linformer, no local crops", base.replace(
                model=C.vil_tiny(attn_type="linformer"),
                crops=dataclasses.replace(base.crops, local_crops_number=0))),
        )
        d = os.path.join(tmp, "legs")
        # (e)'s CLIs on leg (a)'s checkpoint go beside legs (b)-(d).
        evals, runs, want, images = _vil_evals(torch, C, ckpt, tmp)
        with _EntryRuns(runs, beside="the ViL legs") as started:
            for label, cfg in legs:
                if label == "rpe":
                    _vil_rpe_parity(torch, C, card)
                _vil_leg(torch, C, cfg.replace(output_dir=d), VIL_LEG_STEPS,
                         counters, label, card)
            done = started.finish()
        for (label, _, _, pattern), (text, rec) in zip(evals, done):
            _entry_launches(label, rec["launches"], want)
            m = re.search(pattern, text, re.M)
            if m is None or not 0.0 <= float(m.group(1)) <= 100.0:
                raise AssertionError(f"entry {label}: no result:\n"
                                     f"{text[-3000:]}")
            log(f"entry {label} on the schedule leg's checkpoint: top-1 "
                f"{float(m.group(1)):.2f}% (16 classes), {images} images in "
                f"{rec['seconds']:.1f} s of main() (both evals at once, "
                f"beside the ViL legs) [{card}]")
    log(f"vil options phase: {time.perf_counter() - t0:.1f} s")


def _vil_schedule_leg(torch, C, base, counters, card):
    """(a) vil_tiny(mode=1, mode_switch=0.5) for VIL_SWITCH_STEPS steps of
    one epoch: the first half samples a neighbour per net and launches no
    sliding-chunk kernel, the second launches what the mode-0 step does;
    ms/step and peak of each half. Returns the run's checkpoint."""
    cfg = base.replace(model=C.vil_tiny(mode=1, mode_switch=0.5))
    half = VIL_SWITCH_STEPS // 2
    with _StepRecorder(torch, counters, half) as rec:
        _, history = _slice(torch, cfg, VIL_SWITCH_STEPS, counters,
                            "ViL-T mode 1 switching at step 4", card, True,
                            write_checkpoint=True)
    mode0 = _derived_launches(cfg, 1)["sliding_chunk"]
    for i, step in enumerate(rec.steps):
        sampled = i < half
        want = {"fwd": 0, "bwd": 0} if sampled else mode0
        if (step["launches"]["sliding_chunk"] != want
                or (step["modes"] == (0, 0)) == sampled):
            raise AssertionError(f"vil schedule step {i}: {step}, want "
                                 f"sliding chunk {want}")
    ms = [1e3 * h["seconds"] for h in history]
    before, after = (statistics.mean(ms[1:half]),
                     statistics.mean(ms[half:]))
    log(f"vil schedule: modes {[s['modes'] for s in rec.steps]}; steps "
        f"0-{half - 1} no sliding-chunk launch, steps {half}-"
        f"{VIL_SWITCH_STEPS - 1} {mode0} each as the mode-0 step")
    log(f"vil schedule B={BATCH} bf16: sampled mode {before:.1f} ms/step "
        f"(steps 1-{half - 1}), peak {rec.steps[half - 1]['peak']:.2f} GiB; "
        f"mode 0 {after:.1f} ms/step (steps {half}-{VIL_SWITCH_STEPS - 1}), "
        f"peak {rec.steps[-1]['peak']:.2f} GiB; per step "
        f"{[round(x, 1) for x in ms]} ms [{card}]")
    return os.path.join(base.output_dir, "checkpoint.pth")


def _vil_rpe_parity(torch, C, card):
    """(c) The rpe model's fp32 forward_features on the card (TF32 off)
    against the CPU, same weights, 2 images at 224 and 96 px."""
    import copy

    from esvit_tpu_torch.models.vil import MsViT

    cpu = MsViT(C.vil_from_arch(VIL_RPE_ARCH),
                generator=torch.Generator().manual_seed(0))
    dev = copy.deepcopy(cpu).cuda()
    for size in (224, 96):
        x = torch.randn(2, size, size, 3,
                        generator=torch.Generator().manual_seed(size))
        with torch.no_grad():
            want = cpu.forward_features(x)
            got = dev.forward_features(x.cuda())
        errs = [_rel(torch, a.cpu(), b) for a, b in zip(got, want)]
        if max(errs) > VIL_PARITY_TOL or not all(
                torch.isfinite(a).all() for a in got):
            raise AssertionError(f"vil rpe {size}px: card vs CPU {errs}")
        log(f"vil rpe forward_features fp32 2x{size}px: card vs CPU rel "
            f"err cls {errs[0]:.2e}, region {errs[1]:.2e} (tol "
            f"{VIL_PARITY_TOL}) [{card}]")
    del dev


def _vil_evals(torch, C, ckpt, tmp):
    """(e) The k-NN and linear-probe CLIs on the schedule leg's
    checkpoint: fp32 forwards at 224 px, each batch launching the
    sliding-chunk forward once per kernel-route layer. Writes their
    PNGs; returns (evals, their _EntryRuns runs, the launches each must
    show, the images each reads)."""
    from esvit_tpu_torch.models.vil import MsViT

    train_dir = _eval_folder(os.path.join(tmp, "eval_train"),
                             FAMILY_EVAL_TRAIN, seed=7)
    val_dir = _eval_folder(os.path.join(tmp, "eval_val"), FAMILY_EVAL_VAL,
                           seed=13)
    batches = (-(-FAMILY_EVAL_TRAIN // EVAL_BATCH)
               + -(-FAMILY_EVAL_VAL // EVAL_BATCH))
    want = {name: {k: 0 for k in kinds}
            for name, (_, kinds) in KERNELS.items()}
    want["sliding_chunk"]["fwd"] = batches * MsViT(
        C.vil_tiny()).sliding_chunk_calls(224)
    common = ["--arch", "vil_tiny", "--pretrained", ckpt, "--train_path",
              train_dir, "--val_path", val_dir, "--output_dir",
              os.path.join(tmp, "eval")]
    images = FAMILY_EVAL_TRAIN + FAMILY_EVAL_VAL
    evals = (("vil_tiny k-NN", "esvit_tpu_torch.evals.knn",
              ["--batch_size", str(EVAL_BATCH)],
              r"^10-NN classifier result: Top1: ([0-9.]+)"),
             ("vil_tiny linear probe", "esvit_tpu_torch.evals.linear",
              ["--batch_size", str(EVAL_BATCH), "--epochs", "10",
               "--cached_features"],
              r"^Linear probe: Top1 ([0-9.]+)"))
    runs = [(label, module, [*common, *extra], None, 0)
            for label, module, extra, _ in evals]
    return evals, runs, want, images


# Phase 16, the last modules: the analysis CLI on a folder of PNGs in two
# classes, the auxiliary modules at published widths (DeiT-S's block: dim
# 384, 6 heads, 14x14 + CLS; T2T-ViT-14's T2T module: embed 384,
# token_dim 64, 224 px; ResNet-50's stage-2 map: 28x28x512), timed over
# reps of forward + backward.
LAST_IMAGES, LAST_TOL = 16, 1e-4
LAST_PARITY_IMAGES = 4
AUX_B, AUX_GRID, AUX_DIM, AUX_HEADS = 64, 14, 384, 6
T2T_B, CNN_B, CNN_HW, CNN_C = 32, 64, 28, 512
AUX_REPS = 5
ANALYSIS_MODULE = "esvit_tpu_torch.analysis.cli"


# The BASELINE runbook (phase 16's (d)): ``python -m
# esvit_tpu_torch.reproduce_baseline`` with the gate on, on a
# reference-layout .pth of the port's Swin-T init (seed 0) over PNG
# folders of noise in 4 classes (so k-NN sits near chance, far under the
# published 75.7), beside the k-NN CLI on the same files at the runbook's
# batch size and k.
RUNBOOK_MODULE = "esvit_tpu_torch.reproduce_baseline"
RUNBOOK_TRAIN, RUNBOOK_VAL, RUNBOOK_CLASSES, RUNBOOK_SIZE = 256, 64, 4, 128
RUNBOOK_BATCH, RUNBOOK_EPOCHS, RUNBOOK_KS = 128, 2, (10, 20)
RUNBOOK_FEAT_BATCH = 64     # evals/linear.py run_linear_eval's feat_batch


def phase_last_modules(torch, C, counters, card):
    """Phase 16 (see the module docstring)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runbook, runs = _runbook_runs(torch, C, tmp)
        done = _last_analysis(torch, C, counters, card, tmp, runs)
        _runbook_check(runbook, done, card)
    _last_aux(torch, card)
    _last_flops(torch, C, card)
    log(f"last modules phase: {time.perf_counter() - t0:.1f} s [{card}]")


def _last_folder(root):
    """LAST_IMAGES procedural 256 px PNGs (seed 16) in two classes."""
    from esvit_tpu_torch.data.datasets import ProceduralShapesHard

    ds = ProceduralShapesHard(n=LAST_IMAGES, size=256, seed=16)
    for i in range(LAST_IMAGES):
        d = os.path.join(root, f"class{i % 2}")
        os.makedirs(d, exist_ok=True)
        ds[i][0].save(os.path.join(d, f"{i:02d}.png"))
    return root


def _launch_want(fused=0, wa=0, sc=0, pwa=0):
    want = {name: {k: 0 for k in kinds}
            for name, (_, kinds) in KERNELS.items()}
    want["fused_block"]["fwd"] = fused
    want["window_attention"]["fwd"] = wa
    want["sliding_chunk"]["fwd"] = sc
    want["pallas_window_attention"]["fwd"] = pwa
    return want


def _runbook_runs(torch, C, tmp):
    """(d) Writes the runbook's .pth and PNG folders; returns (what
    _runbook_check needs, the two _EntryRuns runs: the runbook, exit 1,
    and the k-NN CLI)."""
    import numpy as np
    from PIL import Image

    from esvit_tpu_torch.models.registry import build_backbone

    dirs = {}
    rng = np.random.default_rng(0)
    for split, n in (("train", RUNBOOK_TRAIN), ("val", RUNBOOK_VAL)):
        dirs[split] = os.path.join(tmp, "runbook_data", split)
        for i in range(n):
            d = os.path.join(dirs[split], f"class{i % RUNBOOK_CLASSES}")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(rng.integers(
                0, 256, (RUNBOOK_SIZE, RUNBOOK_SIZE, 3), dtype=np.uint8)
            ).save(os.path.join(d, f"{i:04d}.png"))
    model = build_backbone(C.get_model_config("swin_tiny"),
                           generator=torch.Generator().manual_seed(0))
    pth = os.path.join(tmp, "runbook_swin_tiny.pth")
    torch.save({"teacher": {f"module.{k}": v
                            for k, v in model.state_dict().items()}}, pth)
    # Model-derived launches: k-NN's forward_features over the train and
    # val batches; the probe's 4-last-block capture forwards over the val
    # features' batches and each epoch's whole train batches.
    knn = -(-RUNBOOK_TRAIN // RUNBOOK_BATCH) + -(-RUNBOOK_VAL // RUNBOOK_BATCH)
    probe = (-(-RUNBOOK_VAL // RUNBOOK_FEAT_BATCH)
             + RUNBOOK_EPOCHS * (RUNBOOK_TRAIN // RUNBOOK_BATCH))
    knn_want = _launch_want(
        knn * model.fused_block_calls(224),
        knn * model.window_attention_calls(224),
        pwa=knn * model.pallas_window_attention_calls(224))
    runbook_want = _launch_want(
        knn * model.fused_block_calls(224),
        knn * model.window_attention_calls(224)
        + probe * model.window_attention_calls(224, capture=True),
        pwa=knn * model.pallas_window_attention_calls(224)
        + probe * model.pallas_window_attention_calls(224, capture=True))
    outs = {k: os.path.join(tmp, f"runbook_{k}") for k in ("gate", "knn")}
    data = ["--train_path", dirs["train"], "--val_path", dirs["val"],
            "--batch_size", str(RUNBOOK_BATCH), "--nb_knn",
            *map(str, RUNBOOK_KS)]
    runs = [("runbook swin_tiny", RUNBOOK_MODULE,
             ["--pth", pth, "--arch", "swin_tiny", "--linear_epochs",
              str(RUNBOOK_EPOCHS), *data, "--output_dir", outs["gate"]],
             None, 1),
            ("runbook's k-NN CLI", "esvit_tpu_torch.evals.knn",
             ["--arch", "swin_tiny", "--pretrained", pth, *data,
              "--output_dir", outs["knn"]], None, 0)]
    return (outs, runbook_want, knn_want), runs


def _runbook_check(runbook, done, card):
    """(d) The runbook failed its gate (exit 1, FAIL, gate_pass false) with
    the k-NN CLI's top-1 at every k, each run's launches as derived."""
    outs, runbook_want, knn_want = runbook
    (text, rec), (knn_text, knn_rec) = done
    _entry_launches("runbook swin_tiny", rec["launches"], runbook_want)
    _entry_launches("runbook's k-NN CLI", knn_rec["launches"], knn_want)
    with open(os.path.join(outs["gate"], "baseline_report.json")) as f:
        report = json.load(f)
    stages = re.findall(r"^\[(\d)/4\]", text, re.M)
    if (stages != ["1", "2", "3", "4"] or "-> FAIL" not in text
            or report.get("gate_pass") is not False
            or report["gate"] != [75.7, 78.0]
            or not 0.0 <= report["best_knn_top1"] < 75.7 - 0.3
            or report["linear_top1"] is None):
        raise AssertionError(f"runbook: report {report}:\n{text[-3000:]}")
    cli = {int(k): float(v) for k, v in re.findall(
        r"^(\d+)-NN classifier result: Top1: ([0-9.]+)", knn_text, re.M)}
    got = {int(k): round(v[0], 2) for k, v in report["knn"].items()}
    if set(cli) != set(RUNBOOK_KS) or any(
            got[k] != cli[k] for k in RUNBOOK_KS):
        raise AssertionError(f"runbook k-NN {got} differs from the k-NN "
                             f"CLI's {cli}")
    log(f"runbook swin_tiny (random Swin-T W=7, fp32, 224 px, "
        f"{RUNBOOK_TRAIN} + {RUNBOOK_VAL} noise PNGs in "
        f"{RUNBOOK_CLASSES} classes): exit 1, gate FAIL as it must be: "
        f"k-NN top-1 {report['best_knn_top1']:.2f} against 75.7 - 0.3, "
        f"linear top-1 {report['linear_top1']:.2f}; k-NN "
        + ", ".join(f"{k}: {got[k]:.2f}" for k in RUNBOOK_KS)
        + f" equal to the k-NN CLI's; {rec['seconds']:.1f} s of main() "
        f"(the phase's runs at once) [{card}]")


def _last_analysis(torch, C, counters, card, tmp, extra=()):
    """(a) The analysis CLI in subprocesses on a reference-layout .pth of a
    seeded Swin-T (and a seeded random ViL-T), each run's launches of rows
    1, 3 and 5 as derived from the model; then in-process on the same
    weights, fp32 attention maps and flip features, card against CPU.
    The ``extra`` _EntryRuns runs go at once with the analysis runs;
    returns their (output, record)."""
    import copy
    import importlib.util

    import numpy as np

    from esvit_tpu_torch.analysis import attention as attn_lib
    from esvit_tpu_torch.analysis import correspondence as corr_lib
    from esvit_tpu_torch.data import datasets as datasets_lib
    from esvit_tpu_torch.evals.knn import eval_transform
    from esvit_tpu_torch.io.torch_checkpoint import load_backbone_checkpoint
    from esvit_tpu_torch.models.swin import SwinTransformer
    from esvit_tpu_torch.models.vil import MsViT

    data = _last_folder(os.path.join(tmp, "imgs"))
    src = SwinTransformer(C.swin_tiny(),
                          generator=torch.Generator().manual_seed(16))
    ckpt = os.path.join(tmp, "swin_tiny.pth")
    torch.save({"teacher": {f"module.{k}": v
                            for k, v in src.state_dict().items()}}, ckpt)
    # Model-derived launches per forward at 224 px: forward_features; the
    # last block's maps (n=1) run the stages before the last on their
    # routes and the last on the plain capture path; every block's maps
    # (n=2) are all on the capture path, no kernel.
    fused, wa = src.fused_block_calls(224), src.window_attention_calls(224)
    wa_maps = wa - src.window_attention_calls(224,
                                              from_stage=len(src.layers) - 1)
    sc = MsViT(C.vil_tiny()).sliding_chunk_calls(224)
    log(f"last modules: model-derived launches per 224 px forward: Swin-T "
        f"fused block {fused}, window attention {wa} ({wa_maps} for the "
        f"last block's maps); ViL-T sliding chunk {sc} [{card}]")
    swin = ["--arch", "swin_tiny", "--window_size", "7", "--pretrained", ckpt]
    runs = [("swin_tiny measure_entropy", "measure_entropy", swin,
             _launch_want()),
            ("swin_tiny measure_correspondence", "measure_correspondence",
             swin, _launch_want(2 * fused, 2 * wa)),
            ("vil_tiny measure_correspondence", "measure_correspondence",
             ["--arch", "vil_tiny"], _launch_want(sc=2 * sc))]
    if importlib.util.find_spec("matplotlib") is None:
        log("last modules: vis_attention skipped: matplotlib does not "
            "import on this machine")
    else:
        runs.append(("swin_tiny vis_attention (2 images)", "vis_attention",
                     swin + ["--num_images", "2"],
                     _launch_want(2 * fused, 2 * wa_maps)))
    outs = [os.path.join(tmp, label.replace(" ", "_"))
            for label, _, _, _ in runs]
    # The runs go beside the in-process card-vs-CPU checks.
    with _EntryRuns([
            (label, ANALYSIS_MODULE, [
                command, "--data_path", data, "--num_images",
                str(LAST_IMAGES), *args, "--output_dir", out, "--device",
                "cuda"], None, 0)
            for (label, command, args, _), out in zip(runs, outs)]
            + list(extra),
            beside="the in-process card-vs-CPU checks") as started:
        ds = datasets_lib.build_dataset("folder", root=data)
        x = np.stack([eval_transform(ds[i][0], 224)
                      for i in range(LAST_PARITY_IMAGES)])
        cpu = load_backbone_checkpoint(SwinTransformer(C.swin_tiny()), ckpt)
        vil_cpu = MsViT(C.vil_tiny(),
                        generator=torch.Generator().manual_seed(0))
        dev = copy.deepcopy(cpu).cuda()
        vil_dev = copy.deepcopy(vil_cpu).cuda()
        for c in counters.values():
            for k in c:
                c[k] = 0
        got = {"maps": attn_lib.attention_maps(dev,
                                               torch.from_numpy(x).cuda()),
               "swin flip features": corr_lib.flip_features(dev, x),
               "vil flip features": corr_lib.flip_features(vil_dev, x)}
        launches = {n: dict(c) for n, c in counters.items()}
        want = _launch_want(fused + 2 * fused, wa_maps + 2 * wa, 2 * sc)
        if launches != want:
            raise AssertionError(f"last modules in-process: launches "
                                 f"{launches}, model-derived {want}")
        ref = {"maps": attn_lib.attention_maps(cpu, torch.from_numpy(x)),
               "swin flip features": corr_lib.flip_features(cpu, x),
               "vil flip features": corr_lib.flip_features(vil_cpu, x)}
        for what, g in got.items():
            pairs = (zip(g, ref[what]) if isinstance(g, tuple)
                     else [(g.cpu().numpy(), ref[what].numpy())])
            errs = [float(np.abs(a - b).max() / np.abs(b).max())
                    for a, b in pairs]
            if not max(errs) <= LAST_TOL:
                raise AssertionError(f"last modules {what}: card vs CPU "
                                     f"{errs}")
            log(f"last modules {what} fp32 {LAST_PARITY_IMAGES}x224px: card "
                f"vs CPU rel err {', '.join(f'{e:.2e}' for e in errs)} (tol "
                f"{LAST_TOL}) [{card}]")
        log(f"last modules in-process: launches fused block "
            f"{launches['fused_block']['fwd']}, window attention "
            f"{launches['window_attention']['fwd']}, sliding chunk "
            f"{launches['sliding_chunk']['fwd']}, as derived from the "
            f"models [{card}]")
        del dev, vil_dev
        done = started.finish()
    for (label, command, args, want), out, (text, rec) in zip(runs, outs,
                                                              done):
        _entry_launches(label, rec["launches"], want)
        if command == "vis_attention":
            pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
            if len(pngs) != 2:
                raise AssertionError(f"{label}: wrote {pngs}")
            log(f"last modules {label}: ran, wrote {pngs} in "
                f"{rec['seconds']:.1f} s of main(), the runs at once "
                f"[{card}]")
            continue
        with open(os.path.join(out, "log.txt")) as f:
            record = json.loads(f.read().splitlines()[-1])
        values = [v for vs in record.values()
                  for v in (vs if isinstance(vs, list) else [vs])]
        if not values or not all(math.isfinite(v) for v in values) or not (
                0.0 <= record.get("correspondence_acc", 0.0) <= 100.0):
            raise AssertionError(f"{label}: log.txt record {record}")
        log(f"last modules {label}: {json.dumps(record)} over {LAST_IMAGES} "
            f"images in {rec['seconds']:.1f} s of main(), the runs at once "
            f"[{card}]")
    return done[len(runs):]


def _aux_cases(torch):
    """(label, build(dtype, generator), input shape) of each module."""
    from esvit_tpu_torch.models import aux_attention as A
    from esvit_tpu_torch.models import cnn_extras as X
    from esvit_tpu_torch.models import t2t as T

    D, nH = AUX_DIM, AUX_HEADS
    tok = (AUX_B, 1 + AUX_GRID * AUX_GRID, D)
    cnn = (CNN_B, CNN_HW, CNN_HW, CNN_C)

    def conv_qkv(method):
        return lambda dt, g: A.ConvQKVAttention(
            D, num_heads=nH, use_qkvconv=True, method=method, dtype=dt,
            generator=g)
    return [
        ("AxialAttention", lambda dt, g: A.AxialAttention(
            D, nH, dtype=dt, generator=g), tok),
        ("CrissCrossAttention", lambda dt, g: A.CrissCrossAttention(
            D, nH, dtype=dt, generator=g), tok),
        ("ConvQKVAttention conv", conv_qkv("conv"), tok),
        ("ConvQKVAttention dw_bn_glu_pw", conv_qkv("dw_bn_glu_pw"), tok),
        ("ConvQKVAttention pw_glu_conv_bn_swish_pw",
         conv_qkv("pw_glu_conv_bn_swish_pw"), tok),
        ("DownAttention stride 2", lambda dt, g: A.DownAttention(
            D, num_heads=nH, stride=2, dtype=dt, generator=g), tok),
        ("CrossScaleAttention stride 2", lambda dt, g: A.CrossScaleAttention(
            D, num_heads=nH, stride=2, dtype=dt, generator=g), tok),
        ("T2TModule", lambda dt, g: T.T2TModule(
            embed_dim=384, token_dim=64, dtype=dt, generator=g),
         (T2T_B, 224, 224, 3)),
        ("SELayer2D", lambda dt, g: X.SELayer2D(CNN_C, dtype=dt,
                                                generator=g), cnn),
        ("DyReLU2", lambda dt, g: X.DyReLU2(CNN_C, dtype=dt, generator=g),
         cnn),
        ("FrozenBatchNorm", lambda dt, g: X.FrozenBatchNorm(CNN_C, dtype=dt),
         cnn),
        ("DropBlock block 7", lambda dt, g: X.DropBlock(7, 0.9), cnn),
    ]


def _randomise_buffers(torch, module, gen):
    """BatchNorm / FrozenBatchNorm statistics and the frozen affine away
    from their init, so the card's normalisation is held too."""
    with torch.no_grad():
        for name, b in module.named_buffers():
            if name.endswith(("running_var", "weight")):
                b.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith(("running_mean", "bias")):
                b.normal_(0.0, 0.5, generator=gen)


def _aux_weights(torch, out):
    """The fixed fp32 weights (seed 17, drawn on the CPU) of the loss
    sum(out * w)."""
    return torch.randn(out.shape, generator=torch.Generator().manual_seed(
        17)).to(out.device)


def _aux_step(torch, module, x, u=None, gen=None, w=None):
    """Forward + backward of sum(out * w), ``w`` from ``_aux_weights`` if
    not given: (output, [x grad, parameter grads...]). DropBlock runs on
    the CPU through its mask on the given uniform field ``u``, and on the
    card through its own forward with the card generator ``gen``, which
    draws that same field."""
    from esvit_tpu_torch.models.cnn_extras import dropblock_mask

    module.zero_grad(set_to_none=True)
    x = x.detach().requires_grad_(True)
    if u is not None:
        out = module.apply_mask(x, dropblock_mask(
            u, *module.gamma(x.shape[2], 1.0)))
    elif gen is not None:
        out = module(x, deterministic=False, generator=gen)
    else:
        out = module(x)
    out = out[0] if isinstance(out, tuple) else out
    w = _aux_weights(torch, out) if w is None else w
    (out.float() * w).sum().backward()
    return out, [x.grad] + [p.grad for p in module.parameters()]


def _last_aux(torch, card):
    """(b) Each module forward + backward on the card: fp32 output and
    gradients against the CPU, bf16 finite, median ms and peak GiB. The
    timed step is the compared one."""
    import copy

    for label, build, shape in _aux_cases(torch):
        gen = torch.Generator().manual_seed(16)
        cpu = build(torch.float32, gen)
        _randomise_buffers(torch, cpu, gen)
        dev = copy.deepcopy(cpu).cuda()
        x = torch.randn(shape, generator=gen)
        xd = x.cuda()
        drop = label.startswith("DropBlock")

        def card_gen():
            """DropBlock's generator on the card, from its seed each
            time, so every step draws the field the CPU was given."""
            return (torch.Generator(device="cuda").manual_seed(16) if drop
                    else None)
        u = (torch.rand(shape, generator=card_gen(), device="cuda").cpu()
             if drop else None)
        out_cpu, g_cpu = _aux_step(torch, cpu, x, u)
        out, grads = _aux_step(torch, dev, xd, gen=card_gen())
        errs = [((a.cpu() - b).abs().max() / b.abs().max()).item()
                for a, b in zip([out] + grads, [out_cpu] + g_cpu)]
        if not errs or not max(errs) <= LAST_TOL or not all(
                torch.isfinite(t).all() for t in [out] + grads):
            raise AssertionError(f"last modules {label}: card vs CPU {errs}")
        wd = _aux_weights(torch, out)
        _aux_step(torch, dev, xd, gen=card_gen(), w=wd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(AUX_REPS):
            g = card_gen()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            _aux_step(torch, dev, xd, gen=g, w=wd)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated() / 2**30
        bf = build(torch.bfloat16, torch.Generator().manual_seed(16)).cuda()
        out_bf, g_bf = _aux_step(torch, bf, xd.bfloat16(), gen=card_gen())
        if not all(torch.isfinite(t).all() for t in [out_bf] + g_bf):
            raise AssertionError(f"last modules {label}: bf16 not finite")
        log(f"last modules {label} {tuple(shape)}: fp32 card vs CPU rel err "
            f"output {errs[0]:.2e}, gradients up to {max(errs[1:]):.2e} "
            f"({len(errs) - 1}; tol {LAST_TOL}); bf16 finite; forward + "
            f"backward fp32 median {statistics.median(ms):.2f} ms of "
            f"{AUX_REPS}, peak {peak:.2f} GiB [{card}]")
        del dev, bf


def _last_flops(torch, C, card):
    """(c) utils/flops.summarize of Swin-T, ViL-T and DeiT-S at 224 px
    (counted on the CPU's plain route: the kernels are not aten ops)."""
    from esvit_tpu_torch.models.registry import build_backbone
    from esvit_tpu_torch.utils import flops

    for name in ("swin_tiny", "vil_tiny", "deit_small"):
        log(f"last modules flops {name}: "
            f"{flops.summarize(build_backbone(C.get_model_config(name)))} "
            f"(products counted on the CPU) [{card}]")


# Phase 19: the DINO head's tensor parallelism, two model ranks on one
# card, on the recipe with no warm-up and the last layer free from step 1,
# so that step 1 moves every parameter, the heads' rows included (only the
# pinned weight_g stay). The tolerances: the losses within TP_LOSS_RTOL of
# one process's; after step 1 every parameter within esvit_tpu's bf16
# sharded-step tolerance (tests/test_train_step.py:123-130) and the
# centers within its centre tolerance; after step 1 and after TP_STEPS,
# the student's and the teacher's change from the initial state, and each
# parameter's AdamW moments (its gradient's traces), within TP_STATE_RTOL
# of their own norms. Two planted faults must fail them. The learning
# rate is TP_LR: AdamW's first step is lr sign(g), so an entry whose
# gradient is under the bf16 noise steps either way on the two grids, 2 lr
# apart, which TP_ATOL holds at this lr (any other difference is at most
# lr: TP_ATOL cannot see a wrong step; the relative gates can).
TP_STEPS = 3
TP_LOSS_RTOL = 1e-3
TP_RTOL, TP_ATOL = 2e-4, 1e-4
TP_CENTER_RTOL, TP_CENTER_ATOL = 1e-5, 1e-7
TP_STATE_RTOL = 0.1
TP_LR = 3.2e-5
TP_TIMEOUT = 600
# The planted faults: 'summing_backward', the model group's sum with the
# summing backward of torch.distributed.nn (every rank gets model times
# its gradient); 'unsummed', the replicated gradients left unsummed over
# the model group (each rank keeps its rows' share).
TP_PLANTS = ("summing_backward", "unsummed")


def _tp_cfg(C, out_dir, model):
    """The Swin-T W=7 B=32 multi-crop recipe (2x224 + 8x96, 65536-wide
    heads, DDINO, bf16, the default block-fused route, seed 0) on a
    (data=1, model) grid, at one step an epoch, with no warm-up and the
    last layer free: TP_LR from step 1."""
    cfg = C.swin_tiny_multicrop(
        BATCH, output_dir=out_dir, save_every_epochs=0,
        mesh=C.MeshConfig(model=model)).replace(steps_per_epoch=1)
    return cfg.replace(optim=dataclasses.replace(
        cfg.optim, lr=TP_LR * 256 / BATCH, warmup_epochs=0,
        freeze_last_layer_epochs=0))


def _tp_runs(torch, cfg, barrier):
    """train() for one step, then resumed from its checkpoint (restored at
    the grid) to TP_STEPS: the losses, the resumed run's host seconds per
    step, the hash of each rank's replicated tensors after each run, and
    the whole checkpoint after step 1 kept as step1.pth."""
    import hashlib

    from esvit_tpu_torch.parallel.mesh import is_head_shard
    from esvit_tpu_torch.train.train import train

    def replicas(state):
        h = hashlib.sha256()
        for net in (state.student, state.teacher):
            for k, v in net.state_dict().items():
                if not is_head_shard(k):
                    h.update(v.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    state, first = train(cfg, max_steps=1, device="cuda", resume=False)
    hashes = [replicas(state)]
    del state
    barrier()                       # rank 0 has written checkpoint.pth
    ckpt = os.path.join(cfg.output_dir, "checkpoint.pth")
    if not torch.distributed.is_initialized() or \
            torch.distributed.get_rank() == 0:
        shutil.copyfile(ckpt, os.path.join(cfg.output_dir, "step1.pth"))
    state, rest = train(cfg, max_steps=TP_STEPS, device="cuda", resume=True)
    hashes.append(replicas(state))
    del state
    torch.cuda.synchronize()
    return {"losses": [h["loss"] for h in first + rest],
            "seconds": [h["seconds"] for h in rest[1:]],
            "hashes": hashes}


def _tp_plant(fault):
    """Plants ``fault`` (TP_PLANTS) in this process's port; returns the
    function that takes it out."""
    from esvit_tpu_torch.parallel import mesh as mesh_lib

    if fault == "summing_backward":
        cls, name = mesh_lib._ModelSum, "backward"
        planted = staticmethod(
            lambda ctx, *grads: (None, *(g * 2 for g in grads)))
    else:
        cls, name = mesh_lib.Mesh, "all_reduce_sum"
        reduce = cls.all_reduce_sum

        def planted(self, tensors, *, over):
            return reduce(self, tensors,
                          over="data" if over == "world" else over)
    saved = cls.__dict__[name]
    setattr(cls, name, planted)
    return lambda: setattr(cls, name, saved)


def _tp_worker(rank, world, backend, store, out_dir, result, plants=()):
    """One rank of the (data=1, model=world) grid: _tp_runs, its peak
    memory and its kernels' launches saved to ``result``.rank; then one
    train() step with each of ``plants`` planted, into
    ``out_dir``_<fault>."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from esvit_tpu_torch import config as C
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import window_attention as wa
    from esvit_tpu_torch.train.train import train

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.cuda.reset_peak_memory_stats()
        out = _tp_runs(torch, _tp_cfg(C, out_dir, world), dist.barrier)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["launches"] = {"fused_block": dict(fb.launches),
                           "window_attention": dict(wa.launches)}
        for fault in plants:
            remove = _tp_plant(fault)
            try:
                train(_tp_cfg(C, f"{out_dir}_{fault}", world), max_steps=1,
                      device="cuda", resume=False)
            finally:
                remove()
        torch.save(out, f"{result}.{rank}")
    finally:
        dist.destroy_process_group()


class _TpSpawn:
    """_tp_worker in ``world`` processes, spawned on entering the block;
    ``finish()`` joins them (each join with a timeout) and returns their
    results by rank and the run's directory. Leaving the block kills a
    process still running. This process's times between the two say so
    (_beside)."""

    def __init__(self, torch, backend, tmp, world=2, plants=()):
        self.torch, self.backend, self.world = torch, backend, world
        self.out_dir = os.path.join(tmp, f"model{world}_{backend}")
        self.result = os.path.join(tmp, f"result_{backend}")
        self.store = os.path.join(tmp, f"store_{backend}")
        self.plants, self.procs, self.label = plants, [], None

    def __enter__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_tp_worker, args=(
            r, self.world, self.backend, self.store, self.out_dir,
            self.result, self.plants)) for r in range(self.world)]
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.__exit__()
            raise
        self.label = f"the {self.backend} ranks"
        _BESIDE.append(self.label)
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        if self.label in _BESIDE:
            _BESIDE.remove(self.label)

    def finish(self):
        try:
            for p in self.procs:
                p.join(TP_TIMEOUT)
            codes = [p.exitcode for p in self.procs]
            if codes != [0] * self.world:
                raise AssertionError(f"head tp {self.backend}: exit codes "
                                     f"{codes}")
        finally:
            self.__exit__()
        return ([self.torch.load(f"{self.result}.{r}", weights_only=False)
                 for r in range(self.world)], self.out_dir)


def _norm_rel(torch, got, want):
    """||got - want|| / ||want||; where want is 0, 0 if got is too, else
    inf."""
    n = torch.linalg.vector_norm(want).item()
    if n == 0:
        return 0.0 if not got.any() else math.inf
    return torch.linalg.vector_norm(got - want).item() / n


def _tp_tree(torch, path):
    """A whole checkpoint, its tensors mapped from the file."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _tp_errors(torch, got, want, init):
    """Two whole checkpoint trees of one step and the initial student:
    {kind: (worst error, where)}. 'abs': the worst |got - want| -
    (TP_ATOL + TP_RTOL |want|) over the student and teacher (> 0 is
    outside), 'abs_max' their worst |got - want|; 'centers' and
    'centers_max' the same at the centre tolerance; 'delta': the worst
    of the student's and the teacher's _norm_rel of the change from
    ``init`` over all their parameters, 'delta_leaf' (logged only) that
    of the worst parameter; 'mu', 'nu': the worst parameter's _norm_rel
    of AdamW's moments. Also 'flips': the share of the student's entries
    that the two stepped opposite ways; 'moved' / 'unmoved': the
    parameters that the reference moved or left (a left one must be
    left in ``got`` too: its 'delta_leaf' is inf otherwise)."""
    if got["step"] != want["step"]:
        raise AssertionError(f"head tp: step {got['step']} != "
                             f"{want['step']}")
    errs = {}

    def worst(kind, err, name):
        if kind not in errs or err > errs[kind][0]:
            errs[kind] = (err, name)

    params = set(want["mu"])
    unmoved, flips, entries = [], 0, 0

    def dev(t):
        return t.to("cuda").float()

    for part in ("student", "teacher"):
        off = norm = 0.0
        for name, w in want[part].items():
            g = got[part].get(name)
            if g is None or g.shape != w.shape:
                raise AssertionError(f"head tp: {part}.{name} missing or "
                                     "of another shape")
            if not w.is_floating_point():
                continue
            g, w = dev(g), dev(w)
            d = (g - w).abs()
            worst("abs", (d - (TP_ATOL + TP_RTOL * w.abs())).max().item(),
                  f"{part}.{name}")
            worst("abs_max", d.max().item(), f"{part}.{name}")
            if name not in params:
                continue
            i = dev(init[name])
            dg, dw = g - i, w - i
            worst("delta_leaf", _norm_rel(torch, dg, dw), f"{part}.{name}")
            off += torch.linalg.vector_norm(dg - dw).item() ** 2
            norm += torch.linalg.vector_norm(dw).item() ** 2
            if part == "student":
                flips += int((dg * dw < 0).sum())
                entries += dw.numel()
                if not dw.any():
                    unmoved.append(name)
        worst("delta", math.sqrt(off / norm), part)
    for part in ("mu", "nu"):
        for name, w in want[part].items():
            worst(part, _norm_rel(torch, dev(got[part][name]), dev(w)),
                  f"{part}.{name}")
    for name, w in want["centers"].items():
        w = dev(w)
        d = (dev(got["centers"][name]) - w).abs()
        worst("centers", (d - (TP_CENTER_ATOL + TP_CENTER_RTOL
                               * w.abs())).max().item(), name)
        worst("centers_max", d.max().item(), name)
    errs["flips"] = flips / entries
    errs["moved"] = len(params) - len(unmoved)
    errs["unmoved"] = unmoved
    return errs


def _tp_failures(errs, step1):
    """The gates that ``errs`` (_tp_errors) fails: the change and the
    moments always, the absolute ones after step 1, and no parameter
    left unmoved but the pinned weight_g."""
    limits = {"delta": TP_STATE_RTOL, "mu": TP_STATE_RTOL,
              "nu": TP_STATE_RTOL}
    if step1:
        limits.update(abs=0.0, centers=0.0)
    fails = [f"{kind} {errs[kind][1]} {errs[kind][0]:.3e} > {limit}"
             for kind, limit in limits.items() if errs[kind][0] > limit]
    unmoved = [n for n in errs["unmoved"]
               if not n.endswith("last_layer.weight_g")]
    if unmoved:
        fails.append(f"unmoved {unmoved}")
    if math.isinf(errs["delta_leaf"][0]):
        fails.append(f"{errs['delta_leaf'][1]} moved, the reference's not")
    return fails


def _tp_line(errs):
    return (f"change from the initial state {errs['delta'][0]:.3e} "
            f"({errs['delta'][1]}; worst parameter "
            f"{errs['delta_leaf'][0]:.3e}, {errs['delta_leaf'][1]}), "
            f"entries stepped the other way {errs['flips']:.3e}, mu "
            f"{errs['mu'][0]:.3e} ({errs['mu'][1]}), nu {errs['nu'][0]:.3e}"
            f" ({errs['nu'][1]}), max abs error {errs['abs_max'][0]:.3e} "
            f"({errs['abs_max'][1]}), centers {errs['centers_max'][0]:.3e}")


def phase_head_tp(torch, C, counters, card):
    """The DINO head's tensor parallelism on the card: the Swin-T W=7 B=32
    recipe (_tp_cfg) through train() for 1 step and, resumed from its
    checkpoint, to TP_STEPS, once in this process at model=1 (launches
    as derived for TP_STEPS steps) and once in two processes sharing
    cuda:0 over gloo at data=1 x model=2 (each holding half of both
    heads' last layers, of their moments, of the centers and of the
    region logits): the losses at every step within TP_LOSS_RTOL; the
    whole checkpoints after step 1 and after TP_STEPS by _tp_errors'
    gates (_tp_failures), step 1 moving every parameter but the pinned
    weight_g; the replicated parameters bit-identical across the two
    ranks; both ranks' block-fused and window-attention launches as
    derived; each rank's peak memory beside the model=1 run's, and the
    ms/step (rank 0's). Then the gloo ranks take one step with each of
    TP_PLANTS, which the same gates must fail. With two cards or more,
    the same (without the plants) over NCCL, one rank per card."""
    import gc

    with tempfile.TemporaryDirectory() as tmp:
        cfg = _tp_cfg(C, os.path.join(tmp, "model1"), 1)
        want = _derived_launches(cfg, TP_STEPS)
        # The gloo ranks run beside this process's model=1 runs.
        with _TpSpawn(torch, "gloo", tmp, plants=TP_PLANTS) as gloo:
            init = _initial_weights(torch, cfg)
            for launches in counters.values():
                for k in launches:
                    launches[k] = 0
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            one = _tp_runs(torch, cfg, lambda: None)
            one_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            one_ms = statistics.mean(one["seconds"]) * 1e3
            one_beside = _beside()
            gc.collect()
            torch.cuda.empty_cache()
            got = {name: dict(launches)
                   for name, launches in counters.items()}
            if got != want:
                raise AssertionError(f"head tp model=1: launches {got}, "
                                     f"model-derived {want}")
            spawned = {"gloo": gloo.finish()}
        log(f"head tp model=1: losses {one['losses']}, launches {got}, peak "
            f"{one_peak:.2f} GiB, {one_ms:.1f} ms/step{one_beside} [{card}]")
        want1 = _tp_tree(torch, os.path.join(tmp, "model1", "step1.pth"))
        want3 = _tp_tree(torch, os.path.join(tmp, "model1", "checkpoint.pth"))
        legs = [("gloo", "two processes sharing one card, started beside "
                 "the model=1 run")]
        if torch.cuda.device_count() >= 2:
            legs.append(("nccl", "two processes on two cards"))
            with _TpSpawn(torch, "nccl", tmp) as nccl:
                spawned["nccl"] = nccl.finish()
        else:
            log("head tp: the NCCL leg (one rank per card) waits for a "
                "machine with two cards: this one has "
                f"{torch.cuda.device_count()}")
        for backend, where in legs:
            ranks, out_dir = spawned[backend]
            if backend == "gloo":
                planted = out_dir
            label = f"model=2 {backend}"
            for r, res in enumerate(ranks):
                for name in ("fused_block", "window_attention"):
                    if res["launches"][name] != want[name]:
                        raise AssertionError(
                            f"head tp {label} rank {r}: {name} launches "
                            f"{res['launches'][name]}, derived {want[name]}")
                rel = [abs(a - b) / abs(b)
                       for a, b in zip(res["losses"], one["losses"])]
                if len(rel) != TP_STEPS or max(rel) > TP_LOSS_RTOL:
                    raise AssertionError(
                        f"head tp {label} rank {r}: losses {res['losses']}"
                        f", model=1 {one['losses']}")
            if ranks[0]["hashes"] != ranks[1]["hashes"]:
                raise AssertionError(f"head tp {label}: the replicated "
                                     "parameters differ between the ranks")
            errs1 = _tp_errors(torch, _tp_tree(torch, os.path.join(
                out_dir, "step1.pth")), want1, init)
            errs = _tp_errors(torch, _tp_tree(torch, os.path.join(
                out_dir, "checkpoint.pth")), want3, init)
            log(f"head tp {label} after step 1: {_tp_line(errs1)}; "
                f"{errs1['moved']} parameters moved, unmoved "
                f"{errs1['unmoved']}")
            log(f"head tp {label} after step {TP_STEPS}: {_tp_line(errs)}")
            fails = (_tp_failures(errs1, step1=True)
                     + _tp_failures(errs, step1=False))
            if fails:
                raise AssertionError(f"head tp {label}: {fails}")
            # Rank 0's clock: rank 1's also holds rank 0's checkpoint
            # write (one step an epoch), which it waits for in the next
            # step's collectives.
            ms = statistics.mean(ranks[0]["seconds"]) * 1e3
            log(f"head tp {label}: losses {ranks[0]['losses']} (max "
                f"relative difference {max(rel):.2e}); the whole state "
                f"within the gates after step 1 and step {TP_STEPS}; "
                "replicated parameters bit-identical on both ranks; "
                "launches as derived on both ranks")
            log(f"head tp {label}: peak GiB per rank "
                + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
                + f" against model=1's {one_peak:.2f} [{card}]")
            log(f"head tp {label}: {ms:.1f} ms/step on rank 0 over steps "
                f"3-{TP_STEPS} ({where}"
                + (": not a tensor-parallel speed)" if backend == "gloo"
                   else ")") + f" [{card}]")
        for fault in TP_PLANTS:
            errs = _tp_errors(torch, _tp_tree(torch, os.path.join(
                f"{planted}_{fault}", "checkpoint.pth")), want1, init)
            fails = _tp_failures(errs, step1=True)
            log(f"head tp planted {fault} after step 1: {_tp_line(errs)}; "
                f"fails {fails}")
            if not fails:
                raise AssertionError(f"head tp: the planted fault {fault} "
                                     "passes the gates")


def _parent_arg(argv):
    """``--parent DIR`` (a checkout of an earlier commit, e.g. a ``git
    archive`` under the gitignored _archive/), or None."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--parent" or not os.path.isfile(
            os.path.join(argv[1], "chip_smoke.py")):
        raise SystemExit(f"unknown arguments {argv}: the only option is "
                         "--parent DIR, a checkout holding chip_smoke.py")
    return os.path.abspath(argv[1])


# The kernels line's large-tile rows (N > 64) and the sums of
# utils/fwd_compare.py's large worker that time them.
PARENT_ROWS = {
    "fused_block_w14_fwd": "fused_w14_fwd",
    "fused_block_w14_bwd": "fused_w14_bwd",
    "pallas_window_attention_w14_fwd": "pwa_w14_fwd",
    "fused_block_swin_b_w14_fwd": "fused_b14_fwd",
    "fused_block_swin_b_w14_bwd": "fused_b14_bwd",
    "window_attention_swin_b_w14_fwd": "wa_b14_fwd",
    "window_attention_swin_b_w14_bwd": "wa_b14_bwd",
}


def phase_parent(parent, card):
    """With ``--parent DIR``: the large-window tile's rows timed in the
    checkout DIR (its own kernels, built there) and here, by the same
    worker (utils/fwd_compare.py large_times), in the order DIR, here:
    each row's sum per step or batch, side by side. Returns {kernels-line
    row: DIR's ms}; empty without a parent."""
    if parent is None:
        return {}
    from esvit_tpu_torch.utils.fwd_compare import large_times

    times = {"parent": large_times(parent), "this": large_times(ROOT)}
    for row, key in PARENT_ROWS.items():
        log(f"large-tile row {row}: this tree {times['this'][key]:.3f} ms, "
            f"parent {times['parent'][key]:.3f} ms [{card}]")
    for key in ("fused_c512_fwd", "fused_c512_bwd"):
        log(f"large-tile {key}: this tree {times['this'][key]:.3f} ms, parent "
            f"{times['parent'][key]:.3f} ms [{card}]")
    return {row: times["parent"][key] for row, key in PARENT_ROWS.items()}


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
    laps = [t_start]

    def lap(what):
        """Logs the seconds since the last lap (the script's time limit is
        shared by every phase)."""
        laps.append(time.perf_counter())
        log(f"phase {what}: {laps[-1] - laps[-2]:.1f} s")

    card = phase_device(torch)
    from esvit_tpu_torch import config as C
    from esvit_tpu_torch.ops import cuda_build
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import pallas_window_attention as pwa
    from esvit_tpu_torch.ops import sliding_chunk as sc
    from esvit_tpu_torch.ops import window as wops
    from esvit_tpu_torch.ops import window_attention as wa

    phase_build(cuda_build, wa, sc)
    parent = _parent_arg(sys.argv[1:])
    lap("1-2 device, build")
    window_attention, window_attention_b14 = phase_window_attention(
        torch, wa, wops)
    lap("3 window attention")
    fused, fused14, fused_b14 = phase_fused(torch, fb, wa, wops)
    phase_lifted_bias(torch, fb, wa, wops, card)
    lap("4 block-fused")
    sliding_chunk = phase_sliding_chunk(torch, sc)
    lap("5 sliding chunk")
    pwa_fwd, pwa_fwd14 = phase_pallas_window_attention(torch, pwa, wops)
    lap("6 qkv-layout")
    results = {"window_attention": window_attention, "fused_block": fused,
               "sliding_chunk": sliding_chunk,
               "pallas_window_attention": {"fwd": pwa_fwd}}
    results14 = {"fused_block": fused14,
                 "pallas_window_attention": {"fwd": pwa_fwd14}}
    results_b14 = {"fused_block": fused_b14,
                   "window_attention": window_attention_b14}
    phase_forward_parity(torch, C, fb, wa, pwa)
    phase_forward_parity(torch, C, fb, wa, pwa, window_size=W14)
    phase_vil_forward_parity(torch, C, sc)
    lap("7 forward parity")
    counters = {"window_attention": wa.launches, "fused_block": fb.launches,
                "sliding_chunk": sc.launches,
                "pallas_window_attention": pwa.launches}
    with tempfile.TemporaryDirectory() as out_dir:
        swin, synthetic_ms, route_states = phase_slice(torch, C, counters,
                                                        card, out_dir)
        phase_data_slice(torch, C, counters, card, out_dir, synthetic_ms)
        phase_route_order(torch, card, route_states)
        lap("8 slices, route order")
        launches14 = phase_swin_w14(torch, C, counters, card, out_dir)
        lap("17 Swin-T W=14")
        launches_b14 = phase_swin_b_w14(torch, C, counters, card, out_dir)
        lap("18 Swin-B W=14")
        vil = phase_vil_slice(torch, C, counters, card, out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        evals = phase_eval(torch, C, pwa, card, out_dir)
    lap("8 ViL-T, 9 eval")
    phase_canary(torch, counters, card)
    lap("10 canary")
    phase_entry(torch, C, card)
    lap("11 entry")
    phase_real_images(torch, C, counters, card, synthetic_ms)
    lap("12 real images")
    phase_families(torch, C, counters, card)
    lap("13 families")
    phase_options(torch, C, counters, card)
    lap("14 options")
    phase_vil_options(torch, C, counters, card)
    lap("15 ViL options")
    phase_last_modules(torch, C, counters, card)
    lap("16 last modules")
    phase_head_tp(torch, C, counters, card)
    lap("19 the head's tensor parallelism")
    parent_ms = phase_parent(parent, card)
    if parent is not None:
        lap("20 the parent's large-tile rows")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    launches = dict(swin, sliding_chunk=vil["sliding_chunk"],
                    pallas_window_attention=evals)
    record = {"kernels": [
        {"name": f"{name}_{k}", "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1][k], "launches": launches[name][k],
         **tally[k].record(), "parent_ms": None}
        for name, tally in results.items() for k in KERNELS[name][1]] + [
        {"name": f"{name}_w14_{k}", "route": "cuda",
         "source": KERNELS[name][0], "replaces": KERNELS[name][1][k],
         "launches": launches14[name][k], **results14[name][k].record(),
         "parent_ms": parent_ms.get(f"{name}_w14_{k}")}
        for name in KERNELS_W14 for k in KERNELS[name][1]] + [
        {"name": f"{name}_swin_b_w14_{k}", "route": "cuda",
         "source": KERNELS[name][0], "replaces": KERNELS[name][1][k],
         "launches": launches_b14[name][k], **results_b14[name][k].record(),
         "parent_ms": parent_ms.get(f"{name}_swin_b_w14_{k}")}
        for name in KERNELS_B14 for k in KERNELS[name][1]]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
