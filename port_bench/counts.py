"""Work counted from a configuration's and a traffic mix's shapes alone.

``step_flops``: the products of one training step of one card, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the reference
(reference/) on the meta device: the teacher's forward on the global
views, the student's forward and backward on every view, both DINO heads
and the loss's contractions. Products only (2 flops a multiply-add; no
elementwise work), no recomputation, and the windows as EsViT pads them.

``fused_block_bound_s``: the least time one step's block-fused calls could
take on the card, by the arithmetic of chip_smoke.py's ``Tally`` (copied):
per call on T window tokens of width C and MLP width F,
(8 C^2 + 4 C F) T + 4 N C T flops (24 C^2 T + 4 N C T at F = 4C:
q, k, v, proj, fc1, fc2, and the two attention products), twice that in
the backward (the two transposed products of each; ``Tally`` counts a
third for the kernels' recompute of the forward, an implementation's
choice that this count leaves out); bytes 2 T C e + 4 P + tables in the
forward (x in, y out) and 3 T C e + 8 P + tables in the backward (x and
dy in, dx out, the parameters in and their gradients out), e the compute
dtype's size, P the block's fp32 parameters
(with the (nH, N, N) bias), tables the fp32 or int32 shift-region and
pad tables. The sums over every call are bounded by 989 TFLOP/s (bf16)
and 3.35 TB/s, the larger of the two. The calls are those of the stages
that the configuration names in ``fused_block_stages``, in every crop
group: the teacher's forward on the global views, the student's forward
and backward on all views. A stage whose tokens lie in one padded window
runs one augmented window of H*W + 1 tokens (the real ones and one that
stands for the pad); the others run whole windows of ws^2 tokens over the
padded grid.
"""

from __future__ import annotations

import math

import torch

BF16_FLOP_PER_S = 989e12        # H100 SXM, dense bf16 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def step_flops(config: dict, traffic: dict) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference import step as ref

    b = traffic["batch_per_card"]
    dense = traffic["region_task"]
    student = ref.build(config, dense)
    teacher = ref.build(config, dense).requires_grad_(False)
    with torch.device("meta"):
        crops = (torch.empty(traffic["global_crops"] * b,
                             traffic["global_size"], traffic["global_size"],
                             3),
                 torch.empty(traffic["local_crops"] * b,
                             traffic["local_size"], traffic["local_size"], 3))
        K = config["head"]["out_dim"]
        centers = (torch.empty(K), torch.empty(K))
    counter = FlopCounterMode(display=False)
    with counter:
        value, _, _ = ref.forward_loss(student, teacher, crops, b, centers,
                                       (0.07, 0.1))
        torch.autograd.grad(value, list(student.parameters()),
                            allow_unused=True)
    return float(counter.get_total_flops())


def _stage_calls(config: dict, traffic: dict):
    """One entry per fused block and crop group: its tokens T (images x
    windows x N), window N, windows nW, C, heads, MLP width, its tables,
    and its forward calls (the teacher's too on the global views) and
    backward calls a step."""
    m = config["model"]
    b = traffic["batch_per_card"]
    res0 = m["img_size"] // m["patch_size"]
    groups = [(traffic["global_size"], traffic["global_crops"] * b, True),
              (traffic["local_size"], traffic["local_crops"] * b, False)]
    for size, images, teacher_sees in groups:
        if images == 0:
            continue
        H = size // m["patch_size"]
        for s, depth in enumerate(m["depths"]):
            h = math.ceil(H / 2 ** s)
            if s not in m["fused_block_stages"]:
                continue
            r = res0 // 2 ** s
            ws = min(m["window_size"], r)
            shift_on = r > ws
            C = m["embed_dim"] * 2 ** s
            nH = m["num_heads"][s]
            Hp = math.ceil(h / ws) * ws
            augmented = Hp == ws and h < ws
            N, nW = (h * h + 1, 1) if augmented else (ws * ws, (Hp // ws) ** 2)
            for j in range(depth):
                shifted = shift_on and j % 2 == 1
                yield dict(T=images * nW * N, N=N, nW=nW, C=C, nH=nH,
                           hidden=int(C * m["mlp_ratio"]),
                           region=shifted and not augmented,
                           pad=(Hp != h) or augmented, augmented=augmented,
                           fwd=2 if teacher_sees else 1, bwd=1)


def fused_block_work(config: dict, traffic: dict) -> tuple[float, float]:
    """(bytes, flops) of one step's block-fused calls (module docstring)."""
    e = DTYPE_BYTES[config["compute_dtype"]]
    nbytes = flops = 0.0
    for c in _stage_calls(config, traffic):
        T, N, nW, C, nH, F = (c[k] for k in ("T", "N", "nW", "C", "nH",
                                             "hidden"))
        params = 4 * (4 * C + 3 * C * C + 3 * C + nH * N * N + C * C + C
                      + 2 * C * F + F + C)
        tables = ((4 * nW * N if c["region"] else 0)
                  + (4 * (N if c["augmented"] else nW * N) if c["pad"]
                     else 0))
        f = 2 * T * (4 * C * C + 2 * C * F) + 4 * T * N * C
        rows = T * C * e
        nbytes += c["fwd"] * (2 * rows + params + tables)
        flops += c["fwd"] * f
        nbytes += c["bwd"] * (3 * rows + 2 * params + tables)
        flops += c["bwd"] * 2 * f
    return nbytes, flops


def fused_block_bound_s(config: dict, traffic: dict) -> float:
    nbytes, flops = fused_block_work(config, traffic)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
