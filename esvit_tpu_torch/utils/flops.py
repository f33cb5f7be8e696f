"""FLOP and parameter counts (port of esvit_tpu/utils/flops.py).

esvit_tpu asks XLA's cost model of the compiled forward. Here the
forward runs once on the CPU under ``torch.utils.flop_counter.
FlopCounterMode``, which counts the aten products it dispatches (matmul,
linear, convolution, attention; 2 per multiply-add): on the CPU every
wrapper takes its plain PyTorch version, which the counter sees, where
the card's hand-written kernels are not aten ops and it would not. So
the count is the products' FLOPs and leaves out elementwise work
(softmax, LayerNorm, GELU), which XLA's counts. There is no counterpart
of XLA's ``bytes accessed`` (its estimate for one fused program):
``forward_cost`` returns None for it.
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode


def param_count(model) -> int:
    """Parameters of a module, or entries of a state dict."""
    tensors = (model.values() if isinstance(model, dict)
               else model.parameters())
    return sum(int(t.numel()) for t in tensors)


def forward_cost(backbone, input_shape: tuple[int, ...],
                 dtype=torch.float32) -> dict:
    """One deterministic ``forward_features`` of zeros of ``input_shape``
    (e.g. (1, 224, 224, 3)) on a CPU copy of the backbone: {'flops':
    the products' FLOPs for the batch, 'bytes_accessed': None, 'params':
    int}."""
    model = copy.deepcopy(backbone).cpu()
    x = torch.zeros(input_shape, dtype=dtype)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model.forward_features(x)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": None,
            "params": param_count(backbone)}


def summarize(backbone, image_size: int = 224, dtype=torch.float32) -> str:
    c = forward_cost(backbone, (1, image_size, image_size, 3), dtype)
    return (f"params: {c['params'] / 1e6:.2f}M  "
            f"fwd GFLOPs@{image_size}: {c['flops'] / 1e9:.2f}  "
            f"bytes: not counted")
