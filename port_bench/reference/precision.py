"""The arithmetic of the reference's products.

``FP32`` is the reference itself: every product in float32 with TF32 off
(``no_tf32`` switches it off for the process). ``FP8`` is the control that
the correctness limits are measured against: the same reference with both
operands of every product rounded to float8 under a per-tensor scale
(the forward's to e4m3, the gradients entering the backward's products to
e5m2, as float8 training rounds them), the next precision below the
bfloat16 that the benchmarked configurations state, accumulated in
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _to_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale (amax -> its max)."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX[dtype] / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _RoundForward(torch.autograd.Function):
    """e4m3 in the forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity in the forward; the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2)


def no_tf32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """How the reference rounds the operands of a product."""

    name = "fp32"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def round_grad(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def linear(self, x, w, b=None):
        y = F.linear(self.round(x), self.round(w))
        y = self.round_grad(y)
        return y if b is None else y + b

    def matmul(self, a, b):
        return self.round_grad(torch.matmul(self.round(a), self.round(b)))


class Float8(Precision):
    """Operands through float8 with a per-tensor scale."""

    name = "fp8"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundForward.apply(x)

    def round_grad(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y)


FP32 = Precision()
FP8 = Float8()
