"""The port's CUDA window-attention kernels against their plain version.

Needs an NVIDIA GPU with nvcc (the kernels build from csrc/ at first use);
every test here is marked ``cuda`` and skips without a card. Run on one
with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``. This
file imports no jax, so it runs where only torch is installed.

Tolerances: fp32 2e-5 and bf16 3e-2 (tests/test_packed_window_attention.py
:52), each gradient normalised by its max-abs. dbias must be
bit-identical when run twice: the kernel sums its partials in a fixed
order.
"""

import numpy as np
import pytest
import torch

from esvit_tpu_torch.ops import window as wops
from esvit_tpu_torch.ops import window_attention as wa

# (N(ws^2), nH, n_windows, B, shifted, H, W, ws, ss), as the JAX kernel's tests
CASES = [
    (16, 2, 4, 2, False, 8, 8, 4, 0),
    (16, 2, 4, 2, True, 8, 8, 4, 2),
    (49, 3, 16, 1, True, 28, 28, 7, 3),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(cuda, case, dtype, tol):
    N, nH, nW, B, shifted, H, W, ws, ss = case
    C = nH * 32
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(B * nW * N, C).astype(np.float32)
                   for _ in range(4))
    bias = (0.3 * rng.randn(nH, N, N)).astype(np.float32)
    region = (torch.as_tensor(wops.window_region_ids(H, W, ws, ss),
                              device=cuda) if shifted else None)

    def run(fn):
        ts = [torch.tensor(a, device=cuda, dtype=t).requires_grad_()
              for a, t in zip((q, k, v, bias), (dtype,) * 3 + (torch.float32,))]
        out = fn(*ts, region, N, nH, 32 ** -0.5)
        out.backward(torch.tensor(do, device=cuda, dtype=dtype))
        return [out.detach().float().cpu()] + [t.grad.float().cpu() for t in ts]

    got = run(wa._WindowAttention.apply)
    again = run(wa._WindowAttention.apply)
    ref = run(wa.window_attention_plain)
    torch.testing.assert_close(got[4], again[4], rtol=0, atol=0)
    for name, a, b in zip(["out", "dq", "dk", "dv", "dbias"], got, ref):
        s = max(b.abs().max().item(), 1e-6)
        torch.testing.assert_close(a / s, b / s, rtol=tol, atol=tol, msg=name)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(49 * 2, 96, device=cuda, dtype=torch.float16)
    bias = torch.zeros(3, 49, 49, device=cuda)
    with pytest.raises(TypeError):
        wa.window_attention(q, q, q, bias, None, 49, 3, 0.17)
    q = torch.zeros(49 * 2, 192, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, bias, None, 49, 3, 0.17)
