"""The sliding-chunk kernels' staged twins (ops/sliding_chunk.py), on the
CPU.

Each twin computes what its kernel computes, set by set in the kernel's
order and with its roundings: the forward's two passes with a running max
and sum, bwd_q's r, dq and global partials, bwd_k's gather over the query
chunks that see a key chunk, and the partials' reduce. Here they are held
against the plain version with autograd and against esvit_tpu's Pallas
kernel in interpret mode, on numpy inputs from a seed. Tolerances: fp32
2e-5 and bf16 3e-2 of the max-abs (tests/test_packed_window_attention.py
:52); against JAX the forward within 2e-5 and the gradients within 5e-5
(tests/test_torch_sliding_chunk.py). Also: the set lists visit every
valid (query, key) pair exactly once, on both sides of the backward, and
the Python mirror of the kernels' shared memory. The kernels themselves
are held to the twins on a card (tests/test_torch_cuda_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.ops.sliding_chunk_fused import \
    sliding_chunk_attention as jax_sliding_chunk
from esvit_tpu_torch.ops import sliding_chunk as sc
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
JAX_FWD_TOL, JAX_GRAD_TOL = 2e-5, 5e-5
NAMES = ("out", "dq", "dk", "dv", "dkg", "dvg")


def _arrays(BH, nx, ny, nglo, M, seed=0):
    rng = np.random.default_rng(seed)
    grid = (BH, nx, ny, M)
    return ([rng.normal(size=grid).astype(np.float32) * M ** -0.5,
             rng.normal(size=grid).astype(np.float32),
             rng.normal(size=grid).astype(np.float32),
             rng.normal(size=(BH, nglo, M)).astype(np.float32),
             rng.normal(size=(BH, nglo, M)).astype(np.float32)],
            rng.normal(size=grid).astype(np.float32))


def _twins(ins, do, nx, ny, W):
    out, stats = sc.sliding_chunk_fwd_staged(*ins, nx=nx, ny=ny, W=W)
    return [out, *sc.sliding_chunk_bwd_staged(*ins, do, stats, nx=nx, ny=ny,
                                              W=W)]


def _err(got, want):
    want = want.float()
    if not want.numel():
        return 0.0
    return ((got.float() - want).abs().max()
            / max(want.abs().max().item(), 1e-6)).item()


# (BH, nx, ny, nglo, W, M): the ViL-T grids (8x8, 4x4, padded 4x4 and
# padded 2x2 chunks at W=7), a rectangular grid, no globals, 8 globals,
# W = 4 / 8 / 3 and M = 8 / 16 / 24 / 32 / 48 / 64.
GEOMETRIES = [
    (1, 56, 56, 1, 7, 48),
    (2, 28, 28, 1, 7, 32),
    (1, 24, 24, 1, 7, 48),
    (2, 12, 12, 1, 7, 32),
    (2, 21, 10, 1, 7, 16),
    (2, 14, 14, 0, 7, 24),
    (2, 16, 16, 8, 4, 16),
    (1, 20, 20, 3, 8, 64),
    (2, 9, 9, 2, 3, 8),
]


@pytest.mark.parametrize("case", GEOMETRIES)
def test_twins_match_plain_and_autograd_fp32(case):
    BH, nx, ny, nglo, W, M = case
    arrays, dout = _arrays(BH, nx, ny, nglo, M)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    do = torch.tensor(dout)
    ref = sc.sliding_chunk_attention_plain(*ts, nx=nx, ny=ny, W=W)
    want = [ref, *torch.autograd.grad(ref, ts, do)]
    got = _twins([t.detach() for t in ts], do, nx, ny, W)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _err(a, b) <= TOL[torch.float32], name


@pytest.mark.parametrize("case", [(2, 56, 56, 1, 7, 48), (3, 28, 28, 1, 7, 32),
                                  (2, 24, 24, 1, 7, 48), (3, 12, 12, 1, 7, 32),
                                  (2, 16, 16, 8, 4, 24)])
def test_twins_match_plain_and_autograd_bf16(case):
    """In bf16 the twins round where the kernels do (p before P V, ds, the
    outputs once); the plain version rounds p in the softmax's order."""
    BH, nx, ny, nglo, W, M = case
    arrays, dout = _arrays(BH, nx, ny, nglo, M, seed=1)
    ts = [torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in arrays]
    do = torch.tensor(dout).to(torch.bfloat16)
    ref = sc.sliding_chunk_attention_plain(*ts, nx=nx, ny=ny, W=W)
    want = [ref, *torch.autograd.grad(ref, ts, do)]
    got = _twins([t.detach() for t in ts], do, nx, ny, W)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.bfloat16, name
        assert _err(a, b) <= TOL[torch.bfloat16], name


@pytest.mark.parametrize("nx,ny,nglo,W,M", [
    (14, 14, 1, 7, 8), (12, 12, 0, 7, 8), (21, 10, 1, 7, 16),
    (16, 16, 2, 4, 8)])
def test_twins_match_jax_kernel(nx, ny, nglo, W, M):
    """esvit_tpu's Pallas kernel in interpret mode, forward and the
    gradients of all five inputs, against the twins on the same inputs."""
    arrays, w = _arrays(2, nx, ny, nglo, M, seed=2)

    def jfn(*a):
        return jax_sliding_chunk(*a, nx=nx, ny=ny, W=W, interpret=True)

    ja = [jnp.asarray(a) for a in arrays]
    ref = np.asarray(jfn(*ja))
    ref_g = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=range(5))(*ja)
    got = _twins([torch.tensor(a) for a in arrays], torch.tensor(w), nx, ny,
                 W)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=JAX_FWD_TOL,
                               atol=JAX_FWD_TOL)
    for name, a, b in zip(NAMES[1:], got[1:], ref_g):
        assert _err(a, torch.tensor(np.asarray(b))) <= JAX_GRAD_TOL, name


def test_forward_stats_are_the_rows_max_and_inverse_sum():
    """stats holds each row's softmax max and 1/sum over [globals |
    neighbourhood], the constants the backward rebuilds p from."""
    BH, nx, ny, nglo, W, M = 2, 12, 12, 1, 7, 16
    arrays, _ = _arrays(BH, nx, ny, nglo, M, seed=3)
    ins = [torch.tensor(a) for a in arrays]
    _, stats = sc.sliding_chunk_fwd_staged(*ins, nx=nx, ny=ny, W=W)
    q, k, kg = ins[0], ins[1], ins[3]
    chunk = torch.arange(nx) // W
    near = (chunk[:, None] - chunk[None, :]).abs() <= 1
    mask = (near[:, None, :, None] & near[None, :, None, :]).reshape(
        nx * ny, nx * ny)
    s = q.reshape(BH, nx * ny, M) @ k.reshape(BH, nx * ny, M).transpose(1, 2)
    s = torch.cat([q.reshape(BH, nx * ny, M) @ kg.transpose(1, 2),
                   s.masked_fill(~mask, float("-inf"))], -1)
    m = s.amax(-1)
    inv = 1 / torch.exp(s - m[..., None]).sum(-1)
    torch.testing.assert_close(stats[..., 0].reshape(BH, -1), m)
    torch.testing.assert_close(stats[..., 1].reshape(BH, -1), inv)


def _tokens(nx, ny, W, chunk):
    """Token indices (x * ny + y) of a chunk's real rows, in slot order."""
    ci, cj = chunk
    return [(ci * W + j // W) * ny + cj * W + j % W for j in range(W * W)
            if ci * W + j // W < nx and cj * W + j % W < ny]


@pytest.mark.parametrize("nx,ny,W", [(56, 56, 7), (28, 28, 7), (24, 24, 7),
                                     (12, 12, 7), (21, 10, 7), (16, 16, 4),
                                     (6, 6, 7)])
def test_set_lists_visit_every_valid_pair_once(nx, ny, W):
    """bwd_q walks each query chunk's key sets and bwd_k gathers each key
    chunk's query chunks: each counts every (query, key) pair of the
    neighbourhood relation exactly once, and nothing else; bwd_q meets the
    globals once per query chunk, first. The per-chunk key counts equal
    the plain version's valid entries (invalid_mask_zero)."""
    mx, my = -(-nx // W), -(-ny // W)
    n = nx * ny
    cx, cy = np.arange(n) // ny // W, np.arange(n) % ny // W
    want = ((np.abs(cx[:, None] - cx[None]) <= 1)
            & (np.abs(cy[:, None] - cy[None]) <= 1)).astype(np.int32)
    by_q, by_k = np.zeros((n, n), np.int32), np.zeros((n, n), np.int32)
    invalid = sc.invalid_mask_zero(mx, my, mx * W - nx, my * W - ny, W)
    chunks = [(ci, cj) for ci in range(mx) for cj in range(my)]
    for i, c in enumerate(chunks):
        sets = sc.neighbour_sets(mx, my, *c, with_globals=True)
        assert sets[0] is None and None not in sets[1:]
        own = _tokens(nx, ny, W, c)
        keys = 0
        for s in sets[1:]:
            other = _tokens(nx, ny, W, s)
            by_q[np.ix_(own, other)] += 1
            keys += len(other)
        assert keys == (~invalid[i]).sum()
        for s in sc.neighbour_sets(mx, my, *c, with_globals=False):
            by_k[np.ix_(_tokens(nx, ny, W, s), own)] += 1
    np.testing.assert_array_equal(by_q, want)
    np.testing.assert_array_equal(by_k, want)


def test_set_order_is_the_kernels():
    """Globals first, then the in-grid neighbours in row-major offset
    order; a corner chunk has four sets of chunks, an edge chunk six."""
    assert sc.neighbour_sets(3, 3, 1, 1, True) == [None] + [
        (i, j) for i in range(3) for j in range(3)]
    assert sc.neighbour_sets(3, 3, 0, 0, False) == [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]
    assert len(sc.neighbour_sets(4, 4, 0, 2, False)) == 6
    assert sc.neighbour_sets(1, 1, 0, 0, False) == [(0, 0)]


def test_smem_layout_mirror():
    """The tensor-core kernels' shared memory at ViL-T's shapes (W=7, one
    global): bf16 tiles of 64 rows at stride round16(M) + 8, 128-byte
    aligned, a ring of two slots, so five blocks fit an SM (228 KB, 1 KB
    reserved per block); the fp32 forward keeps its chunk-wide score
    buffer. Every shape supports() admits fits a block (227 KB) in both
    dtypes."""
    tile48 = 64 * 56 * 2          # 7168 bytes, 128-aligned
    assert sc.kernel_smem_bytes(7, 48, 1, 2) == {
        "fwd": 256 + 5 * tile48,
        "bwd_q": 256 + 6 * tile48 + 4 * 2 * 48 * 4,
        "bwd_k": 256 + 2 * tile48 + 2 * (2 * tile48 + 768)}
    tile32 = 64 * 40 * 2
    assert sc.kernel_smem_bytes(7, 32, 1, 2)["fwd"] == 256 + 5 * tile32
    for M in (48, 32):
        most = max(sc.kernel_smem_bytes(7, M, 1, 2).values())
        assert 5 * (most + 1024) <= 233472
    R = 52                        # ceil4(49)
    assert sc.kernel_smem_bytes(7, 48, 1, 4)["fwd"] == 4 * (
        2 * 48 * R + (4 + 9 * R) * R + 4 * R) + 8 * R
    for W in range(1, 9):
        for M in range(8, 65, 8):
            for nglo in range(9):
                assert sc.supports(W, M, nglo)
                for itemsize in (2, 4):
                    assert max(sc.kernel_smem_bytes(
                        W, M, nglo, itemsize).values()) <= 232448


def test_glo_reduce_sums_the_chunks_in_order():
    partial = torch.tensor(np.random.default_rng(4).normal(
        size=(2, 3, 5, 2, 8)).astype(np.float32))
    dkg, dvg = sc.glo_reduce_staged(partial, torch.float32)
    want = partial[:, :, 0]
    for c in range(1, 5):
        want = want + partial[:, :, c]
    assert torch.equal(dkg, want[0]) and torch.equal(dvg, want[1])
