"""The large-window tile (csrc/window_attention_tile.cuh, 64 < N <= 256:
Swin at W=14) on the CPU: a plain-torch model of its arithmetic, both
passes, both dtypes and all three policies, its launch plans, its shared
memory and its shape rule.

The kernels cannot run here, so this file models what they compute, down
to the tile padding: query rows in m16 tiles read clamped to row N - 1,
keys swept in blocks of 64 (the keys past N read clamped and masked with
-inf, p exactly 0), the head dim zero-filled to a multiple of 16. The
softmax keeps one max per row: a sweep carries the running max over the
key blocks and rescales the sum (and, in one-sweep forms, the output) by
2^((old - new) log2e) when it grows. The forms, per policy:

- the packed roundings (TableBias; A1, rows 3-4): two sweeps, the rows'
  max and sum, then p = 2^(s log2e + off) inv rounded to bf16 and P.V;
- row 7's policy (DenseBias) in bf16: one sweep, e split into bf16 hi +
  lo, the output rescaled and divided by the sum at the end;
- fp32 (every policy): one sweep, e in fp32, the same rescaling;
- the backward: pass 1 sweeps the key blocks once for the max, the sum
  and rowsum(p dP) = (sum of e dP) * (1 / sum), then again for p, dP and
  ds (ds into dbias, dq); pass 2 sweeps the query blocks for p^T, dv,
  dP^T and dk, with p and ds zero in the padded queries, so the clamped
  rows add nothing to dv and dk. Its e is 2^((s - max) log2e), the
  difference rounded first (the forwards form s log2e - max log2e by one
  fma), so e is exactly 1 at a row's max.

bf16 models hold exact bf16 values in fp32 tensors (the mma multiplies
bf16 operands exactly and accumulates in fp32). The tolerances are those
of tests/test_torch_window_attention_tiles.py and
tests/test_torch_window_attention_bwd_tiles.py, for the same reasons:

- row 7's policy (ops/pallas_window_attention.py: unscaled q, the score
  scaled after the product, p split into bf16 hi + lo): within 2^-16
  max|v| of pallas_window_attention_plain and of JAX's
  ``_reference_attention`` before the output cast;
- A1's policy (the fused block's attention half, the packed roundings:
  qs = bf16(q * bf16(scale)), p rounded to bf16): within one bf16 ulp
  plus 2^-8 max|v| of window_attention_plain after the cast;
- fp32 (both): within 1e-5 of both plain versions;
- A2, the backward (the packed roundings): bf16 dq, dk, dv within one
  bf16 ulp plus 2^-7 of the output's max-abs of window_attention_bwd_plain,
  dbias within 1e-5; fp32 within 1e-5 of autograd through
  window_attention_plain, which is within 2e-5 of esvit_tpu's XLA window
  attention (its WindowAttention module, attention_impl='xla').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.models.swin import WindowAttention as JWindowAttention
from esvit_tpu.ops import pallas_window_attention as jpwa
from esvit_tpu.ops import window as jwops
from esvit_tpu_torch.ops import fused_block as fb
from esvit_tpu_torch.ops import pallas_window_attention as pwa
from esvit_tpu_torch.ops import window as twops
from esvit_tpu_torch.ops import window_attention as wa
from tests.torch_threads import one_intra_op_thread  # noqa: F401

KEYS = 256                 # the padded keys: kLargeMaxN
BLOCK = 64                 # keys per block of a sweep: kLargeKeys
NS = [65, 100, 129, 145, 196, 256]  # 65, 129: one key past a block;
                                    # 145: the augmented window; 196: W=14
FP32_TOL = 1e-5
LOG2E = float(np.float32(1.4426950408889634))  # the kernels' fp32 log2(e)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _pad(t, hd):
    return torch.nn.functional.pad(t, (0, -(-hd // 16) * 16 - hd))


def _blocks(N):
    """The key (or query) blocks a sweep takes: slices of 64 below N."""
    return [slice(j, j + BLOCK) for j in range(0, N, BLOCK)]


def _exp(s, off):
    """2^(s log2e + off) as the kernels form it: one fused multiply-add
    (the exact product and sum, rounded once to fp32), then exp2."""
    return torch.exp2((s.double() * LOG2E + off.double()[..., None]).float())


def _exp_exact(s, m):
    """2^((s - m) log2e) as the backward forms it: the difference, then
    the product, each rounded to fp32, then exp2: exactly 1 at a row's
    max."""
    return torch.exp2((s - m[..., None]) * LOG2E)


def _step(m, s, exact=False):
    """One block of biased scores (G, R, 64) joining a running max m: the
    new max, the rescale factor 2^((m - new) log2e) of what came before
    (1 where the max stayed) and e = 2^(s log2e - new log2e) (0 at -inf;
    ``exact``: 2^((s - new) log2e))."""
    new = torch.maximum(m, s.amax(-1))
    alpha = torch.where(new == m, torch.ones_like(m),
                        torch.exp2((m - new) * LOG2E))
    return new, alpha, (_exp_exact(s, new) if exact
                        else _exp(s, -new * LOG2E))


def _run(s_blocks, extra=None, exact=False):
    """The running max over a sweep's blocks of biased scores and the sum
    of e, rescaled as the max grows; with ``extra`` (the blocks' dP) also
    the sum of e dP, rescaled with it. Returns max, sum and that sum (or
    None)."""
    m = torch.full(s_blocks[0].shape[:2], -torch.inf)
    sm = torch.zeros_like(m)
    d = torch.zeros_like(m) if extra is not None else None
    for b, s in enumerate(s_blocks):
        m, alpha, e = _step(m, s, exact)
        sm = sm * alpha + e.sum(-1)
        if extra is not None:
            d = d * alpha + (e * extra[b]).sum(-1)
    return m, sm, d


def _p(s, m, sm, exact=False):
    """p = 2^(s log2e + off) inv, off = -max log2e, inv = 1 / sum
    (``exact``: 2^((s - max) log2e) inv)."""
    e = _exp_exact(s, m) if exact else _exp(s, -m * LOG2E)
    return e * (1 / sm)[..., None]


def large_tile_model(q, k, v, bias, scale, *, bf16, round_q=False,
                     split_p=False):
    """The forward tile per (window, head): q, k, v (G, N, hd) fp32, bias
    (G, N, N) fp32 -> (G, N, hd) fp32, before the output's cast. Query rows
    in m16 tiles (clamped), keys in blocks of 64 over 256 (clamped, masked);
    two sweeps where p is rounded to bf16 after normalising (bf16 without
    split_p), else one."""
    G, N, hd = q.shape
    rows = torch.arange(-(-N // 16) * 16).clamp(max=N - 1)
    keys = torch.arange(KEYS).clamp(max=N - 1)
    Q, K, V = _pad(q, hd)[:, rows], _pad(k, hd)[:, keys], _pad(v, hd)[:, keys]
    if not bf16:
        Q = Q * scale
    elif round_q:
        Q = _bf16(Q * _bf16(torch.tensor(scale)))
    s = Q @ K.transpose(1, 2)
    if bf16 and not round_q:
        s = s * scale
    s = s + bias[:, rows][:, :, keys]
    s[:, :, N:] = -torch.inf
    blocks = _blocks(N)
    if bf16 and not split_p:
        m, sm, _ = _run([s[:, :, b] for b in blocks])
        o = sum(_bf16(_p(s[:, :, b], m, sm)) @ V[:, b] for b in blocks)
        return o[:, :N, :hd]
    m = torch.full(s.shape[:2], -torch.inf)
    sm = torch.zeros_like(m)
    o = torch.zeros(G, s.shape[1], V.shape[-1])
    for b in blocks:
        m, alpha, e = _step(m, s[:, :, b])
        pv = (_bf16(e) @ V[:, b] + _bf16(e - _bf16(e)) @ V[:, b] if bf16
              else e @ V[:, b])
        o = o * alpha[..., None] + pv
        sm = sm * alpha + e.sum(-1)
    return (o / sm[..., None])[:, :N, :hd]


def large_bwd_model(q, k, v, do, bias, scale, *, bf16):
    """The backward tile per (window, head): dq, dk, dv (G, N, hd) and ds
    (G, N, N) fp32, rounded where the kernel rounds (bf16). Pass 1 on the
    query tiles: one sweep of the key blocks for the max, the sum and the
    sum of e dP, then p, dP and ds; pass 2 on the key tiles sweeps the
    query blocks, with p and ds zero in the padded queries."""
    G, N, hd = q.shape
    idx = torch.arange(KEYS).clamp(max=N - 1)
    real = (torch.arange(KEYS) < N).float()[None, :, None]
    r = _bf16 if bf16 else (lambda t: t)
    Q, K, V, D = (_pad(t, hd)[:, idx] for t in (q, k, v, do))
    QS = _bf16(Q * _bf16(torch.tensor(scale))) if bf16 else Q * scale
    s = QS @ K.transpose(1, 2) + bias[:, idx][:, :, idx]
    s[:, :, N:] = -torch.inf
    dp = D @ V.transpose(1, 2)
    blocks = _blocks(N)
    m, sm, d = _run([s[:, :, b] for b in blocks], [dp[:, :, b] for b in blocks],
                    exact=True)
    rs = d * (1 / sm)
    p = torch.cat([_p(s[:, :, b], m, sm, exact=True) for b in blocks], -1)
    p = torch.nn.functional.pad(p, (0, KEYS - p.shape[-1]))
    ds = p * (dp - rs[..., None])
    dq = r(r(ds) @ K * scale)
    pt, dst = p * real, ds * real
    dv = r(sum(r(pt[:, b]).transpose(1, 2) @ D[:, b] for b in blocks))
    dk = r(sum(r(dst[:, b]).transpose(1, 2) @ QS[:, b] for b in blocks))
    return dq[:, :N, :hd], dk[:, :N, :hd], dv[:, :N, :hd], ds[:, :N, :N]


def _shape(N):
    """(windows B_, C, nH, window types) at N: Swin's head dim 32 over two
    types, and at N=100 a head dim of 24 (zero-filled to 32)."""
    return (4, 48, 2, 2) if N == 100 else (4, 96, 3, 2)


def _inputs(N, seed=0):
    B_, C, nH, types = _shape(N)
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.normal(size=(B_ * N, C)).astype(np.float32))) for _ in range(4))
    table = torch.from_numpy((0.3 * rng.normal(size=(nH, N, N)))
                             .astype(np.float32))
    region = torch.from_numpy(rng.integers(0, 3, size=(types, N))
                              .astype(np.int32))
    return q, k, v, do, table, region


def _dense(table, region):
    differ = region[:, :, None] != region[:, None, :]
    return table[None] + torch.where(differ, -100.0, 0.0)[:, None]


def _heads(t, B_, N, nH):
    hd = t.shape[-1] // nH
    return t.reshape(B_, N, nH, hd).transpose(1, 2).reshape(B_ * nH, N, hd)


def _rows(t, B_, N, nH):
    hd = t.shape[-1]
    return t.reshape(B_, nH, N, hd).transpose(1, 2).reshape(B_ * N, nH * hd)


def _fwd(q, k, v, table, region, N, scale, **kw):
    B_ = q.shape[0] // N
    nH = table.shape[0]
    dense = _dense(table, region)
    bias = dense[torch.arange(B_) % dense.shape[0]].reshape(B_ * nH, N, N)
    o = large_tile_model(*(_heads(t, B_, N, nH) for t in (q, k, v)), bias,
                         scale, **kw)
    return _rows(o, B_, N, nH)


def _bwd(q, k, v, do, table, region, N, scale, bf16):
    B_ = q.shape[0] // N
    nH = table.shape[0]
    dense = _dense(table, region)
    bias = dense[torch.arange(B_) % dense.shape[0]].reshape(B_ * nH, N, N)
    dq, dk, dv, ds = large_bwd_model(
        *(_heads(t, B_, N, nH) for t in (q, k, v, do)), bias, scale,
        bf16=bf16)
    return (*(_rows(t, B_, N, nH) for t in (dq, dk, dv)),
            ds.reshape(B_, nH, N, N).sum(0))


def _qkv(q, k, v, N):
    return torch.cat([q, k, v], dim=-1).reshape(q.shape[0] // N, N, -1)


def _one_ulp(a, b, atol):
    return ((a - b).abs()
            <= 2 ** -7 * torch.maximum(a.abs(), b.abs()) + atol).all()


@pytest.mark.parametrize("N", NS)
def test_row7_bf16_model_matches_plain(N):
    q, k, v, _, table, region = _inputs(N)
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    got = _fwd(q, k, v, table, region, N, scale, bf16=True, split_p=True)
    qkv = _qkv(q, k, v, N)
    want = pwa.pallas_window_attention_plain(qkv, _dense(table, region), nH,
                                             scale).reshape(got.shape)
    bound = 2 ** -16 * v.abs().max()
    assert (got - want).abs().max() <= bound
    one = _fwd(q, k, v, table, region, N, scale, bf16=True)
    assert (one - want).abs().max() > bound      # the split carries p
    plain_bf16 = pwa.pallas_window_attention_plain(
        qkv.to(torch.bfloat16), _dense(table, region), nH, scale)
    assert _one_ulp(_bf16(got), plain_bf16.float().reshape(got.shape), bound)


@pytest.mark.parametrize("N", NS)
def test_a1_bf16_model_is_plain(N):
    q, k, v, _, table, region = _inputs(N, seed=1)
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    got = _bf16(_fwd(q, k, v, table, region, N, scale, bf16=True,
                     round_q=True))
    want = wa.window_attention_plain(
        *(t.to(torch.bfloat16) for t in (q, k, v)), table, region, N, nH,
        scale).float()
    assert _one_ulp(got, want, 2 ** -8 * v.abs().max())


@pytest.mark.parametrize("N", NS)
def test_fp32_model_matches_both_plain_versions(N):
    q, k, v, _, table, region = _inputs(N, seed=2)
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    got = _fwd(q, k, v, table, region, N, scale, bf16=False)
    want7 = pwa.pallas_window_attention_plain(
        _qkv(q, k, v, N), _dense(table, region), nH, scale).reshape(got.shape)
    want1 = wa.window_attention_plain(q, k, v, table, region, N, nH, scale)
    for want in (want7, want1):
        s = want.abs().max()
        torch.testing.assert_close(got / s, want / s, rtol=FP32_TOL,
                                   atol=FP32_TOL)


@pytest.mark.parametrize("N", NS)
def test_a2_bf16_model_matches_plain_backward(N):
    q, k, v, do, table, region = _inputs(N, seed=3)
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    got = _bwd(q, k, v, do, table, region, N, scale, True)
    want = wa.window_attention_bwd_plain(
        *(t.to(torch.bfloat16) for t in (q, k, v, do)), table, region, N, nH,
        scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = b.float()
        assert _one_ulp(a, b, 2 ** -7 * b.abs().max()), name
    assert (got[3] - want[3]).abs().max() <= 1e-5 * want[3].abs().max()


@pytest.mark.parametrize("N", NS)
def test_a2_fp32_model_and_plain_backward_match_autograd(N):
    q, k, v, do, table, region = _inputs(N, seed=4)
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    ts = [t.clone().requires_grad_() for t in (q, k, v, table)]
    out = wa.window_attention_plain(*ts, region, N, nH, scale)
    want = torch.autograd.grad(out, ts, do)
    model = _bwd(q, k, v, do, table, region, N, scale, False)
    plain = wa.window_attention_bwd_plain(q, k, v, do, table, region, N, nH,
                                          scale)
    for got in (model, plain):
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            assert (a - b).abs().max() <= FP32_TOL * b.abs().max(), name


@pytest.mark.parametrize("N", [129, 196])
def test_models_with_the_row_max_in_the_ragged_last_block(N):
    """Every row's max lies in the last key block (one key at N=129, four
    at 196), so each sweep's running max grows at its last block and the
    sums (and the one-sweep outputs) are rescaled there: the three forward
    forms and the backward stay within their tolerances of the plain
    versions. (A far larger lift makes dk at that column a sum of N
    cancellations whose fp32 error depends on the order of the sums, so
    the sweeps' and the plain version's orders drift apart by about the
    1e-5 tolerance; a lift of 8 keeps every row's max in the last block
    with the forms close.)"""
    q, k, v, do, table, region = _inputs(N, seed=7)
    table[:, :, N - 1] += 8.0
    region = None
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    dense = table[None]
    B_ = q.shape[0] // N
    s = (_heads(q, B_, N, nH) * scale) @ _heads(k, B_, N, nH).transpose(1, 2)
    s = s + dense[0].repeat(B_, 1, 1)
    assert (s.argmax(-1) >= (N - 1) // BLOCK * BLOCK).all()
    _region = torch.zeros(1, N, dtype=torch.int32)

    got = _fwd(q, k, v, table, _region, N, scale, bf16=True, split_p=True)
    want = pwa.pallas_window_attention_plain(_qkv(q, k, v, N), dense, nH,
                                             scale).reshape(got.shape)
    assert (got - want).abs().max() <= 2 ** -16 * v.abs().max()
    got = _bf16(_fwd(q, k, v, table, _region, N, scale, bf16=True,
                     round_q=True))
    want = wa.window_attention_plain(
        *(t.to(torch.bfloat16) for t in (q, k, v)), table, region, N, nH,
        scale).float()
    assert _one_ulp(got, want, 2 ** -8 * v.abs().max())
    got = _fwd(q, k, v, table, _region, N, scale, bf16=False)
    want = wa.window_attention_plain(q, k, v, table, region, N, nH, scale)
    sc = want.abs().max()
    torch.testing.assert_close(got / sc, want / sc, rtol=FP32_TOL,
                               atol=FP32_TOL)
    got = _bwd(q, k, v, do, table, _region, N, scale, True)
    want = wa.window_attention_bwd_plain(
        *(t.to(torch.bfloat16) for t in (q, k, v, do)), table, region, N, nH,
        scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = b.float()
        assert _one_ulp(a, b, 2 ** -7 * b.abs().max()), name
    assert (got[3] - want[3]).abs().max() <= 1e-5 * want[3].abs().max()


FP64_GATE = 2e-5      # the cuda tests' fp32 tolerance


@pytest.mark.parametrize("lift", [12, 16, 24])
@pytest.mark.parametrize("N", [145, 196])
def test_fp32_backward_at_a_lifted_bias_column_against_fp64(N, lift):
    """The last key column's bias lifted far past lift 8: p at that column
    tends to 1, so its ds = p (dP - rowsum(p dP)) is a difference of
    nearly equal fp32 numbers, and dk and dbias there sums of N such
    differences. The tile's fp32 backward model and
    window_attention_bwd_plain each hold dq, dk, dv and dbias within
    max(2e-5, 2 x the fp32 plain version's own error) of autograd through
    window_attention_plain in float64 (each over the fp64 gradient's
    max-abs): the card's gate (tests/test_torch_cuda_kernels.py). The
    fp32 plain version is autograd through window_attention_plain in
    fp32; its own error grows with the lift (about e^lift times fp32's
    rounding), which the gate's second term admits."""
    q, k, v, do, table, _ = _inputs(N, seed=7)
    table[:, :, N - 1] += float(lift)
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    args = (q, k, v, do, table, None, N, nH, scale)
    plain = wa.fp64_grad_errors(wa.plain_grads(*args), *args)
    model = wa.fp64_grad_errors(
        _bwd(q, k, v, do, table, torch.zeros(1, N, dtype=torch.int32), N,
             scale, False), *args)
    bwd_plain = wa.fp64_grad_errors(wa.window_attention_bwd_plain(*args),
                                    *args)
    for name in wa.GRAD_NAMES:
        gate = max(FP64_GATE, 2 * plain[name])
        print(f"N={N} lift={lift} {name}: model {model[name]:.3e} "
              f"bwd_plain {bwd_plain[name]:.3e} plain {plain[name]:.3e} "
              f"gate {gate:.3e}")
        assert model[name] <= gate, (name, model[name], gate)
        assert bwd_plain[name] <= gate, (name, bwd_plain[name], gate)


@pytest.mark.parametrize("N", [145, 196])
def test_row7_models_match_jax_reference(N):
    q, k, v, _, table, region = _inputs(N, seed=5)
    nH = table.shape[0]
    scale = (q.shape[1] // nH) ** -0.5
    dense = _dense(table, region)
    want = np.asarray(jpwa._reference_attention(
        jnp.asarray(_qkv(q, k, v, N).numpy()), jnp.asarray(dense.numpy()), nH,
        scale)).reshape(q.shape)
    got16 = _fwd(q, k, v, table, region, N, scale, bf16=True, split_p=True)
    assert np.abs(got16.numpy() - want).max() <= 2 ** -16 * v.abs().max().item()
    got32 = _fwd(q, k, v, table, region, N, scale, bf16=False).numpy()
    s = np.abs(want).max()
    np.testing.assert_allclose(got32 / s, want / s, rtol=FP32_TOL,
                               atol=FP32_TOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_a1_plain_matches_jax_xla_window_attention(shifted):
    """window_attention_plain (A1's function) and its autograd (A2's) at
    W=14 against esvit_tpu's WindowAttention on its XLA route, fp32, on
    two 28 x 28 token images: the output, dx and the rel-pos table's
    gradient (the dense bias's gathered back) within 2e-5."""
    H, ws, C, nH = 28, 14, 64, 2
    N, ss = ws * ws, ws // 2 if shifted else 0
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, N, C)).astype(np.float32)
    wqkv = (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32)
    bqkv = (0.1 * rng.normal(size=3 * C)).astype(np.float32)
    table = (0.3 * rng.normal(size=((2 * ws - 1) ** 2, nH))).astype(np.float32)
    g = rng.normal(size=(8, N, C)).astype(np.float32)
    module = JWindowAttention(dim=C, window_size=ws, num_heads=nH,
                              attention_impl="xla")
    mask = jwops.shifted_window_mask(H, H, ws, ss) if shifted else None

    def jax_loss(x, table):
        params = {"relative_position_bias_table": table,
                  "qkv": {"kernel": jnp.asarray(wqkv), "bias": jnp.asarray(bqkv)},
                  "proj": {"kernel": jnp.eye(C), "bias": jnp.zeros(C)}}
        out, _ = module.apply({"params": params}, x, mask=mask)
        return (out * g).sum(), out

    (_, j_out), (j_dx, j_dt) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                                 jnp.asarray(table))
    tx, tt = (torch.tensor(a, requires_grad=True) for a in (x, table))
    qkv = tx.reshape(-1, C) @ torch.from_numpy(wqkv) + torch.from_numpy(bqkv)
    q2, k2, v2 = (t.contiguous() for t in qkv.split(C, dim=-1))
    idx = torch.from_numpy(twops.relative_position_index(ws, ws)).long()
    bias = tt[idx].permute(2, 0, 1)
    region = (torch.from_numpy(twops.window_region_ids(H, H, ws, ss))
              if shifted else None)
    out = wa.window_attention_plain(q2, k2, v2, bias, region, N, nH,
                                    (C // nH) ** -0.5)
    out.backward(torch.from_numpy(g).reshape(-1, C))
    for name, a, b in (("out", out.detach().reshape(x.shape), j_out),
                       ("dx", tx.grad, j_dx), ("dtable", tt.grad, j_dt)):
        b = np.asarray(b)
        s = np.abs(b).max()
        np.testing.assert_allclose(a.numpy() / s, b / s, rtol=2e-5,
                                   atol=2e-5, err_msg=name)


# Launch plans of the large tile: (windows B_, N, hd, heads, window types,
# itemsize, SMs). Swin-T W=14's 224 px stages 0 (unshifted and shifted),
# 1 and 2 in bf16, the 96 px augmented stage 1 in fp32, a ragged window
# count at N=256 with head dim 64, and a small card.
PLANS = [
    (1024, 196, 32, 3, 1, 2, 132),
    (1024, 196, 32, 3, 16, 2, 132),
    (256, 196, 32, 6, 4, 2, 132),
    (64, 196, 32, 12, 1, 2, 132),
    (256, 145, 32, 6, 1, 4, 132),
    (37, 256, 64, 2, 1, 2, 132),
    (40, 100, 24, 2, 8, 4, 2),
]


def large_blocks(plan, B_, nH, types):
    """Yields (block x, block y, window, head, partial index within head) as
    both large-tile kernels map them: block (x, y = h * types + t) takes
    the windows w = i * types + t for i in [x * run, (x + 1) * run), and
    the backward's block writes partial t * chunks + x of head h."""
    per_type = B_ // types
    for x in range(plan.chunks):
        for y in range(nH * types):
            t, h = y % types, y // types
            for i in range(x * plan.run, min((x + 1) * plan.run, per_type)):
                yield x, y, i * types + t, h, t * plan.chunks + x


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("case", PLANS)
def test_large_blocks_cover_each_window_and_head_once(case, backward):
    B_, N, hd, nH, types, itemsize, sms = case
    plan = wa.tile_plan(B_, N, hd, nH, types, itemsize, sms, backward)
    assert 1 <= plan.warps <= min(16, -(-N // 16)) and 1 <= plan.run <= 8
    assert plan.smem == wa.tile_smem_bytes(N, hd, itemsize, plan.warps,
                                           backward)
    assert plan.smem <= wa._BLOCK_SMEM_MAX
    per_type = B_ // types
    assert (plan.chunks - 1) * plan.run < per_type <= plan.chunks * plan.run
    seen, parts = {}, set()
    for _, _, w, h, part in large_blocks(plan, B_, nH, types):
        seen[w, h] = seen.get((w, h), 0) + 1
        parts.add((h, part))
    assert seen == {(w, h): 1 for w in range(B_) for h in range(nH)}
    assert parts == {(h, c) for h in range(nH)
                     for c in range(wa.bwd_partials(plan, types))}


@pytest.mark.parametrize("N,hd,itemsize,backward,want", [
    # bf16 forward: three 196 x 40 tiles (47104 with rounding), the
    # region ids (896) and the staged 196 x 196 fp32 bias slice (153728);
    # backward: four tiles (62720), the row constants 3 x 196 floats
    # (2432), the ids, the slice
    (196, 32, 2, False, 47104 + 896 + 153728),
    (196, 32, 2, True, 62720 + 2432 + 896 + 153728),
    # fp32: 196 x 36 tiles, the ids and each of four warps' 16 x 68
    # scratch; the slice does not fit beside them
    (196, 32, 4, False, 84736 + 896 + 4 * 16 * 68 * 4),
    # ... at N=145 it does (145 x 148 floats, 85888 with rounding)
    (145, 32, 4, True, 83584 + 1792 + 640 + 4 * 16 * 68 * 4 + 85888),
    # N=256: its 256 x 260 slice never fits
    (256, 64, 2, True, 4 * 256 * 72 * 2 + 3072 + 1024),
])
def test_large_tile_smem_bytes_counts_the_layout(N, hd, itemsize, backward,
                                                 want):
    assert wa.tile_smem_bytes(N, hd, itemsize, 4, backward) == want
    staged = wa.large_bias_staged(N, hd, itemsize, 4, backward)
    assert staged == (N < 256 and (itemsize == 2 or N == 145))


def test_shape_rules_admit_what_fits():
    """The large tile takes 64 < N <= 256 where a one-warp block of the
    pass fits in both dtypes with a whole score row's fp32 scratch (the
    rule since the tile was written; the block it launches needs less):
    the fused rule and the packed pair's (rows 3-4, trained through) ask
    the backward's, row 7's (forward only) the forward's. Every plan of an
    admitted shape fits."""
    for N in (65, 100, 145, 196, 256, 257):
        for hd in (16, 32, 48, 64):
            fits = {bw: N <= 256 and all(
                wa._large_base_bytes(N, hd, it, 0, bw)
                + (16 * (8 * -(-N // 8) + 4) * 4 if it == 4 else 0)
                <= wa._BLOCK_SMEM_MAX for it in (2, 4))
                for bw in (False, True)}
            assert fb.supports(N, hd * 4, 4, 16 * hd * 2) == fits[True]
            assert pwa.supports(N, hd * 4, 4) == fits[False]
            assert wa.supports(N, hd * 4, 4) == fits[True]
            for bw in (False, True):
                if fits[bw]:
                    for itemsize in (2, 4):
                        plan = wa.tile_plan(64, N, hd, 4, 1, itemsize,
                                            backward=bw)
                        assert plan.smem <= wa._BLOCK_SMEM_MAX
    assert fb.supports(196, 96, 3, 384) and not fb.supports(256, 128, 2, 512)


@pytest.mark.parametrize("N", [1, 37, 49, 64, 65, 145, 196, 256, 257])
def test_packed_pair_rule_is_the_fused_attention_rule(N):
    """Rows 3-4 take N <= 64 on the small tiles and 64 < N <= 256 where
    the large tile's backward block fits (the rule of the block-fused
    pair's attention halves), at every head dim up to 64; a head dim
    above 64 or not dividing C, never."""
    for hd in (8, 16, 24, 32, 48, 64):
        want = N <= wa._SMALL_MAX_N or (N <= wa._LARGE_MAX_N
                                         and wa.large_tile_fits(N, hd, True))
        assert wa.supports(N, 4 * hd, 4) == want, hd
    assert not wa.supports(N, 4 * 80, 4) and not wa.supports(N, 100, 3)
    assert wa.supports(N, 512, 16) == (N <= 256)        # Swin-B stage 2


def test_dbias_partials_at_swin_w14_shapes():
    """The backward's dbias partials, one (N, N) fp32 slice per block, stay
    under 64 MB a launch at every Swin-T W=14 block of the step (B = 64
    images at 224 px, 256 at 96; the shifted blocks' window types)."""
    for B_, N, nH, types in ((1024, 196, 3, 1), (1024, 196, 3, 16),
                             (256, 196, 6, 1), (256, 196, 6, 4),
                             (64, 196, 12, 1), (1024, 196, 3, 4),
                             (256, 145, 6, 1)):
        plan = wa.tile_plan(B_, N, 32, nH, types, 2, backward=True)
        nbytes = nH * wa.bwd_partials(plan, types) * N * N * 4
        assert nbytes <= 64 << 20, (B_, N, nH, types, plan, nbytes)


@pytest.mark.parametrize("name,group", [
    ("void wtile::window_attention_large_kernel<__nv_bfloat16, "
     "FusedBlockBias, 2, true>(wtile::Operands<__nv_bfloat16>, "
     "FusedBlockBias, wtile::Geometry)", "fused"),
    ("void wtile::window_attention_large_bwd_kernel<float, "
     "FusedBlockBias, 4, false>(wtile::BwdOperands<float>, "
     "FusedBlockBias, wtile::Geometry)", "fused"),
    ("void wtile::window_attention_large_kernel<float, (anonymous namespace)"
     "::DenseBias, 2, false>(wtile::Operands<float>, (anonymous namespace)::"
     "DenseBias, wtile::Geometry)", "window"),
])
def test_profile_files_the_large_tile_by_its_caller(name, group):
    """utils/profile.py files the large tile's kernels as it files the
    small ones: the fused block's attention halves (FusedBlockBias) under
    the fused block, row 7's under window attention."""
    from esvit_tpu_torch.utils.profile import _kernel_group

    assert _kernel_group(name) == {
        "fused": "fused block (this repo's CUDA)",
        "window": "window attention (this repo's CUDA)"}[group]


def test_build_compiles_each_source_apart_then_links(tmp_path, monkeypatch):
    """A library's sources (csrc/<name>.cu, then csrc/<name>_*.cu: the
    fused block's large-window tile is fused_block_large.cu) each go to an
    nvcc of their own, all started together, and one link joins the
    objects; the report holds each source's seconds. A stand-in nvcc here
    writes its output file and echoes its command."""
    import stat
    import sys

    from esvit_tpu_torch.ops import cuda_build

    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    for name in ("k.cu", "k_large.cu", "kk.cu", "t.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'w').write(' '.join(sys.argv[1:]))\n"
                    "print('ptxas info    : Used 8 registers', ' '.join(sys.argv[1:]))\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD", build)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    assert [p.name for p in cuda_build.sources("k", csrc)] == ["k.cu",
                                                               "k_large.cu"]
    built = cuda_build.build_all(["k", "kk"])
    lib, report = built["k"]
    assert lib.exists() and lib.name.startswith("libk_")
    linked = lib.read_text()
    assert "-shared" in linked and linked.count(".o") == 2
    for src in ("k.cu", "k_large.cu"):
        assert f"nvcc {src}: " in report and f"-c -I {csrc} -o" in report
    assert "k_large.cu" not in built["kk"][1]
    assert sorted(p.suffix for p in build.iterdir()) == [".so", ".so"]
    assert cuda_build.build_all(["k"])["k"] == (lib, "")
