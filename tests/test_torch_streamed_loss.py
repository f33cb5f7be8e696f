"""The port's K-streamed DDINO loss (esvit_tpu_torch/losses.py
``ddino_loss_streamed``) against esvit_tpu's and against the port's dense
loss, on the same random bottlenecks and last layers (K = 64).

- fp32: value, both centres and the gradients of the student's
  bottlenecks and of both student last layers within 1e-5 of
  esvit_tpu.losses.ddino_loss_streamed; the same for every chunk count;
  equal to the port's ``ddino_loss`` of the heads' logits.
- bf16 bottlenecks and weights: within esvit_tpu's own bf16 tolerance
  (tests/test_loss_streamed.py, 2e-2) of its streamed loss.
- What backward keeps: no saved tensor is (rows, K) or a chunk of it.
- Over two processes (a stand-in mesh that all-reduces two equal
  shares) the centres are the global batch's, as the dense loss's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import losses as jlosses
from esvit_tpu_torch import losses as tlosses
from esvit_tpu_torch.parallel.mesh import Mesh
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
B, D, K, C = 3, 16, 64, 8
NCROPS, NT, NL = 4, 4, 2
S = 2 * NT + (NCROPS - 2) * NL
T_TEMP = 0.04


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.normal(size=shape)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    arrays = dict(
        s_cls_z=unit(NCROPS * B, D), s_reg_z=unit(B, S, D),
        t_cls_z=unit(2 * B, D), t_reg_z=unit(B, 2 * NT, D),
        s_fea=rng.normal(size=(B, S, C)).astype(np.float32),
        t_fea=rng.normal(size=(B, 2 * NT, C)).astype(np.float32))
    # (D, K) as esvit_tpu stores them: student/teacher x cls/dense head.
    w = (rng.normal(size=(4, D, K)) * D ** -0.5).astype(np.float32)
    centers = (0.1 * rng.normal(size=(2, K))).astype(np.float32)
    return arrays, w, centers


def _jax(arrays, w, centers, dtype=jnp.float32, n_chunks=4):
    """esvit_tpu's loss, new centres and the gradients of s_cls_z, s_reg_z
    and both student weights."""
    a = {k: jnp.asarray(v, dtype) for k, v in arrays.items()}
    c = jlosses.DinoCenters(*map(jnp.asarray, centers))

    def f(s_cls_z, s_reg_z, ws, wsd):
        return jlosses.ddino_loss_streamed(
            s_cls_z, s_reg_z, a["s_fea"], a["t_cls_z"], a["t_reg_z"],
            a["t_fea"], ws.astype(dtype), c, jnp.float32(T_TEMP),
            ncrops=NCROPS, batch_size=B, npatch=(NT, NL), t_npatch=NT,
            w_t=jnp.asarray(w[1], dtype), w_s_dense=wsd.astype(dtype),
            w_t_dense=jnp.asarray(w[3], dtype), n_chunks=n_chunks)

    (loss, cent), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                             has_aux=True)(
        a["s_cls_z"], a["s_reg_z"], jnp.asarray(w[0]), jnp.asarray(w[2]))
    return (float(loss), [np.asarray(x) for x in cent],
            [np.asarray(g, np.float32) for g in grads])


def _port(arrays, w, centers, dtype=torch.float32, n_chunks=4, mesh=None,
          dense=False):
    """The port's streamed (or dense) loss, centres and the same
    gradients (the weights' transposed back to (D, K))."""
    t = {k: torch.tensor(v).to(dtype) for k, v in arrays.items()}
    s_cls_z = t["s_cls_z"].requires_grad_()
    s_reg_z = t["s_reg_z"].requires_grad_()
    ws = torch.tensor(w[0].T.copy(), requires_grad=True)
    wsd = torch.tensor(w[2].T.copy(), requires_grad=True)
    wt, wtd = (torch.tensor(w[i].T.copy()).to(dtype) for i in (1, 3))
    c = tlosses.DinoCenters(*map(torch.tensor, centers))
    if dense:
        student = (s_cls_z @ ws.to(dtype).t(), s_reg_z @ wsd.to(dtype).t(),
                   t["s_fea"], (NT, NL))
        teacher = (t["t_cls_z"] @ wt.t(), t["t_reg_z"] @ wtd.t(), t["t_fea"],
                   (NT,))
        loss, cent = tlosses.ddino_loss(student, teacher, c, T_TEMP,
                                        ncrops=NCROPS, batch_size=B, mesh=mesh)
    else:
        loss, cent = tlosses.ddino_loss_streamed(
            s_cls_z, s_reg_z, t["s_fea"], t["t_cls_z"], t["t_reg_z"],
            t["t_fea"], ws.to(dtype), c, T_TEMP, ncrops=NCROPS, batch_size=B,
            npatch=(NT, NL), t_npatch=NT, w_t=wt, w_s_dense=wsd.to(dtype),
            w_t_dense=wtd, n_chunks=n_chunks, mesh=mesh)
    grads = torch.autograd.grad(loss, (s_cls_z, s_reg_z, ws, wsd))
    grads = [g.float().numpy() for g in grads]
    grads[2], grads[3] = grads[2].T, grads[3].T
    return float(loss.detach()), [x.numpy() for x in cent], grads


@pytest.fixture(scope="module")
def case():
    arrays, w, centers = _inputs()
    return arrays, w, centers, _jax(arrays, w, centers)


def _close(got, want, tol, name):
    """Within tol of the largest |value| of want."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


def _check(got, want, tol):
    (gl, gc, gg), (wl, wc, wg) = got, want
    np.testing.assert_allclose(gl, wl, rtol=tol, err_msg="loss")
    for name, a, b in zip(("center", "center_grid"), gc, wc):
        _close(a, b, tol, name)
    for name, a, b in zip(("d s_cls_z", "d s_reg_z", "d w_cls", "d w_dense"),
                          gg, wg):
        _close(a, b, tol, name)


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
def test_streamed_matches_esvit_tpu_at_every_chunk_count(case, n_chunks):
    arrays, w, centers, want = case
    _check(_port(arrays, w, centers, n_chunks=n_chunks), want, TOL)


def test_streamed_equals_the_ports_dense_loss(case):
    arrays, w, centers, _ = case
    _check(_port(arrays, w, centers), _port(arrays, w, centers, dense=True),
           TOL)


def test_streamed_bf16_within_esvit_tpus_tolerance():
    """bf16 bottlenecks and weights: the port rounds each chunk's logits to
    bf16 as its dense head does (esvit_tpu keeps them fp32), inside
    esvit_tpu's own bf16 tolerance of 2e-2."""
    arrays, w, centers = _inputs(seed=1)
    want = _jax(arrays, w, centers, dtype=jnp.bfloat16)
    got = _port(arrays, w, centers, dtype=torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2)
    for a, b in zip(got[1], want[1]):
        _close(a, b, 2e-2, "center")
    assert all(np.isfinite(g).all() for g in got[2])


def test_backward_keeps_no_k_wide_tensor():
    """No tensor saved for backward while the loss is built is (rows, K)
    or (rows, K / chunks): each chunk's logits are recomputed in
    backward. The (K, D) weights and (K,) centres are saved as they
    are."""
    arrays, w, centers = _inputs()
    big = 4096                      # K large beside every other width
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(4, D, big)) * D ** -0.5).astype(np.float32)
    centers = np.zeros((2, big), np.float32)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        t = {k: torch.tensor(v) for k, v in arrays.items()}
        ws = torch.tensor(w[0].T.copy(), requires_grad=True)
        loss, _ = tlosses.ddino_loss_streamed(
            t["s_cls_z"].requires_grad_(), t["s_reg_z"].requires_grad_(),
            t["s_fea"], t["t_cls_z"], t["t_reg_z"], t["t_fea"], ws,
            tlosses.DinoCenters(*map(torch.tensor, centers)), T_TEMP,
            ncrops=NCROPS, batch_size=B, npatch=(NT, NL), t_npatch=NT,
            n_chunks=8)
    loss.backward()
    assert shapes
    # (rows, K) tensors: at least 2-D with a K-chunk-wide axis, other than
    # the (K, D) weights and their chunks.
    wide = [s for s in shapes if len(s) > 1 and any(d >= big // 8 for d in s)
            and s not in ((big, D), (big // 8, D))]
    assert not wide, wide
    assert torch.isfinite(ws.grad).all()


@dataclasses.dataclass(frozen=True)
class _TwoEqualShares(Mesh):
    """A stand-in mesh of two data processes holding the same batch: its
    all-reduce doubles every sum."""
    world: int = 2
    distributed: bool = True

    def _reduce_(self, flat, over, op):
        flat.mul_(2)


def test_centres_are_global_over_processes(case):
    """Two equal shares give the one-process centres, through the mesh's
    all-reduce, as the dense loss's do."""
    arrays, w, centers, want = case
    got = _port(arrays, w, centers, mesh=_TwoEqualShares())
    dense = _port(arrays, w, centers, mesh=_TwoEqualShares(), dense=True)
    for a, b, c in zip(got[1], want[1], dense[1]):
        _close(a, b, TOL, "center vs one process")
        _close(a, c, TOL, "center vs dense")
