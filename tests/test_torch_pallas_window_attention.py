"""The port's forward-only window attention on the qkv layout
(ops/pallas_window_attention.py) and the Swin 'pallas' route against
esvit_tpu.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do
(tests/test_pallas_window_attention.py), at shapes its block picker takes.
The port runs on the CPU, where the wrapper takes the plain version. All
fp32. Tolerances: 1e-5 for the attention function and its gradients (one
softmax of 9 columns), 1e-4 for whole-backbone outputs (float32 sums in
another order across ~10 layers, as tests/test_torch_swin.py), 1e-5 for a
train step (as tests/test_torch_step.py, with its rule for gradients below
1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.swin import SwinTransformer as JSwin
from esvit_tpu.ops import pallas_window_attention as jpwa
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import (_adam_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.models.swin import SwinTransformer as TSwin
from esvit_tpu_torch.ops import pallas_window_attention as pwa
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
MODEL_TOL = 1e-4
B_, N, C, NH = 16, 9, 8, 2


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jpwa.INTERPRET
    jpwa.INTERPRET = True
    yield
    jpwa.INTERPRET = old


def _inputs(nWm, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B_, N, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nWm, NH, N, N)).astype(np.float32)
    if nWm > 1:
        bias[1:, :, :4, 4:] -= 100.0                # a shift mask's -100
    return qkv, bias


@pytest.mark.parametrize("nWm", [1, 4])
@pytest.mark.parametrize("jax_fn", ["fused_window_attention",
                                    "_reference_attention"])
def test_plain_matches_jax(nWm, jax_fn):
    qkv, bias = _inputs(nWm)
    scale = (C // NH) ** -0.5
    want = getattr(jpwa, jax_fn)(jnp.asarray(qkv), jnp.asarray(bias), NH,
                                 scale)
    got = pwa.pallas_window_attention_plain(torch.from_numpy(qkv),
                                            torch.from_numpy(bias), NH, scale)
    assert got.shape == (B_, N, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the wrapper, on CPU tensors, is the plain version
    wrapped = pwa.fused_window_attention(torch.from_numpy(qkv),
                                         torch.from_numpy(bias), NH, scale)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


@pytest.mark.parametrize("nWm", [1, 4])
def test_gradients_match_jax(nWm):
    """d(qkv) and d(bias) of a weighted sum of the output against
    jax.grad through the kernel's custom_vjp."""
    qkv, bias = _inputs(nWm, seed=1)
    w = np.random.default_rng(2).normal(size=(B_, N, C)).astype(np.float32)
    scale = (C // NH) ** -0.5

    def loss(q, b):
        return (jpwa.fused_window_attention(q, b, NH, scale) * w).sum()

    j_dq, j_db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv),
                                                jnp.asarray(bias))
    q = torch.tensor(qkv, requires_grad=True)
    b = torch.tensor(bias, requires_grad=True)
    (pwa.fused_window_attention(q, b, NH, scale) * torch.from_numpy(w)).sum(
    ).backward()
    for got, want in ((q.grad, j_dq), (b.grad, j_db)):
        want = np.asarray(want)
        s = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / s, want / s, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("shape,ok", [
    ((49, 96, 3), True), ((49, 768, 24), True), ((64, 128, 2), True),
    ((37, 40, 5), True), ((65, 96, 3), True), ((49, 192, 2), False),
    ((49, 96, 5), False), ((196, 96, 3), True), ((256, 128, 2), True),
    ((257, 96, 3), False),
])
def test_supports(shape, ok):
    assert pwa.supports(*shape) == ok


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: the shape and
    device checks refuse it, and past them a missing kernel build raises
    (no nvcc here); the plain version is never called, nothing counts."""
    qkv = torch.empty(B_, N, 3 * C, device="meta")
    bias = torch.empty(1, NH, N, N, device="meta")
    before = dict(pwa.launches)
    monkeypatch.setattr(pwa, "pallas_window_attention_plain",
                        lambda *a: pytest.fail("fell back to plain"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pwa.fused_window_attention(qkv, bias, NH, 0.5)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(pwa, "_check", lambda *a: None)
    monkeypatch.setattr(pwa.cuda_build, "_nvcc", no_nvcc)
    pwa._lib.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        pwa.fused_window_attention(qkv, bias, NH, 0.5)
    assert pwa.launches == before


# ------------------------------------------------------- the Swin route
def _jax_swin(**kw):
    return JSwin(jcfg.swin_femto(attention_impl="pallas",
                                 fused_block_stages=(), **kw))


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((1, 32, 32, 3))
    params = jax.jit(lambda r: _jax_swin().init({"params": r}, x))(
        jax.random.PRNGKey(0))["params"]
    return jax.tree.map(np.asarray, params)


def _port(params, layout_opt=True):
    model = TSwin(tcfg.swin_femto(attention_impl="pallas",
                                  fused_block_stages=(),
                                  layout_opt=layout_opt))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def _images(size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("layout_opt", [True, False])
@pytest.mark.parametrize("size", [32, 24])
def test_forward_features_matches_jax(jax_params, size, layout_opt):
    """32 px: a shifted stage (nWm 4) and an unshifted one; 24 px: the
    padded window-major / classic stage 0 and the sub-window stage 1."""
    x = _images(size)
    jpwa_calls = []
    real = jpwa._forward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpwa, "_forward",
                   lambda *a: jpwa_calls.append(1) or real(*a))
        j_cls, j_region = _jax_swin(layout_opt=layout_opt).apply(
            {"params": jax_params}, jnp.asarray(x))
    model = _port(jax_params, layout_opt)
    assert len(jpwa_calls) == model.pallas_window_attention_calls(size)
    with torch.no_grad():
        t_cls, t_region = model.forward_features(torch.from_numpy(x))
    np.testing.assert_allclose(t_region.numpy(), np.asarray(j_region),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("size", [32, 24])
def test_forward_return_n_last_blocks_matches_jax(jax_params, size, n):
    """The classic block loop of every stage (capture='features'),
    through the kernel's route and, at 24 px, the sub-window stage."""
    x = _images(size, 1)
    want = _jax_swin().apply({"params": jax_params}, jnp.asarray(x), n,
                             method=JSwin.forward_return_n_last_blocks)
    model = _port(jax_params)
    with torch.no_grad():
        got = model.forward_return_n_last_blocks(torch.from_numpy(x), n)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_forward_selfattention_matches_jax(jax_params, n):
    """Attention maps from the plain path: the last block's (n=1) or every
    block's, shifted ones included, at 24 px (padded stage 0, and stage 1
    in a padded window, which capture keeps off the sub-window path)."""
    x = _images(24, 2)
    want = _jax_swin().apply({"params": jax_params}, jnp.asarray(x), n,
                             method=JSwin.forward_selfattention)
    model = _port(jax_params)
    with torch.no_grad():
        got = model.forward_selfattention(torch.from_numpy(x), n)
    if n == 1:
        got, want = [got], [want]
    assert len(got) == len(want) == (1 if n == 1 else 4)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=MODEL_TOL,
                                   atol=MODEL_TOL)


def test_capture_is_checked():
    model = TSwin(tcfg.swin_femto(attention_impl="pallas"))
    with pytest.raises(ValueError, match="capture"):
        model.layers[0](torch.zeros(1, 64, 16), capture="tokens")


# ------------------------------------------------------- one train step
TINY_GRAD = 1e-7
TINY_GRAD_TOL = 1e-4


def test_train_step_matches_jax():
    """One fp32 step of the femto model on the 'pallas' route (32 px and
    24 px crops) from the same state: loss, centers, and the AdamW moments
    (the gradients; the step-0 lr is 0 in warm-up) within 1e-5."""
    common = dict(steps_per_epoch=2)
    head = dict(out_dim=32, hidden_dim=16, bottleneck_dim=8)
    optim = dict(lr=1e-3, epochs=4, warmup_epochs=1,
                 freeze_last_layer_epochs=1)
    jc = jcfg.TrainConfig(
        model=jcfg.swin_femto(attention_impl="pallas", fused_block_stages=(),
                              drop_path_rate=0.0),
        head=jcfg.HeadConfig(**head),
        loss=jcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=jcfg.OptimConfig(**optim), dtype=jnp.float32, **common)
    tc = tcfg.TrainConfig(
        model=tcfg.swin_femto(attention_impl="pallas", fused_block_stages=(),
                              drop_path_rate=0.0),
        head=tcfg.HeadConfig(**head),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=tcfg.OptimConfig(**optim), dtype=torch.float32, **common)
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             rng.normal(size=(8, 24, 24, 3)).astype(np.float32))
    jt = JTrainer(jc, total_batch_size=256)
    jb = tuple(map(jnp.asarray, batch))
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    tt = TTrainer(tc, total_batch_size=256, device="cpu")
    tstate = train_state_from_jax(jax.device_get(state), tt)
    state, m = jax.jit(jt.train_step)(state, jb, jax.random.PRNGKey(1))
    state = jax.device_get(state)
    tstate, tm = tt.train_step(tstate, tuple(map(torch.from_numpy, batch)))

    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]), rtol=TOL,
                               atol=TOL)
    for a, b in zip(tstate.centers, state.centers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    adam = _adam_state(state.opt_state)
    grad = {k: np.sqrt(v.numpy() / (1 - 0.999))
            for k, v in state_dict_from_flax(adam.nu).items()}
    for part, want_tree, got in (
            ("student", state.student, tstate.student.state_dict()),
            ("mu", adam.mu, tstate.mu),
            ("nu", adam.nu, tstate.nu)):
        want = state_dict_from_flax(want_tree)
        assert set(want) == set(got)
        for name, w in want.items():
            g, w = got[name].numpy(), w.numpy()
            if part == "nu":
                g, w = np.sqrt(g), np.sqrt(w)
            tiny = grad[name] < TINY_GRAD
            np.testing.assert_allclose(g[~tiny], w[~tiny], rtol=TOL, atol=TOL,
                                       err_msg=f"{part} {name}")
            np.testing.assert_allclose(g[tiny], w[tiny], rtol=TINY_GRAD_TOL,
                                       atol=TINY_GRAD_TOL,
                                       err_msg=f"{part} {name} (tiny grad)")
