"""The port's block-fused Swin route against esvit_tpu's, on the CPU.

Three levels, fp32, inputs from ``np.random.default_rng``:

- Kernel: ``esvit_tpu_torch.ops.fused_block.fused_swin_block_plain`` (what
  the CUDA pair computes, and what a CPU tensor runs) against
  ``esvit_tpu.ops.fused_block.fused_swin_block(..., interpret=True)``:
  the output, dx and all 17 parameter gradients. The port's rows are
  unpadded window-major; they are scattered into the JAX kernel's padded
  layout as tests/test_fused_block.py:140-144 does. Tolerances as
  tests/test_fused_block.py:150-160: the output rtol 1e-5 / atol 2e-5,
  every gradient rtol 1e-4 / atol 1e-5 x the largest gradient.
- Model: the Swin backbone with fused stages (0, 1) against JAX's fused
  route in interpret mode, same weights (io/jax_params.py), at 56 px (full
  windows), 40 px (spatial pad, then the augmented window) and 24 px (the
  augmented window in both stages). Tolerance 1e-4 as
  tests/test_torch_swin.py.
- Train step: one fp32 step with drop-path on, fused stages against the
  port's own window-attention route, same weights and the same generator:
  the routes draw the same drop-path masks, so params, teacher and AdamW
  moments agree within 1e-5.

Beside them, what the wrapper decides on the host: Swin-T's routes and
kernel calls per forward at 224 and 96 px, the sub-window priority, the
shape rule, the weight operands' layouts, and that no tensor but a CPU
one takes the plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.swin import SwinTransformer as JSwin
from esvit_tpu.models.swin import _subwindow_bias_parts as j_subwindow_bias
from esvit_tpu.models.swin import _subwindow_geometry as j_subwindow_geometry
from esvit_tpu.ops import fused_block as jfb
from esvit_tpu.ops import window as jwops
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models.swin import SwinTransformer as TSwin
from esvit_tpu_torch.ops import fused_block as tfb
from esvit_tpu_torch.ops import window as twops
from esvit_tpu_torch.train.step import EsViTTrainer
from tests.torch_threads import one_intra_op_thread  # noqa: F401

NAMES = ("g1", "be1", "wq", "bq", "wk", "bk", "wv", "bv", "bias", "wp", "bp",
         "g2", "be2", "w1", "b1", "w2", "b2")


def _params(rng, C, M, nH, N):
    r = rng.normal
    return {k: np.asarray(v, np.float32) for k, v in dict(
        g1=1 + 0.1 * r(size=C), be1=0.1 * r(size=C),
        wq=r(size=(C, C)) * C ** -0.5, bq=0.02 * r(size=C),
        wk=r(size=(C, C)) * C ** -0.5, bk=0.02 * r(size=C),
        wv=r(size=(C, C)) * C ** -0.5, bv=0.02 * r(size=C),
        bias=0.05 * r(size=(nH, N, N)),
        wp=r(size=(C, C)) * C ** -0.5, bp=0.02 * r(size=C),
        g2=1 + 0.1 * r(size=C), be2=0.1 * r(size=C),
        w1=r(size=(C, M)) * C ** -0.5, b1=0.02 * r(size=M),
        w2=r(size=(M, C)) * M ** -0.5, b2=0.02 * r(size=C)).items()}


def _window_case(rng, B, H, ws, C, nH, shift, padded):
    """A window-major case: (x, params, N, nW, region, port pad, padded
    layout pad, real slots in the padded layout, padded rows per image)."""
    Hp = -(-H // ws) * ws
    N, nW = ws * ws, (Hp // ws) ** 2
    Np = jwops.padded_window_tokens(ws)
    ss = ws // 2 if shift else 0
    x = (0.5 * rng.normal(size=(B, nW * N, C))).astype(np.float32)
    p = _params(rng, C, 4 * C, nH, N)
    region = jwops.window_region_ids(H, H, ws, ss) if shift else None
    pad = twops.pad_token_mask(H, H, Hp, Hp, ws, ss) if padded else None
    pad_p = (jwops.pad_token_mask_padded(H, H, Hp, Hp, ws, ss)
             if padded else None)
    slots = (np.arange(nW)[:, None] * Np + np.arange(N)[None, :]).reshape(-1)
    return x, p, N, nW, region, pad, pad_p, slots, nW * Np


def _augmented_case(rng, B, H, ws, C, nH, shift):
    """The augmented window of an H x H stage in one ws x ws window: H*H
    real tokens and the virtual pad token, its bias built as the JAX model
    builds it (swin.py:354-361) from a random rel-pos table."""
    L = H * H
    N, Np = L + 1, -(-(L + 1) // 8) * 8
    x = (0.5 * rng.normal(size=(B, N, C))).astype(np.float32)
    x[:, L] = 0.0
    p = _params(rng, C, 4 * C, nH, N)
    table = jnp.asarray(0.5 * rng.normal(size=((2 * ws - 1) ** 2, nH)),
                        jnp.float32)
    geo = j_subwindow_geometry(H, H, ws, ws // 2 if shift else 0)
    bias_real, log_s = j_subwindow_bias(table, ws, *geo)
    bias = np.zeros((nH, N, N), np.float32)
    bias[:, :L, :L] = np.asarray(bias_real).transpose(2, 0, 1)
    bias[:, :L, L] = np.asarray(log_s).T
    p["bias"] = bias
    pad = np.ones(N, np.float32)
    pad[L] = 0.0
    pad_p = np.zeros(Np, np.float32)
    pad_p[:L] = 1.0
    return x, p, N, 1, None, pad, pad_p, np.arange(N), Np


KERNEL_CASES = [
    # B, H, ws, C, nH, shift, padded, drop-path
    pytest.param(2, 14, 7, 32, 2, False, False, False, id="plain"),
    pytest.param(2, 14, 7, 32, 2, True, False, False, id="shift"),
    pytest.param(2, 12, 7, 32, 2, True, True, False, id="pad+shift"),
    pytest.param(4, 7, 7, 32, 2, False, False, True, id="drop-path"),
    pytest.param(2, 14, 7, 64, 8, True, False, False, id="multi-head"),
    pytest.param(3, 6, 7, 32, 2, True, None, True, id="augmented"),
]


@pytest.mark.parametrize("B,H,ws,C,nH,shift,padded,dp", KERNEL_CASES)
def test_fused_block_plain_matches_jax_kernel(B, H, ws, C, nH, shift, padded,
                                              dp):
    rng = np.random.default_rng(0)
    if padded is None:
        case = _augmented_case(rng, B, H, ws, C, nH, shift)
    else:
        case = _window_case(rng, B, H, ws, C, nH, shift, padded)
    x, p, N, nW, region, pad, pad_p, slots, Lp = case
    dout = rng.normal(size=x.shape).astype(np.float32)
    keep = ((None, None) if not dp else
            tuple(np.where(rng.random(B) < 0.5, 0.0, 2.0).astype(np.float32)
                  for _ in range(2)))
    if dp:
        assert (keep[0] == 0).any() or (keep[1] == 0).any()
    scale = (C // nH) ** -0.5

    sl = jnp.asarray(slots)
    dp_k = tuple(None if k is None else jnp.asarray(np.broadcast_to(
        k[:, None, None], (B, 8, C)).reshape(-1, C)) for k in keep)

    def f_jax(x, p):
        xp = jnp.zeros((B, Lp, C), jnp.float32).at[:, sl, :].set(x)
        out = jfb.fused_swin_block(xp, p, *dp_k, N=N, nH=nH, nW=nW,
                                   scale=scale, region=region, pad=pad_p,
                                   eps=1e-6, interpret=True)
        return out[:, sl, :]

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    j_out, vjp = jax.vjp(f_jax, jnp.asarray(x), jp)
    j_dx, j_dp = vjp(jnp.asarray(dout))

    xt = torch.tensor(x, requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    out = tfb.fused_swin_block(
        xt, pt, *(None if k is None else torch.from_numpy(k) for k in keep),
        N=N, nH=nH, nW=nW, scale=scale,
        region=None if region is None else torch.from_numpy(region),
        pad=None if pad is None else torch.from_numpy(pad), eps=1e-6)
    out.backward(torch.from_numpy(dout))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=2e-5)
    want = {"x": np.asarray(j_dx), **{k: np.asarray(v) for k, v in j_dp.items()}}
    got = {"x": xt.grad.numpy(), **{k: t.grad.numpy() for k, t in pt.items()}}
    assert set(want) == {"x", *NAMES}
    gscale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-5 * gscale, err_msg=f"d{k}")


def _model_cfgs():
    base = dict(img_size=56, window_size=7, embed_dim=32, depths=(2, 2),
                num_heads=(2, 4), drop_path_rate=0.0)
    j = dataclasses.replace(jcfg.swin_tiny(), **base, attention_impl="xla",
                            fused_block_stages=(0, 1),
                            fused_block_interpret=True)
    return j, tcfg.SwinConfig(**base, fused_block_stages=(0, 1))


@pytest.fixture(scope="module")
def jax_swin():
    jc, _ = _model_cfgs()
    model = JSwin(jc)
    x = jnp.zeros((1, 56, 56, 3), jnp.float32)
    params = jax.jit(lambda r: model.init({"params": r}, x))(
        jax.random.PRNGKey(0))["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("size,routes", [
    (56, ["fused", "fused"]),
    (40, ["fused", "fused_subwindow"]),
    (24, ["fused_subwindow", "fused_subwindow"]),
])
def test_fused_model_matches_jax(jax_swin, size, routes):
    model, params = jax_swin
    _, tc = _model_cfgs()
    ours = TSwin(tc)
    ours.load_state_dict(state_dict_from_flax(params), strict=True)
    assert [r for *_, r in ours._stage_routes(size)] == routes
    assert ours.fused_block_calls(size) == 4
    assert ours.window_attention_calls(size) == 0
    x = np.random.default_rng(size).normal(
        size=(2, size, size, 3)).astype(np.float32)
    j_cls, j_region = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        t_cls, t_region = ours.forward_features(torch.from_numpy(x))
    np.testing.assert_allclose(t_region.numpy(), np.asarray(j_region),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def swin_t():
    return TSwin(tcfg.swin_tiny())


# Swin-T W=7 at the slice's crop sizes: each stage's route and the kernel
# calls of one forward, as the reference routes them (esvit_tpu
# models/swin.py:677-691). 96 px: stage 2 is 6x6 tokens in one 7x7 window
# (the augmented window); stage 3 is 3x3 tokens and not a fused stage.
@pytest.mark.parametrize("size,stages,routes,fused,attn", [
    (224, (0, 1, 2), ["fused", "fused", "fused", "window_major"], 10, 2),
    (96, (0, 1, 2), ["fused", "fused", "fused_subwindow", "classic"], 10, 0),
    (224, (), ["window_major"] * 4, 0, 12),
    (96, (), ["window_major", "window_major", "classic", "classic"], 0, 4),
])
def test_swin_t_routes_and_kernel_calls(swin_t, size, stages, routes, fused,
                                        attn):
    for stage, on in zip(swin_t.layers, range(4)):
        stage.fused = stage.subwindow_fused = on in stages
    try:
        assert [r for *_, r in swin_t._stage_routes(size)] == routes
        assert swin_t.fused_block_calls(size) == fused
        assert swin_t.window_attention_calls(size) == attn
    finally:
        for stage, on in zip(swin_t.layers, range(4)):
            stage.fused = stage.subwindow_fused = on in (0, 1, 2)


@pytest.mark.parametrize("kw,route", [
    ({}, "fused_subwindow"),
    # Sub-window stages not fused: the per-block virtual-column path.
    ({"subwindow_fused_stages": ()}, "classic"),
    # No fused stages: subwindow_fused_stages=None follows them.
    ({"fused_block_stages": ()}, "classic"),
])
def test_subwindow_route_priority(kw, route):
    model = TSwin(dataclasses.replace(tcfg.swin_tiny(**kw),
                                      depths=(2, 2, 2, 2)))
    assert model.layers[2].route(6 * 6) == route


@pytest.mark.parametrize("N,C,nH,M,ok", [
    (49, 96, 3, 384, True),
    (49, 192, 6, 768, True),
    (49, 384, 12, 1536, True),
    (37, 384, 12, 1536, True),      # the augmented window
    (49, 768, 24, 3072, False),     # stage 3: more channels than C <= 512
    (16, 768, 24, 3072, False),     # more channels than a LayerNorm row holds
    (64, 192, 6, 768, True),        # C <= 192 and head dim 32
    (64, 384, 12, 1536, True),      # N > 49 and C > 192: no two-of-three rule
    (49, 192, 3, 768, True),        # C <= 192 and N <= 49, head dim 64
    (64, 192, 3, 768, True),        # N > 49, head dim 64
    (65, 96, 3, 384, True),         # the large-window tile from N = 65
    (49, 96, 4, 384, False),        # head dim 24, not a multiple of 16
    (49, 96, 3, 320, False),        # MLP width not a multiple of the chunk
    (196, 384, 12, 1536, True),     # Swin-T W=14 stage 2
    (145, 192, 6, 768, True),       # the 96 px W=14 augmented window
    (256, 128, 2, 512, False),      # N=256, head dim 64: no fp32 backward block
    (257, 96, 3, 384, False),       # more tokens than the large tile holds
    (49, 512, 16, 2048, True),      # Swin-S / Swin-B stage 2 at W=7
    (196, 512, 16, 2048, True),     # Swin-B W=14 stage 2
    (37, 512, 16, 2048, True),      # its 96 px augmented window
    (49, 544, 17, 2176, False),     # a LayerNorm row wider than 512
])
def test_supports_is_a_shape_rule(N, C, nH, M, ok):
    assert tfb.supports(N, C, nH, M) is ok


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_operands_are_head_major(dtype):
    """The kernels' q/k/v weights: the [in][out] copy is [wq | wk | wv]
    (QKV's and the backward's dq | dk | dv column order, heads hd wide in
    each third) and the [out][in] copy its transpose, so row part*C + h*hd
    + j of it is column h*hd + j of wq, wk or wv; every operand is
    contiguous in x's dtype or fp32. The forward gets only the [out][in]
    copies."""
    C, nH, M = 64, 2, 128
    hd = C // nH
    rng = np.random.default_rng(3)
    ps = {k: torch.from_numpy(v)
          for k, v in _params(rng, C, M, nH, 49).items()}
    x = torch.zeros(1, 49, C, dtype=dtype)
    fwd = tfb._operands(x, ps, tfb._FWD_WEIGHTS)
    assert {n for n in fwd if n[0] == "W"} == {"WQKV_F", "WP_F", "W1_F",
                                               "W2_F"}
    ops = tfb._operands(x, ps, tfb._FWD_WEIGHTS + tfb._BWD_WEIGHTS)
    wf = ops["WQKV_F"]
    for h in range(nH):
        for part, name in enumerate(("wq", "wk", "wv")):
            rows = wf[part * C + h * hd:part * C + (h + 1) * hd]
            torch.testing.assert_close(
                rows, ps[name][:, h * hd:(h + 1) * hd].t().to(dtype),
                rtol=0, atol=0)
    torch.testing.assert_close(
        ops["WQKV_B"], torch.cat([ps["wq"], ps["wk"], ps["wv"]], 1).to(dtype),
        rtol=0, atol=0)
    torch.testing.assert_close(ops["WQKV_F"], ops["WQKV_B"].t(), rtol=0,
                               atol=0)
    torch.testing.assert_close(ops["W1_F"], ps["w1"].t().to(dtype), rtol=0,
                               atol=0)
    for name, t in ops.items():
        assert t.is_contiguous(), name
        assert t.dtype in (dtype, torch.float32), name


def test_only_cpu_tensors_take_the_plain_version():
    """A tensor on any device but the CPU goes to the kernel wrapper, which
    refuses what is not CUDA: no quiet fall-back to the plain version."""
    C, nH = 32, 2
    ps = {k: torch.from_numpy(v).to("meta")
          for k, v in _params(np.random.default_rng(4), C, 4 * C, nH,
                              49).items()}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfb.fused_swin_block(torch.zeros(1, 49, C, device="meta"), ps, None,
                             None, N=49, nH=nH, nW=1, scale=0.25)


def test_fused_train_step_matches_unfused_route():
    """One fp32 step with drop-path 0.3: the fused stages and the
    window-attention route give the same state. Gradients below 1e-7 are
    held at 1e-4 for the reason tests/test_torch_step.py:31-38 gives.
    Below Adam's eps (1e-8) the first step, lr * g / (|g| + eps), no
    longer has a magnitude near lr, and a sign that fp32 noise flips
    moves the weight by up to the two updates' magnitudes: such student
    elements are held to lr * sum over the routes of |g| / (|g| + eps)."""
    _, tc = _model_cfgs()
    states = {}
    for stages in ((0, 1), ()):
        cfg = tcfg.TrainConfig(
            model=dataclasses.replace(tc, fused_block_stages=stages,
                                      drop_path_rate=0.3),
            head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
            loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
            optim=tcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=0,
                                   freeze_last_layer_epochs=0),
            dtype=torch.float32, steps_per_epoch=2)
        trainer = EsViTTrainer(cfg, total_batch_size=256, device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        batch = (torch.from_numpy(rng.normal(size=(4, 56, 56, 3))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(4, 24, 24, 3))
                                  .astype(np.float32)))
        state, m = trainer.train_step(state, batch,
                                      torch.Generator().manual_seed(1))
        states[stages] = (state, float(m["loss"]), m["lr"])
    (fused, f_loss, lr), (ref, r_loss, _) = states[(0, 1)], states[()]
    np.testing.assert_allclose(f_loss, r_loss, rtol=1e-5)
    eps = 1e-8
    grad = {n: {k: np.sqrt(s.nu[n].numpy() / (1 - 0.999))
                for k, s in (("fused", fused), ("ref", ref))}
            for n in ref.nu}
    tiny = {n: g["ref"] < 1e-7 for n, g in grad.items()}
    sub_eps = {n: np.maximum(g["fused"], g["ref"]) < eps
               for n, g in grad.items()}
    for part in ("student", "teacher", "mu", "nu"):
        if part in ("student", "teacher"):
            a = getattr(fused, part).state_dict()
            b = getattr(ref, part).state_dict()
        else:
            a, b = getattr(fused, part), getattr(ref, part)
        assert set(a) == set(b)
        for name in b:
            x, y = a[name].numpy(), b[name].numpy()
            if part == "nu":
                x, y = np.sqrt(x), np.sqrt(y)
            t = tiny.get(name, np.zeros(y.shape, bool))
            u = (sub_eps[name] if part == "student" and name in sub_eps
                 else np.zeros(y.shape, bool))
            np.testing.assert_allclose(x[~t], y[~t], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{part} {name}")
            np.testing.assert_allclose(x[t & ~u], y[t & ~u], rtol=1e-4,
                                       atol=1e-4,
                                       err_msg=f"{part} {name} (tiny grad)")
            if u.any():
                g = grad[name]
                bound = lr * sum(g[k][u] / (g[k][u] + eps) for k in g)
                assert (np.abs(x[u] - y[u]) <= bound + 1e-6).all(), (
                    f"{part} {name} (grad below Adam's eps): "
                    f"{np.abs(x[u] - y[u])} > {bound}")
