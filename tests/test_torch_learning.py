"""The port's training on a data feed and its learning gate, on the CPU.

``train()`` on ``shapes_hard`` through ``MultiCropIterator`` (femto Swin,
fp32): finite losses, the epoch length ``len(dataset) // B``, and the
same losses on repeat (every draw is seeded). The twin of
scripts/validate_learning.py (``esvit_tpu_torch.validate_learning``) at
femto size for a few steps: its result record, and its refusals.
"""

import math

import pytest
import torch

from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch import validate_learning as vl
from esvit_tpu_torch.train.train import train
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _cfg(tmp_path):
    return tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=1),
        crops=tcfg.CropConfig(global_size=32, local_size=16,
                              local_crops_number=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=2, warmup_epochs=1,
                               batch_size_per_device=4,
                               freeze_last_layer_epochs=0),
        dtype=torch.float32, steps_per_epoch=99, output_dir=str(tmp_path))


def test_train_on_shapes_hard_is_finite_and_repeatable(tmp_path):
    cfg = _cfg(tmp_path)
    kw = dict(data_kind="shapes_hard", data_kwargs=dict(n=8, size=48),
              device="cpu", resume=False)
    runs = [train(cfg, max_steps=3, **kw) for _ in range(2)]
    (s1, h1), (s2, h2) = runs
    losses = [h["loss"] for h in h1]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert losses == [h["loss"] for h in h2]
    # Two steps per epoch (8 images at B=4): step 3 opens epoch 1.
    assert [h["step"] for h in h1] == [1, 2, 3]
    assert all(h["data_seconds"] >= 0 for h in h1)
    # Each epoch's first record reads the batch that step consumed.
    assert ["inputs" in h for h in h1] == [True, False, True]
    for name, (n, side) in (("global", (8, 32)), ("local", (8, 16))):
        x = h1[0]["inputs"][name]
        assert (x["device"], x["dtype"], x["shape"], x["finite"]) == (
            "cpu", "torch.float32", (n, side, side, 3), True)
        assert all(-1.5 < m < 1.5 for m in x["mean"])
        assert all(0.3 < s < 1.5 for s in x["std"])
    for a, b in zip(s1.student.parameters(), s2.student.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(s1.centers.center, s2.centers.center)


def test_train_takes_a_dataset_and_refuses_unported_feeds(tmp_path):
    from esvit_tpu_torch.data.datasets import ProceduralShapes

    cfg = _cfg(tmp_path)
    _, hist = train(cfg, dataset=ProceduralShapes(n=4, size=40),
                    max_steps=1, device="cpu")
    assert len(hist) == 1 and math.isfinite(hist[0]["loss"])
    # The host augmentation feeds a step (float32 views from the host).
    _, hist = train(cfg, data_kind="shapes", data_kwargs=dict(n=4, size=40),
                    host_aug=True, max_steps=1, device="cpu", resume=False)
    assert len(hist) == 1 and math.isfinite(hist[0]["loss"])
    assert (hist[0]["native_images"], hist[0]["pil_images"]) == (0, 4)
    with pytest.raises(ValueError, match="unknown dataset kind"):
        train(cfg, data_kind="nope", device="cpu")


def test_validate_learning_twin_at_femto_size():
    res = vl.validate(steps=4, batch=4, size="femto", device="cpu",
                      n_eval=48)
    assert res["steps"] == 4
    assert math.isfinite(res["last_loss"])
    assert 0.0 <= res["before"] <= 100.0 and 0.0 <= res["after"] <= 100.0
    assert all(map(math.isfinite, res["center_max"].values()))
    assert res["seconds"] > 0


def test_validate_learning_cvt_leg_at_a_few_steps():
    """The nano CvT leg: 3 steps of the twin on the CPU, then its k-NN."""
    res = vl.validate(steps=3, batch=4, backbone="cvt", device="cpu",
                      n_eval=32)
    assert res["steps"] == 3 and math.isfinite(res["last_loss"])
    assert 0.0 <= res["before"] <= 100.0 and 0.0 <= res["after"] <= 100.0
    assert all(map(math.isfinite, res["center_max"].values()))


@pytest.mark.parametrize("size", ["femto", "nano"])
def test_validate_learning_seed_sets_the_initial_weights(size, monkeypatch):
    """``--seed`` reaches TrainConfig.seed, from which validate() draws
    the initial weights: one seed gives the same weights twice, two seeds
    different ones."""
    from esvit_tpu_torch.train.step import EsViTTrainer

    def weights(seed):
        cfg, _ = vl.build_config(size=size, seed=seed)
        assert cfg.seed == seed
        state = EsViTTrainer(cfg, total_batch_size=4, device="cpu") \
            .init_state(torch.Generator().manual_seed(cfg.seed))
        return state.student.state_dict()

    a, b, c = weights(0), weights(0), weights(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.last_layer.weight_v"],
                           c["head.last_layer.weight_v"])
    seen = {}

    def fake_validate(**kw):
        seen.update(kw)
        return {"before": 0.0, "after": 50.0, "steps": 1, "seconds": 1.0,
                "last_loss": 1.0, "feed_wait_seconds": 0.0}

    monkeypatch.setattr(vl, "validate", fake_validate)
    vl.main(["--cpu", "--seed", "3", "--min_gain", "-100"])
    assert seen["seed"] == 3


def test_validate_learning_schedule_and_gates():
    """The reference script's schedule (20 epochs of steps // 20) and
    default bars."""
    cfg, img = vl.build_config(steps=6000)
    assert (cfg.steps_per_epoch, cfg.optim.epochs, img) == (300, 20, 96)
    assert cfg.optim.lr == 4e-3 and cfg.crops.local_crops_number == 4
    assert cfg.model.window_size == 4 and cfg.model.embed_dim == 32
    vil, _ = vl.build_config(backbone="vil", fused=False)
    assert vil.model.fused_sc == "off"
    assert vl.min_gain_for("shapes_hard", 6000, "swin") == 10.0
    assert vl.min_gain_for("shapes_hard", 6000, "vil") == 6.0
    assert vl.min_gain_for("shapes_hard", 2000, "swin") == 2.0
    assert vl.min_gain_for("shapes", 6000, "vil") == 5.0
    cvt, img = vl.build_config(backbone="cvt", steps=6000)
    st = cvt.model.stages
    assert (img, cvt.model.img_size, cvt.optim.lr) == (96, 64, 4e-3)
    assert [(s.patch_stride, s.embed_dim, s.depth, s.num_heads,
             s.window_size) for s in st] == [(4, 32, 1, 2, 7),
                                             (2, 64, 1, 4, 7),
                                             (2, 128, 2, 4, 7)]
    assert vl.build_config(backbone="cvt", fused=False)[0].model == cvt.model
    assert vl.min_gain_for("shapes_hard", 6000, "cvt") == -1.0
    assert vl.min_gain_for("shapes_hard", 2000, "cvt") == -1.0
    hires, img = vl.build_config(hires=True)
    assert (hires.crops.global_size, hires.crops.local_size, img) == (96, 48,
                                                                      160)
    with pytest.raises(ValueError, match="nano-size"):
        vl.build_config(size="femto", hires=True)


def test_chip_smoke_nano_shapes_are_the_gate_models_shapes(monkeypatch):
    """chip_smoke.py's "nano" kernel shapes are the ones the gate's nano
    Swin and ViL route to the block-fused and sliding-chunk kernels: all
    of them at 64 px (2B images) and at 32 px (4B images), and a subset of
    the k-NN eval's (batch 32, the fp32 entries)."""
    import chip_smoke as cs
    from esvit_tpu_torch.models.registry import build_backbone
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import sliding_chunk as sc

    # Small batches stand for the real ones: b[key] images for per[key].
    b = {"64": 2, "32": 4, "eval": 1}
    per = {"64": 128, "32": 256, "eval": 32}
    seen = {key: set() for key in b}
    now = []

    def fused(x, params, k1, k2, *, N, nH, nW, scale, region, pad, eps):
        seen[now[-1]].add(("fused", x.shape[0], x.shape[2], nH, N, nW,
                           region is not None))
        return fb.fused_swin_block_plain(x, params, k1, k2, N=N, nH=nH,
                                         nW=nW, scale=scale, region=region,
                                         pad=pad, eps=eps)

    def chunk(q, k, v, kg, vg, *, nx, ny, W):
        seen[now[-1]].add(("sc", q.shape[0], nx, q.shape[-1], W))
        return sc.sliding_chunk_attention_plain(q, k, v, kg, vg, nx=nx,
                                                ny=ny, W=W)

    monkeypatch.setattr(fb, "fused_swin_block", fused)
    monkeypatch.setattr(sc, "sliding_chunk_attention", chunk)
    for backbone in ("swin", "vil"):
        cfg, _ = vl.build_config(backbone=backbone)
        model = build_backbone(cfg.model)
        with torch.no_grad():
            for key, side in (("64", 64), ("32", 32), ("eval", 64)):
                now.append(key)
                model.forward_features(torch.randn(b[key], side, side, 3))
    want = {key: set() for key in b}
    for label, B, C, nH, H, shifted, dt, *_, ws in cs.FUSED_SHAPES:
        if label.startswith("nano"):
            key = "eval" if dt == "fp32" else label.split()[1]
            N, nW = ((H * H + 1, 1) if H < ws
                     else (ws * ws, (-(-H // ws)) ** 2))
            assert B == per[key], label
            want[key].add(("fused", b[key], C, nH, N, nW, shifted))
    for label, BH, n, M, dt, *_, W in cs.SC_SHAPES:
        if label.startswith("nano"):
            keys = (["eval"] if dt == "fp32" else
                    [k for k in ("64", "32") if f" {k} " in label + " "])
            for key in keys:
                # The entry's row of its stage at this crop size.
                heads = BH // per[key]
                want[key].add(("sc", heads * b[key], n, M, W))
    assert seen["64"] == want["64"] and seen["32"] == want["32"]
    assert want["eval"] <= seen["eval"]


@pytest.mark.parametrize("backbone", ["swin", "vil", "cvt"])
def test_initial_weights_against_esvit_tpu(backbone):
    """The gate's models draw their initial weights from esvit_tpu's
    distributions (torch cannot draw jax.random's values): the constant
    tensors equal; each random tensor of at least 2000 values a truncated
    normal with esvit_tpu's std (flax's truncated_normal(0.02): the unit
    normal cut at +-2 times 0.02, std 0.0176), within 5%, every value
    within +-2 x 0.02."""
    import jax
    import jax.numpy as jnp

    from esvit_tpu import config as jcfg
    from esvit_tpu.train.step import EsViTTrainer as JTrainer
    from esvit_tpu_torch.io.jax_params import state_dict_from_flax
    from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer

    tc, _ = vl.build_config(backbone=backbone)
    if backbone == "swin":
        jm = jcfg.SwinConfig(img_size=64, patch_size=4, embed_dim=32,
                             depths=(2, 2, 2), num_heads=(2, 4, 4),
                             window_size=4, drop_path_rate=0.0)
    elif backbone == "vil":
        jm = jcfg.vil_from_arch(vl.NANO_VIL_ARCH, img_size=64)
    else:               # scripts/validate_learning.py:126-140
        jm = jcfg.CvTConfig(img_size=64, stages=(
            jcfg.CvTStageConfig(patch_size=3, patch_stride=4,
                                patch_padding=1, embed_dim=32, depth=1,
                                num_heads=2),
            jcfg.CvTStageConfig(patch_size=3, patch_stride=2,
                                patch_padding=1, embed_dim=64, depth=1,
                                num_heads=4),
            jcfg.CvTStageConfig(patch_size=3, patch_stride=2,
                                patch_padding=1, embed_dim=128, depth=2,
                                num_heads=4)))
    jc = jcfg.TrainConfig(
        model=jm, head=jcfg.HeadConfig(out_dim=1024, hidden_dim=512,
                                       bottleneck_dim=64,
                                       norm_last_layer=False),
        loss=jcfg.LossConfig(out_dim=1024), dtype=jnp.float32)
    example = (jnp.zeros((4, 64, 64, 3)), jnp.zeros((4, 32, 32, 3)))
    jstate = JTrainer(jc, total_batch_size=2).init_state(
        jax.random.PRNGKey(0), example)
    want = state_dict_from_flax(
        jax.device_get(jstate.student),
        jax.device_get(jstate.student_state).get("batch_stats"))
    got = TTrainer(tc, total_batch_size=2, device="cpu").init_state(
        torch.Generator().manual_seed(0)).student.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].float()
        if w.numel() == 1 or w.std() == 0:
            assert torch.equal(g, w.float()), name
        elif w.numel() >= 2000:
            assert abs(g.std() / w.std() - 1) < 0.05, name
            assert g.abs().max() <= 0.02 * 2 + 1e-7, name
