"""The port's evals (esvit_tpu_torch/evals, data/datasets.py,
data/augment_host.py, io/torch_checkpoint.py) against esvit_tpu's.

Same features, images and weights through both packages, on the CPU
(``device="cpu"``), fp32. The JAX backbones take their XLA attention path
(``attention_impl='xla'``), the port's the 'pallas' route (the plain twin
on the CPU); both compute the same fp32 function. Tolerances: k-NN
accuracies and rankings exactly equal; the probe's weights 1e-5 after a
few epochs (fp32 sums in another order); extracted features 1e-4 (as the
backbone tests, tests/test_torch_swin.py); transforms 1e-6 (the same PIL
resample, then fp32 normalisation).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from esvit_tpu import config as jcfg
from esvit_tpu.data import augment_host as jaug
from esvit_tpu.data import datasets as jdata
from esvit_tpu.evals import extract as jextract
from esvit_tpu.evals import knn as jknn
from esvit_tpu.evals import linear as jlinear
from esvit_tpu.io import torch_import
from esvit_tpu.models.registry import build_backbone as jbuild
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.data import augment_host as taug
from esvit_tpu_torch.data import datasets as tdata
from esvit_tpu_torch.evals import extract as textract
from esvit_tpu_torch.evals import knn as tknn
from esvit_tpu_torch.evals import linear as tlinear
from esvit_tpu_torch.io import torch_checkpoint
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models.registry import build_backbone as tbuild
from tests.torch_threads import one_intra_op_thread  # noqa: F401

FEAT_TOL = 1e-4
PROBE_TOL = 1e-5


def _features(seed, n_train=60, n_test=25, dim=16, classes=6):
    rng = np.random.default_rng(seed)

    def draw(n):
        f = rng.normal(size=(n, dim)).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        return f, rng.integers(0, classes, n).astype(np.int32)

    return draw(n_train), draw(n_test)


@pytest.mark.parametrize("k,chunk", [(1, 512), (7, 8), (20, 512)])
def test_knn_classifier_matches_jax(k, chunk):
    (train_f, train_l), (test_f, test_l) = _features(k)
    want = jknn.knn_classifier(train_f, train_l, test_f, test_l, k=k,
                               chunk=chunk)
    got = tknn.knn_classifier(train_f, train_l, test_f, test_l, k=k,
                              chunk=chunk, device="cpu")
    assert got == want


def test_knn_classifier_separable():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 16))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = np.repeat(np.arange(4), 30).astype(np.int32)
    f = (centers[labels] + 0.04 * rng.normal(size=(120, 16))).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    top1, top5 = tknn.knn_classifier(f[::2], labels[::2], f[1::2],
                                     labels[1::2], k=10, chunk=32,
                                     device="cpu")
    assert top1 > 95.0 and top5 == 100.0


@pytest.mark.parametrize("batch_size,epochs", [(8, 3), (16, 5)])
def test_train_linear_probe_matches_jax(batch_size, epochs):
    (train_f, train_l), (test_f, test_l) = _features(3, n_train=64)
    kw = dict(epochs=epochs, batch_size=batch_size, lr=0.5, seed=1)
    j_params, j1, j5 = jlinear.train_linear_probe(train_f, train_l, test_f,
                                                  test_l, **kw)
    t_params, t1, t5 = tlinear.train_linear_probe(train_f, train_l, test_f,
                                                  test_l, device="cpu", **kw)
    for name in ("w", "b"):
        np.testing.assert_allclose(t_params[name].detach().numpy(),
                                   np.asarray(j_params[name]),
                                   rtol=PROBE_TOL, atol=PROBE_TOL)
    assert (t1, t5) == (j1, j5)


def test_make_probe_init_matches_jax():
    j_params, _, _ = jlinear.make_probe(24, 5, scaled_lr=0.1, total_steps=10,
                                        seed=3)
    t_params, _ = tlinear.make_probe(24, 5, scaled_lr=0.1, total_steps=10,
                                     seed=3, device="cpu")
    for name in ("w", "b"):
        np.testing.assert_array_equal(t_params[name].detach().numpy(),
                                      np.asarray(j_params[name]))


@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_presets_and_feature_dims_match_jax(preset):
    t, j = tcfg.get_model_config(preset), jcfg.get_model_config(preset)
    for field in ("name", "img_size", "embed_dim", "depths", "num_heads",
                  "window_size", "stages"):
        if hasattr(j, field):
            want = getattr(j, field)
            got = getattr(t, field)
            if field == "stages":
                want = [(s.embed_dim, s.depth, s.num_heads) for s in want]
                got = [(s.embed_dim, s.depth, s.num_heads) for s in got]
            assert got == want, field
    for n in (1, 2, 4):
        assert tlinear.feature_dim_for(t, n) == jlinear.feature_dim_for(j, n)


def test_unported_presets_and_dims_raise():
    """Every esvit_tpu preset is ported, and like esvit_tpu's none is a
    ResNet; ResNet's probe width is its pooled feature alone, whatever
    the block count, as esvit_tpu's."""
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    with pytest.raises(ValueError, match="unknown model preset"):
        tcfg.get_model_config("resnet50")
    for depth in (50, 101):
        for n in (1, 4):
            assert tlinear.feature_dim_for(tcfg.ResNetConfig(depth), n) == \
                jlinear.feature_dim_for(jcfg.ResNetConfig(depth), n) == 2048
    with pytest.raises(ValueError, match="unknown dataset kind"):
        tdata.build_dataset("imagenet", root="x")


@pytest.mark.parametrize("n,per,fill", [(3, 5, 0), (4, 4, 0), (1, 6, -1)])
def test_pad_rows_matches_jax(n, per, fill):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = textract.pad_shard(x, per, fill)
    np.testing.assert_array_equal(got, jextract.pad_shard(x, per, fill))
    assert got.shape == (per, 2) and (got[n:] == fill).all()


@pytest.mark.parametrize("n,batch_size", [(10, 4), (8, 4), (3, 8)])
def test_iter_batches_matches_jax(n, batch_size):
    """Same batches, labels and real-row counts, the last batch padded
    (images with 0, labels with -1)."""
    class ToyDS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return np.full((2, 2, 3), i, np.float32), i % 3

    got = list(textract.iter_batches(ToyDS(), range(n), lambda a: a,
                                     batch_size, num_threads=2))
    want = list(jextract.iter_batches(ToyDS(), np.arange(n), lambda a: a,
                                      batch_size, num_threads=2))
    assert len(got) == len(want) == -(-n // batch_size)
    for (tx, ty, tn), (jx, jy, jn) in zip(got, want):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tn == jn
    assert got[-1][2] == n - batch_size * (len(got) - 1)


def test_extract_dataset_features_order_matches_jax():
    class ToyDS:
        def __len__(self):
            return 13

        def __getitem__(self, i):
            return np.full((4, 4, 3), i, np.float32), i % 5

    fwd = lambda x: x.reshape(x.shape[0], -1)[:, :2]
    got = textract.extract_dataset_features(fwd, ToyDS(), lambda a: a,
                                            batch_size=4, num_threads=3)
    want = jextract.extract_dataset_features(fwd, ToyDS(), lambda a: a,
                                             batch_size=4, num_threads=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0][:, 0], np.arange(13))


@pytest.mark.parametrize("shape,size", [((100, 150, 3), 64), ((48, 48, 3), 32)])
def test_eval_transform_matches_jax(shape, size):
    arr = np.random.default_rng(size).integers(0, 256, shape, dtype=np.uint8)
    img = Image.fromarray(arr)
    got = tknn.eval_transform(img, size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jknn.eval_transform(img, size),
                               rtol=1e-6, atol=1e-6)


def test_augmented_view_and_datasets_match_jax():
    """The synthetic images, RandomResizedCrop's parameters and the
    probe's augmented view are the reference's, draw for draw."""
    t_ds = tdata.SyntheticImages(n=4, size=48, num_classes=2)
    j_ds = jdata.SyntheticImages(n=4, size=48, num_classes=2)
    for i in range(4):
        (ti, tl), (ji, jl) = t_ds[i], j_ds[i]
        assert tl == jl
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    import random
    for seed in range(5):
        assert (taug.sample_rrc_params(random.Random(seed), 100, 60,
                                       (0.08, 1.0))
                == jaug.sample_rrc_params(random.Random(seed), 100, 60,
                                          (0.08, 1.0)))
    np.testing.assert_array_equal(taug.IMAGENET_MEAN, jaug.IMAGENET_MEAN)
    np.testing.assert_array_equal(taug.IMAGENET_STD, jaug.IMAGENET_STD)
    for epoch in (0, 1):
        tv = tlinear._AugmentedProbeView(t_ds, size=32, seed=0, epoch=epoch)
        jv = jlinear._AugmentedProbeView(j_ds, size=32, seed=0, epoch=epoch)
        for i in range(2):
            np.testing.assert_array_equal(tv[i][0], jv[i][0])
    assert not np.array_equal(
        tlinear._AugmentedProbeView(t_ds, size=32, seed=0, epoch=0)[0][0],
        tlinear._AugmentedProbeView(t_ds, size=32, seed=0, epoch=1)[0][0])


# ------------------------------------------------ backbones and checkpoints
def _jax_femto(**kw):
    return jcfg.swin_femto(attention_impl="xla", fused_block_stages=(), **kw)


def _port_femto(**kw):
    return tcfg.swin_femto(attention_impl="pallas", fused_block_stages=(),
                           **kw)


@pytest.fixture(scope="module")
def femto():
    """A JAX femto Swin, its variables, and the port's on the same weights."""
    backbone = jbuild(_jax_femto())
    variables = backbone.init({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((1, 32, 32, 3)), deterministic=True)
    port = tbuild(_port_femto())
    port.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"])), strict=True)
    return backbone, variables, port


@pytest.fixture(scope="module")
def png_folders(tmp_path_factory):
    """Two tiny ImageFolders of PNGs (3 classes), train and val."""
    root = tmp_path_factory.mktemp("folders")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        for c in ("a", "b", "c"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"{i}.png")
    return str(root / "train"), str(root / "val")


def test_image_folder_matches_jax(png_folders):
    t, j = tdata.build_dataset("folder", root=png_folders[0]), \
        jdata.build_dataset("folder", root=png_folders[0])
    assert len(t) == len(j) == 12 and t.class_to_idx == j.class_to_idx
    for i in (0, 5, 11):
        np.testing.assert_array_equal(np.asarray(t[i][0]), np.asarray(j[i][0]))
        assert t[i][1] == j[i][1]


def test_run_knn_eval_matches_jax(femto, png_folders, tmp_path):
    backbone, variables, port = femto
    train, val = (tdata.ImageFolder(p) for p in png_folders)
    j_train, j_val = (jdata.ImageFolder(p) for p in png_folders)
    want = jknn.run_knn_eval(backbone, variables, j_train, j_val, ks=(3, 5),
                             batch_size=4, size=32)
    got = tknn.run_knn_eval(port, train, val, ks=(3, 5), batch_size=4,
                            size=32, dump_dir=str(tmp_path), device="cpu")
    assert got == want and set(got) == {3, 5}
    j_f, _ = jknn.extract_features(
        lambda v, x: backbone.apply(v, x, deterministic=True), variables,
        j_val, batch_size=4, size=32)
    np.testing.assert_allclose(np.load(tmp_path / "testfeat.npy"), j_f,
                               rtol=FEAT_TOL, atol=FEAT_TOL)
    again = tknn.run_knn_eval(None, None, None, ks=(3, 5),
                              load_dir=str(tmp_path), device="cpu")
    assert again == got


def test_probe_features_and_online_probe_match_jax(femto):
    """Centre-crop n-last-blocks features, then two epochs of the
    reference protocol (augmented forwards feeding the probe)."""
    backbone, variables, port = femto
    train = tdata.SyntheticImages(n=16, size=48, num_classes=3)
    val = tdata.SyntheticImages(n=8, size=48, num_classes=3, seed=1)
    j_train = jdata.SyntheticImages(n=16, size=48, num_classes=3)
    j_val = jdata.SyntheticImages(n=8, size=48, num_classes=3, seed=1)
    j_f, j_l = jlinear.extract_probe_features(backbone, variables, j_val,
                                              n_last_blocks=2, batch_size=8,
                                              size=32)
    t_f, t_l = tlinear.extract_probe_features(port, val, n_last_blocks=2,
                                              batch_size=8, size=32,
                                              device="cpu")
    np.testing.assert_array_equal(t_l, j_l)
    np.testing.assert_allclose(t_f, j_f, rtol=FEAT_TOL, atol=FEAT_TOL)
    kw = dict(n_last_blocks=2, epochs=2, batch_size=8, lr=0.1, size=32,
              num_classes=3)
    j_params, *j_acc = jlinear.train_linear_probe_online(
        backbone, variables, j_train, j_f, j_l, **kw)
    t_params, *t_acc = tlinear.train_linear_probe_online(
        port, train, j_f, j_l, device="cpu", **kw)
    for name in ("w", "b"):
        np.testing.assert_allclose(t_params[name].detach().numpy(),
                                   np.asarray(j_params[name]),
                                   rtol=FEAT_TOL, atol=FEAT_TOL)
    assert t_acc == j_acc


def _family(name):
    """(JAX backbone, its variables with BatchNorm statistics moved off 0 /
    1, the port's backbone on them) of a small CvT or ViT."""
    if name == "cvt":
        jc, tc = jcfg.cvt_femto(img_size=32), tcfg.cvt_femto(img_size=32)
    else:
        jc, tc = (pkg.ViTConfig(img_size=32, patch_size=8, embed_dim=32,
                                depth=2, num_heads=2) for pkg in (jcfg, tcfg))
    backbone = jbuild(jc)
    v = jax.tree.map(np.asarray, backbone.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(2)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
            v["batch_stats"])
    port = tbuild(tc)
    port.load_state_dict(state_dict_from_flax(v["params"],
                                              v.get("batch_stats")),
                         strict=True)
    return backbone, v, port


@pytest.mark.parametrize("name", ["cvt", "vit"])
def test_cvt_and_vit_eval_features_match_jax(name):
    """k-NN features and 2-last-block probe features of a CvT (BatchNorm
    on its running statistics in both) and a ViT on the same images."""
    backbone, variables, port = _family(name)
    before = {k: v.clone() for k, v in port.state_dict().items()
              if "running" in k}
    ds = tdata.SyntheticImages(n=6, size=40, num_classes=3)
    j_ds = jdata.SyntheticImages(n=6, size=40, num_classes=3)
    j_f, j_l = jknn.extract_features(
        lambda v, x: backbone.apply(v, x, deterministic=True), variables,
        j_ds, batch_size=4, size=32)
    t_f, t_l = tknn.extract_features(port, ds, batch_size=4, size=32,
                                     device="cpu")
    np.testing.assert_array_equal(t_l, j_l)
    np.testing.assert_allclose(t_f, j_f, rtol=FEAT_TOL, atol=FEAT_TOL)
    j_f, _ = jlinear.extract_probe_features(backbone, variables, j_ds,
                                            n_last_blocks=2, batch_size=4,
                                            size=32)
    t_f, _ = tlinear.extract_probe_features(port, ds, n_last_blocks=2,
                                            batch_size=4, size=32,
                                            device="cpu")
    assert t_f.shape[1] == tlinear.feature_dim_for(port.cfg, 2)
    np.testing.assert_allclose(t_f, j_f, rtol=FEAT_TOL, atol=FEAT_TOL)
    # The evals read the running statistics and leave them as they are.
    assert len(before) == (4 if name == "cvt" else 0)
    after = port.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_adapt_swin_tables_matches_jax():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(49, 3)).astype(np.float32)
    ape = rng.normal(size=(1, 64, 8)).astype(np.float32)
    want = torch_import.adapt_swin_tables(
        {"blk": {"relative_position_bias_table": table},
         "absolute_pos_embed": ape},
        {"blk": {"relative_position_bias_table": np.zeros((25, 3))},
         "absolute_pos_embed": np.zeros((1, 144, 8))})
    got = torch_checkpoint.adapt_swin_tables(
        {"layers.0.blocks.0.attn.relative_position_bias_table":
         torch.from_numpy(table), "absolute_pos_embed": torch.from_numpy(ape)},
        {"layers.0.blocks.0.attn.relative_position_bias_table":
         torch.zeros(25, 3), "absolute_pos_embed": torch.zeros(1, 144, 8)})
    np.testing.assert_allclose(
        got["layers.0.blocks.0.attn.relative_position_bias_table"].numpy(),
        want["blk"]["relative_position_bias_table"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["absolute_pos_embed"].numpy(),
                               want["absolute_pos_embed"], rtol=1e-6,
                               atol=1e-6)


def test_pth_checkpoint_gives_jax_features(tmp_path):
    """A reference-layout .pth ('teacher' and 'student', 'module.' prefix,
    heads, index and mask buffers) of a W=4, 32 px model with an absolute
    position embedding, loaded for W=2 at 48 px: the tables and the
    embedding are resized, and both packages give the same features."""
    src = tbuild(_port_femto(ape=True), generator=torch.Generator().manual_seed(4))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
        16, 16, dtype=torch.long)
    sd["module.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    sd["module.head.mlp.0.weight"] = torch.zeros(8, 32)
    sd["module.head_dense.last_layer.weight_g"] = torch.ones(8, 1)
    path = str(tmp_path / "checkpoint.pth")
    torch.save({"teacher": sd, "student": {}, "epoch": 3}, path)

    flat = torch_checkpoint.load_torch_checkpoint(path)
    assert all(not k.startswith("module.") for k in flat)
    kept = torch_checkpoint.backbone_state(flat)
    assert set(kept) == set(src.state_dict())

    x = np.random.default_rng(6).normal(size=(2, 48, 48, 3)).astype(np.float32)
    j_cfg = _jax_femto(ape=True, window_size=2, img_size=48)
    j_backbone = jbuild(j_cfg)
    j_vars = jknn.load_backbone_variables(j_backbone, j_cfg, path)
    j_cls, _ = j_backbone.apply(j_vars, jnp.asarray(x), deterministic=True)
    t_cfg = _port_femto(ape=True, window_size=2, img_size=48)
    port = tknn.load_backbone_variables(tbuild(t_cfg), t_cfg, path)
    assert port.state_dict()[
        "layers.0.blocks.0.attn.relative_position_bias_table"].shape == (9, 2)
    with torch.no_grad():
        t_cls, _ = port.forward_features(torch.from_numpy(x))
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls),
                               rtol=FEAT_TOL, atol=FEAT_TOL)
    with pytest.raises(ValueError, match=r"\.pth/\.pt checkpoints"):
        tknn.load_backbone_variables(port, t_cfg, str(tmp_path))


def test_training_after_an_eval_in_the_same_process():
    """Tables cached by an inference-mode eval forward are normal tensors:
    a later forward under autograd saves them for backward."""
    from esvit_tpu_torch.ops import window as wops

    wops.device_table.cache_clear()
    model = tbuild(_port_femto(), generator=torch.Generator().manual_seed(7))
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        model.forward_features(x)
    model.forward_features(x)[0].sum().backward()
    table = model.layers[0].blocks[1].attn.relative_position_bias_table
    assert table.grad is not None and torch.isfinite(table.grad).all()
