"""The port's data feed (esvit_tpu_torch/data: sampler.py, datasets.py's
procedural shapes, augment_host.py's multi-crop views, augment_device.py,
loader.py) against esvit_tpu's, on the CPU.

Tolerances: the samplers, the procedural images, the crop boxes and the
uint8 views are bit-identical (the same numpy, ``random`` and PIL calls).
The photometric transforms are held to JAX's on the parameters that
``jax.random`` drew (the test repeats esvit_tpu's key-split chain), within
1e-5 in fp32 (sums in another order; the transforms are continuous in
their inputs, hue's sectors included). The port's own draws are held to
their rates and ranges by statistics: 4 sigma binomial / uniform bounds at
n = 20000.
"""

import random
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.data import augment_device as jdev
from esvit_tpu.data import datasets as jdata
from esvit_tpu.data import loader as jloader
from esvit_tpu.data import sampler as jsampler
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.data import augment_device as tdev
from esvit_tpu_torch.data import augment_host as taug
from esvit_tpu_torch.data import datasets as tdata
from esvit_tpu_torch.data import loader as tloader
from esvit_tpu_torch.data import sampler as tsampler
from tests.torch_threads import one_intra_op_thread  # noqa: F401

AUG_TOL = 1e-5
# The learning gate's nano crops (scripts/validate_learning.py:165-168).
J_CROPS = jcfg.CropConfig(global_size=64, global_scale=(0.4, 1.0),
                          local_size=32, local_scale=(0.3, 0.8),
                          local_crops_number=4)
T_CROPS = tcfg.CropConfig(global_size=64, global_scale=(0.4, 1.0),
                          local_size=32, local_scale=(0.3, 0.8),
                          local_crops_number=4)

SAMPLER_ARGS = [(100, 0, 0, 0, 1), (100, 3, 5, 1, 4), (37, 1, 2, 2, 3),
                (4096, 7, 0, 0, 2)]


# ---------------------------------------------------------------- samplers
@pytest.mark.parametrize("n,epoch,seed,pi,pc", SAMPLER_ARGS)
@pytest.mark.parametrize("drop_last", [True, False])
def test_sharded_indices_match_jax(n, epoch, seed, pi, pc, drop_last):
    kw = dict(epoch=epoch, seed=seed, process_index=pi, process_count=pc,
              drop_last=drop_last)
    for shuffle in (True, False):
        a = tsampler.sharded_indices(n, shuffle=shuffle, **kw)
        b = jsampler.sharded_indices(n, shuffle=shuffle, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,epoch,seed,pi,pc", SAMPLER_ARGS)
def test_class_aware_indices_match_jax(n, epoch, seed, pi, pc):
    labels = np.random.default_rng(n).integers(0, 5, n)
    for spc in (None, 7):
        kw = dict(epoch=epoch, seed=seed, samples_per_class=spc,
                  process_index=pi, process_count=pc)
        a = tsampler.class_aware_indices(labels, **kw)
        b = jsampler.class_aware_indices(labels, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,epoch,seed,pi,pc", SAMPLER_ARGS)
def test_repeated_aug_indices_match_jax(n, epoch, seed, pi, pc):
    for reps in (1, 3):
        kw = dict(epoch=epoch, seed=seed, num_repeats=reps, process_index=pi,
                  process_count=pc)
        a = tsampler.repeated_aug_indices(n, **kw)
        b = jsampler.repeated_aug_indices(n, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,epoch,seed,pi,pc", SAMPLER_ARGS)
def test_chunk_aware_indices_match_jax(n, epoch, seed, pi, pc):
    sizes = list(np.random.default_rng(n).integers(1, 30, 6))
    kw = dict(epoch=epoch, seed=seed, process_index=pi, process_count=pc)
    a = tsampler.chunk_aware_indices(sizes, **kw)
    b = jsampler.chunk_aware_indices(sizes, **kw)
    assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------ procedural datasets
@pytest.mark.parametrize("kind", ["shapes", "shapes_hard"])
@pytest.mark.parametrize("size", [64, 256])
def test_procedural_images_match_jax(kind, size):
    t = tdata.build_dataset(kind, n=40, size=size, seed=3)
    j = jdata.build_dataset(kind, n=40, size=size, seed=3)
    assert len(t) == len(j) == 40
    for i in (0, 1, 2, 3, 17, 39):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert tl == jl
        assert ti.mode == ji.mode and ti.size == ji.size == (size, size)
        assert np.array_equal(np.asarray(ti), np.asarray(ji))


def test_memoized_dataset_returns_the_same_images():
    ds = tdata.ProceduralShapesHard(n=6, size=48, seed=1)
    kept = tdata.Memoized(ds)
    assert len(kept) == 6
    for _ in range(2):
        for i in range(6):
            (a, la), (b, lb) = kept[i], ds[i]
            assert la == lb and a.mode == b.mode == "RGB"
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_build_dataset_refuses_unported_readers():
    """Every kind of esvit_tpu's build_dataset is a reader of the port's
    (none is refused any more); an unknown kind raises."""
    import inspect

    ref = inspect.getsource(jdata.build_dataset)
    kinds = set(re.findall(r'"(\w+)": \w+', ref))
    assert kinds and kinds == set(tdata.KINDS)
    with pytest.raises(ValueError, match="unknown dataset kind"):
        tdata.build_dataset("nope")


# ------------------------------------------------------------ host crops
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_multicrop_boxes_and_views_match_jax(seed):
    img, _ = tdata.ProceduralShapesHard(n=4, size=96, seed=seed)[seed % 4]
    for w, h in ((96, 96), (120, 80), (30, 200)):
        a = taug.sample_multicrop_boxes(T_CROPS, random.Random(seed), w, h)
        b = jloader._sample_multicrop_boxes(J_CROPS, random.Random(seed), w, h)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    tv = taug.crop_views_host_rrc(img, T_CROPS, random.Random(seed))
    jv = jloader._crop_views_host_rrc(img, J_CROPS, random.Random(seed))
    assert len(tv) == len(jv) == 6
    for a, b in zip(tv, jv):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("sampler_kind", ["sharded", "repeated_aug"])
def test_host_batches_match_jax_iterator(monkeypatch, sampler_kind):
    """A 2-batch epoch (6 with each image repeated 3 times): the port's
    uint8 host batches equal the batches esvit_tpu's iterator hands its
    device augmentation, view-major."""
    B = 4
    ds = tdata.ProceduralShapesHard(n=2 * B, size=96, seed=0)
    seen = []
    monkeypatch.setattr(jdev, "augment_multicrop",
                        lambda rng, g, loc, out_dtype: seen.append(
                            (np.asarray(g), np.asarray(loc))) or (g, loc))
    kw = dict(epoch=2, seed=5, num_threads=2, sampler_kind=sampler_kind)
    jit_ = jloader.MultiCropIterator(ds, J_CROPS, B, native_decode=False, **kw)
    list(jit_)
    tit = tloader.MultiCropIterator(ds, T_CROPS, B, device="cpu", **kw)
    got = [(g.numpy(), loc.numpy()) for g, loc in tit.host_batches()]
    assert np.array_equal(tit.indices, jit_.indices)
    assert len(got) == len(seen) == (2 if sampler_kind == "sharded" else 6)
    for (tg, tl), (jg, jl) in zip(got, seen):
        assert tg.shape == (2 * B, 64, 64, 3) and tl.shape == (4 * B, 32, 32, 3)
        assert np.array_equal(tg, jg) and np.array_equal(tl, jl)


def test_iterator_refuses_unported_paths():
    """What the iterator cannot do raises at construction: the chunk
    sampler over a dataset without shards, an unknown sampler, the native
    decode beside the host augmentation (which decodes with PIL)."""
    ds = tdata.ProceduralShapes(n=8, size=64)
    with pytest.raises(ValueError, match="chunk_sizes"):
        tloader.MultiCropIterator(ds, T_CROPS, 4, sampler_kind="chunk",
                                  device="cpu")
    with pytest.raises(ValueError, match="unknown sampler_kind"):
        tloader.MultiCropIterator(ds, T_CROPS, 4, sampler_kind="nope",
                                  device="cpu")
    with pytest.raises(ValueError, match="host_aug"):
        tloader.MultiCropIterator(ds, T_CROPS, 4, host_aug=True,
                                  native_decode=True, device="cpu")


class _Recorder:
    """A dataset that records the order in which its images are asked for."""

    def __init__(self, ds):
        self.ds, self.asked, self.lock = ds, [], threading.Lock()

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        with self.lock:
            self.asked.append(int(i))
        return self.ds[i]


@pytest.mark.parametrize("prefetch", [1, 2])
def test_iterator_lookahead_is_bounded_by_prefetch(prefetch):
    B = 2
    rec = _Recorder(tdata.ProceduralShapes(n=8 * B, size=48))
    it = tloader.MultiCropIterator(rec, T_CROPS, B, num_threads=4,
                                   prefetch=prefetch, device="cpu")
    pos = {int(i): p // B for p, i in enumerate(it.indices)}
    reached = []
    for b, _ in enumerate(it.host_batches()):
        time.sleep(0.05)                       # let the workers run ahead
        with rec.lock:
            ahead = max(pos[i] for i in rec.asked)
        assert ahead <= b + prefetch, (b, ahead)
        reached.append(ahead)
    assert max(reached) == len(it) - 1
    assert any(a == b + prefetch for b, a in enumerate(reached))
    assert len(it.waits) == len(it)


def test_repeated_aug_draws_distinct_crops():
    """With sampler_kind='repeated_aug' the repeats of an index within an
    epoch get different crops (tests/test_data.py:245 on esvit_tpu)."""
    ds = tdata.SyntheticImages(n=4, size=40)
    it = tloader.MultiCropIterator(ds, T_CROPS, 12, num_threads=1,
                                   sampler_kind="repeated_aug", num_repeats=3,
                                   device="cpu")
    g, _ = next(it.host_batches())
    by_index = {}
    for slot, i in enumerate(it.indices[:12]):
        by_index.setdefault(int(i), []).append(g[slot].numpy())
    repeats = [v for v in by_index.values() if len(v) >= 2]
    assert repeats
    assert any(not np.array_equal(v[0], v[1]) for v in repeats)


# ------------------------------------------------- device transforms vs JAX
def _jax_draws(rng, n, blur_p, solarize_p):
    """esvit_tpu augment_view_batch's draws (augment_device.py:140-152,
    _color_jitter :75-79, _gaussian_blur :103), as numpy arrays."""
    k_flip, k_jit_p, k_jit, k_gray, k_blur_p, k_blur, k_sol = \
        jax.random.split(rng, 7)
    kb, kc, ks, kh = jax.random.split(k_jit, 4)
    b, c, s, h = 0.4, 0.4, 0.2, 0.1
    u = jax.random.uniform
    draws = {
        "flip": jax.random.bernoulli(k_flip, 0.5, (n,)),
        "jitter": jax.random.bernoulli(k_jit_p, 0.8, (n,)),
        "brightness": u(kb, (n,), minval=1 - b, maxval=1 + b),
        "contrast": u(kc, (n,), minval=1 - c, maxval=1 + c),
        "saturation": u(ks, (n,), minval=1 - s, maxval=1 + s),
        "hue": u(kh, (n,), minval=-h, maxval=h),
        "gray": jax.random.bernoulli(k_gray, 0.2, (n,)),
        "blur": (jax.random.bernoulli(k_blur_p, blur_p, (n,)) if blur_p > 0
                 else jnp.zeros((n,), bool)),
        "sigma": u(k_blur, (n,), minval=0.1, maxval=2.0),
        "solarize": (jax.random.bernoulli(k_sol, solarize_p, (n,))
                     if solarize_p > 0 else jnp.zeros((n,), bool)),
    }
    out = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    out.update(blur_p=blur_p, solarize_p=solarize_p)
    return out


def _images(n=8, s=24, seed=0):
    """uint8 views with saturated, gray and equal-channel pixels among
    random ones, so every HSV branch runs."""
    x = np.random.default_rng(seed).integers(0, 256, (n, s, s, 3), np.uint8)
    x[:, :2] = 0
    x[:, 2:4] = 255
    x[:, 4:6] = x[:, 4:6, :, :1]                    # gray pixels
    x[:, 6:8, :, 1] = x[:, 6:8, :, 0]               # r == g
    return x


def _close(a, b, tol=AUG_TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol, err


def test_gray_and_hsv_round_trip_match_jax():
    x = _images().astype(np.float32) / 255.0
    _close(tdev.gray(torch.from_numpy(x)), jdev._gray(jnp.asarray(x)))
    th = tdev.rgb_to_hsv(torch.from_numpy(x))
    jh = jdev._rgb_to_hsv(jnp.asarray(x))
    for a, b in zip(th, jh):
        _close(a, b)
    _close(tdev.hsv_to_rgb(*th), jdev._hsv_to_rgb(*jh))
    _close(tdev.hsv_to_rgb(*th), x)


@pytest.mark.parametrize("which", ["jitter", "grayscale", "blur", "solarize",
                                   "flip", "normalize"])
def test_each_transform_matches_jax_on_its_draws(which):
    x = _images(seed=1).astype(np.float32) / 255.0
    n = x.shape[0]
    d = _jax_draws(jax.random.PRNGKey(7), n, 0.5, 0.5)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    mask = np.array([True, False] * (n // 2))
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    if which == "jitter":
        # esvit_tpu draws the factors inside, from the same key chain.
        kj = jax.random.split(jax.random.PRNGKey(7), 7)[2]
        got = tdev.color_jitter(tx, d["brightness"], d["contrast"],
                                d["saturation"], d["hue"], tm)
        want = jdev._color_jitter(jx, kj, jm)
    elif which == "grayscale":
        got, want = tdev.grayscale(tx, tm), jdev._grayscale(jx, jm)
    elif which == "blur":
        kb = jax.random.split(jax.random.PRNGKey(7), 7)[5]
        got = tdev.gaussian_blur(tx, d["sigma"], tm)
        want = jdev._gaussian_blur(jx, kb, jm)
    elif which == "solarize":
        got, want = tdev.solarize(tx, tm), jdev._solarize(jx, jm)
    elif which == "flip":
        got = tdev.hflip(tx, tm)
        want = jnp.where(jdev._per_sample(jx, jm) > 0, jx[:, :, ::-1, :], jx)
    else:
        got = tdev.normalize(tx)
        want = (jx - jdev.IMAGENET_MEAN) / jdev.IMAGENET_STD
    _close(got, want)
    # Rows whose mask is off pass through unchanged, bit for bit.
    if which != "normalize":
        assert torch.equal(got[~tm], tx[~tm])


@pytest.mark.parametrize("policy", ["g1", "g2", "local"])
def test_augment_view_batch_matches_jax_on_its_draws(policy):
    blur_p, solarize_p = tdev.VIEW_POLICY[policy]
    x = _images(n=16, s=32, seed=2)
    rng = jax.random.PRNGKey(11)
    want = jdev.augment_view_batch(rng, jnp.asarray(x), blur_p=blur_p,
                                   solarize_p=solarize_p)
    d = _jax_draws(rng, 16, blur_p, solarize_p)
    got = tdev.apply_view_params(torch.from_numpy(x), d)
    assert got.dtype == torch.float32
    _close(got, want)
    got16 = tdev.apply_view_params(torch.from_numpy(x), d, torch.bfloat16)
    assert got16.dtype == torch.bfloat16


def test_augment_multicrop_matches_jax_on_its_draws():
    """esvit_tpu's three view batches, applied by the port as two (view 1
    and view 2 as one batch of concatenated draws)."""
    B, L = 4, 3
    g = _images(n=2 * B, s=32, seed=3)
    loc = _images(n=L * B, s=16, seed=4)
    rng = jax.random.PRNGKey(5)
    jg, jl = jdev.augment_multicrop(rng, jnp.asarray(g), jnp.asarray(loc))
    k1, k2, k3 = jax.random.split(rng, 3)
    pol = tdev.VIEW_POLICY
    gp = tdev.concat_params(_jax_draws(k1, B, *pol["g1"]),
                            _jax_draws(k2, B, *pol["g2"]))
    lp = _jax_draws(k3, L * B, *pol["local"])
    _close(tdev.apply_view_params(torch.from_numpy(g), gp), jg)
    _close(tdev.apply_view_params(torch.from_numpy(loc), lp), jl)


# ------------------------------------------------------- the port's draws
N_DRAWS = 20000


def _binomial_ok(mask, p):
    rate = mask.float().mean().item()
    return abs(rate - p) <= 4 * np.sqrt(p * (1 - p) / N_DRAWS) + 1e-12


def _uniform_ok(x, lo, hi):
    sd = (hi - lo) / np.sqrt(12 * N_DRAWS)
    return (x.min().item() >= lo and x.max().item() < hi
            and abs(x.mean().item() - (lo + hi) / 2) <= 4 * sd)


@pytest.mark.parametrize("policy", ["g1", "g2", "local"])
def test_draw_rates_and_ranges(policy):
    blur_p, solarize_p = tdev.VIEW_POLICY[policy]
    gen = torch.Generator().manual_seed(3)
    d = tdev.draw_view_params(N_DRAWS, gen, blur_p, solarize_p)
    for name, p in (("flip", 0.5), ("jitter", 0.8), ("gray", 0.2),
                    ("blur", blur_p), ("solarize", solarize_p)):
        assert d[name].dtype == torch.bool
        assert _binomial_ok(d[name], p), (name, d[name].float().mean())
    for name, lo, hi in (("brightness", 0.6, 1.4), ("contrast", 0.6, 1.4),
                         ("saturation", 0.8, 1.2), ("hue", -0.1, 0.1),
                         ("sigma", 0.1, 2.0)):
        assert _uniform_ok(d[name], lo, hi), name
    # The masks are drawn independently of each other.
    both = (d["flip"] & d["jitter"]).float().mean().item()
    assert abs(both - 0.4) <= 4 * np.sqrt(0.4 * 0.6 / N_DRAWS)


def test_augment_multicrop_is_seeded_and_normalised():
    B, L = 8, 4
    g = torch.from_numpy(_images(n=2 * B, s=32, seed=6))
    loc = torch.from_numpy(_images(n=L * B, s=16, seed=7))
    outs = [tdev.augment_multicrop(g, loc, torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    og, ol = outs[0]
    # One view batch alone draws as view 1 of the pair does.
    one = tdev.augment_view_batch(g[:B], torch.Generator().manual_seed(9),
                                  blur_p=1.0)
    assert torch.equal(one, og[:B])
    assert og.shape == (2 * B, 32, 32, 3) and ol.shape == (L * B, 16, 16, 3)
    lo = (0 - np.array(tdev.IMAGENET_MEAN)) / np.array(tdev.IMAGENET_STD)
    hi = (1 - np.array(tdev.IMAGENET_MEAN)) / np.array(tdev.IMAGENET_STD)
    for o in (og, ol):
        assert torch.isfinite(o).all()
        flat = o.reshape(-1, 3).numpy()
        assert (flat.min(0) >= lo - 1e-5).all() and (flat.max(0) <= hi + 1e-5).all()


def test_iterator_under_thread_stress():
    """More workers than cores, a tiny switch interval: every batch comes
    once and in order, the lookahead bound holds, every worker ends."""
    import os
    import sys

    B, prefetch = 1, 2
    rec = _Recorder(tdata.SyntheticImages(n=40, size=40))
    it = tloader.MultiCropIterator(rec, T_CROPS, B,
                                   num_threads=2 * (os.cpu_count() or 4),
                                   prefetch=prefetch, device="cpu")
    pos = {int(i): p for p, i in enumerate(it.indices)}
    want = [tloader.MultiCropIterator(
        rec.ds, T_CROPS, B, num_threads=1, device="cpu")._host_batch(b)
        for b in range(len(it))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = set(threading.enumerate())
        for b, (g, loc) in enumerate(it.host_batches()):
            with rec.lock:
                assert max(pos[i] for i in rec.asked) <= b + prefetch
            assert torch.equal(g, want[b][0]) and torch.equal(loc, want[b][1])
        assert b == len(it) - 1
        leftover = [t for t in threading.enumerate() if t not in before]
        for t in leftover:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in leftover)
    finally:
        sys.setswitchinterval(old)
    assert sorted(rec.asked) == sorted(int(i) for i in it.indices)


def test_iterator_raises_a_worker_error_and_stops():
    class Broken(_Recorder):
        def __getitem__(self, i):
            if int(i) == int(self.bad):
                raise KeyError("broken image")
            return super().__getitem__(i)

    ds = Broken(tdata.SyntheticImages(n=12, size=40))
    it = tloader.MultiCropIterator(ds, T_CROPS, 2, num_threads=3,
                                   device="cpu")
    ds.bad = it.indices[5]                        # in batch 2
    got = []
    with pytest.raises(KeyError, match="broken image"):
        for batch in it.host_batches():
            got.append(batch)
    assert len(got) == 2
