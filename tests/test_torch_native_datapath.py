"""The port's native host data path (esvit_tpu_torch/native,
csrc/datapath.cpp) on the CPU, against PIL and against esvit_tpu.native.

The reference's cases (tests/test_native_datapath.py) on the port's
library, with the reference's bounds: decode bit-identical to PIL (both
sit on libjpeg), crop + resize within 1 LSB of PIL's (double against
fixed-point accumulation), the scaled decode within RMS 4 and mean 2.5,
loader batches within mean |delta| 0.02 after the photometrics, the
eval transform within 3.2 LSB (max) and 0.35 LSB (mean) normalised. Then
the port's own: its crops and batches equal esvit_tpu.native's byte for
byte where that library builds (the same source and g++ flags); the
loader's one call per batch equals esvit_tpu's per-sample path; the
variant built without libjpeg (PIL decodes, the library crops); the
build's lock and per-process temporary name; a failed build raised, not
hidden. Every image is written here from a numpy seed.
"""

import base64
import io
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from esvit_tpu import config as jcfg
from esvit_tpu.data import datasets as jdata
from esvit_tpu.data import loader as jloader
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch import native
from esvit_tpu_torch.data import datasets as tdata
from esvit_tpu_torch.data import loader as tloader
from esvit_tpu_torch.data import stores
from tests.torch_threads import one_intra_op_thread  # noqa: F401

LSB = 1.0 / (255.0 * 0.225)           # one uint8 LSB, normalised


def _jpeg(arr: np.ndarray, quality: int = 90, mode=None) -> bytes:
    b = io.BytesIO()
    img = Image.fromarray(arr)
    if mode:
        img = img.convert(mode)
    img.save(b, "JPEG", quality=quality)
    return b.getvalue()


def _rand_img(rng, h, w, smooth=False):
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if smooth:
        arr = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR))
    return arr


def _reference_native():
    """esvit_tpu.native when its library builds here, else None."""
    from esvit_tpu import native as ref

    return ref if ref.available() else None


# --------------------------------------------- the reference's sixteen cases
def test_lineidx_parse_exact():
    offs = [0, 1, 99, 12345, 2**40, 2**52 + 17]
    blob = "\n".join(str(o) for o in offs).encode() + b"\n"
    assert native.lineidx_parse(blob).tolist() == offs
    blob2 = b"0\r\n42\r\n\r\n7\n\n"
    assert native.lineidx_parse(blob2).tolist() == [0, 42, 7]
    with pytest.raises(ValueError):
        native.lineidx_parse(b"12\nab\n")


def test_b64_roundtrip():
    rng = np.random.default_rng(0)
    for n in [0, 1, 2, 3, 57, 10000]:
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native.b64_decode(base64.b64encode(raw)) == raw
        assert native.b64_decode(base64.encodebytes(raw)) == raw
    with pytest.raises(ValueError):
        native.b64_decode(b"a!b=")


@pytest.mark.parametrize("h,w,smooth,q", [(240, 320, False, 90),
                                          (97, 131, True, 75),
                                          (64, 64, True, 95),
                                          (375, 500, True, 90)])
def test_jpeg_decode_bit_identical_to_pil(h, w, smooth, q):
    rng = np.random.default_rng(1 + h)
    data = _jpeg(_rand_img(rng, h, w, smooth), q)
    assert native.jpeg_dims(data) == (w, h)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(native.jpeg_decode(data), pil)


def test_jpeg_decode_grayscale_source():
    g = np.random.default_rng(2).integers(0, 256, (80, 60), dtype=np.uint8)
    b = io.BytesIO()
    Image.fromarray(g, "L").save(b, "JPEG", quality=90)
    pil = np.asarray(Image.open(io.BytesIO(b.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(native.jpeg_decode(b.getvalue()), pil)


def test_jpeg_decode_garbage_and_cmyk_return_none():
    assert native.jpeg_dims(b"not a jpeg") is None
    assert native.jpeg_decode(b"\xff\xd8\xff garbage") is None
    cmyk = _jpeg(_rand_img(np.random.default_rng(3), 40, 40), mode="CMYK")
    assert native.jpeg_dims(cmyk) == (40, 40)
    assert native.jpeg_decode(cmyk) is None       # PIL's to convert


@pytest.mark.parametrize("d", [2, 4, 8])
def test_jpeg_scaled_decode_dims(d):
    data = _jpeg(_rand_img(np.random.default_rng(3), 250, 330, smooth=True))
    assert native.jpeg_decode(data, scale_denom=d).shape == (
        -(-250 // d), -(-330 // d), 3)


@pytest.mark.parametrize("smooth", [False, True])
def test_crop_resize_matches_pil_within_1lsb(smooth):
    arr = _rand_img(np.random.default_rng(4), 240, 320, smooth)
    pim = Image.fromarray(arr)
    for (t, l, h, w, s) in [(10, 20, 180, 250, 224), (0, 0, 240, 320, 96),
                            (5, 5, 64, 64, 128), (3, 7, 100, 90, 224),
                            (0, 0, 240, 320, 224), (12.5, 3.25, 99.5, 120.75,
                                                    96)]:
        ours = native.crop_resize(arr, (t, l, t + h, l + w), (s, s))
        ref = np.asarray(pim.resize((s, s), Image.BICUBIC,
                                    box=(l, t, l + w, t + h)))
        d = np.abs(ours.astype(int) - ref.astype(int))
        assert d.max() <= 1, (t, l, h, w, s, d.max())


def test_decode_multicrop_matches_manual_views():
    data = _jpeg(_rand_img(np.random.default_rng(5), 300, 400, smooth=True))
    full = native.jpeg_decode(data)
    boxes = np.array([[10, 20, 250, 330], [0, 0, 300, 400], [40, 60, 90, 90]],
                     np.float64)
    sizes = [224, 224, 96]
    views = native.decode_multicrop(data, boxes, sizes, allow_scaled=False)
    for (t, l, h, w), s, v in zip(boxes, sizes, views):
        ref = native.crop_resize(full, (t, l, t + h, l + w), (s, s))
        np.testing.assert_array_equal(v, ref)


def test_multicrop_batch_rows_and_status():
    rng = np.random.default_rng(6)
    jpegs = [_jpeg(_rand_img(rng, 200, 260, smooth=True)) for _ in range(4)]
    jpegs[2] = b"corrupt"
    boxes = np.tile(np.array([[0, 0, 200, 260], [50, 60, 100, 120]],
                             np.float64), (4, 1, 1))
    sizes = [128, 64]
    outs = [np.zeros((5, s, s, 3), np.uint8) for s in sizes]
    rows = [4, 0, 2, 1]
    status = native.multicrop_batch(jpegs, boxes, sizes, outs, rows,
                                    allow_scaled=False, nthreads=3)
    assert status[2] != 0 and all(status[i] == 0 for i in (0, 1, 3))
    for i in (0, 1, 3):
        full = native.jpeg_decode(jpegs[i])
        for v, s in enumerate(sizes):
            t, l, h, w = boxes[i, v]
            ref = native.crop_resize(full, (t, l, t + h, l + w), (s, s))
            np.testing.assert_array_equal(outs[v][rows[i]], ref)
    assert not outs[0][2].any() and not outs[0][3].any()   # untouched rows
    with pytest.raises(ValueError, match="img_rows"):
        native.multicrop_batch(jpegs, boxes, sizes, outs, [0, 1, 2, 5])


def test_scaled_decode_close_to_exact():
    data = _jpeg(_rand_img(np.random.default_rng(7), 1024, 1280, smooth=True))
    boxes = np.array([[0, 0, 1000, 1200], [100, 100, 900, 900]], np.float64)
    sizes = [224, 96]
    exact = native.decode_multicrop(data, boxes, sizes, allow_scaled=False)
    fast = native.decode_multicrop(data, boxes, sizes, allow_scaled=True)
    for e, f in zip(exact, fast):
        d = np.abs(e.astype(np.float64) - f.astype(np.float64))
        assert float(np.sqrt((d ** 2).mean())) < 4.0
        assert float(d.mean()) < 2.5


def _jpeg_folder(root, n, seed, size=(180, 220), png=()):
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root / f"class_{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        img = Image.fromarray(_rand_img(rng, *size, smooth=True))
        if i in png:
            img.save(d / f"{i}.png")
        else:
            img.save(d / f"{i}.jpg", quality=92)
    return str(root)


T_CROPS = tcfg.CropConfig(global_size=64, local_size=32, local_crops_number=3)
J_CROPS = jcfg.CropConfig(global_size=64, local_size=32, local_crops_number=3)


def test_loader_native_path_matches_pil_path(tmp_path):
    """native_decode True vs False: identical geometry (the same boxes),
    pixels within the resample tolerance through the photometrics."""
    ds = tdata.ImageFolder(_jpeg_folder(tmp_path, 8, 8))

    def batches(nat):
        it = tloader.MultiCropIterator(ds, T_CROPS, 4, seed=3, num_threads=2,
                                       native_decode=nat, device="cpu")
        return list(it), it

    (a, ia), (b, ib) = batches(False), batches(True)
    assert len(a) == len(b) == 2
    assert (ia.native_images, ia.pil_images) == (0, 8)
    assert (ib.native_images, ib.pil_images) == (8, 0)
    for (g0, l0), (g1, l1) in zip(a, b):
        assert g0.shape == g1.shape and l0.shape == l1.shape
        assert float((g0 - g1).abs().mean()) < 0.02
        assert float((l0 - l1).abs().mean()) < 0.02


def test_loader_native_falls_back_for_non_jpeg(tmp_path):
    ds = tdata.ImageFolder(_jpeg_folder(tmp_path, 4, 9, (100, 100),
                                        png=range(4)))
    kw = dict(seed=1, num_threads=1, device="cpu")
    it = tloader.MultiCropIterator(ds, T_CROPS, 4, native_decode=True, **kw)
    a = list(it)
    b = list(tloader.MultiCropIterator(ds, T_CROPS, 4, native_decode=False,
                                       **kw))
    assert (it.native_images, it.pil_images) == (0, 4)
    for (g0, l0), (g1, l1) in zip(a, b):
        assert torch.equal(g0, g1) and torch.equal(l0, l1)


@pytest.mark.parametrize("h,w", [(480, 640), (300, 280), (256, 256),
                                 (1024, 768)])
def test_eval_transform_bytes_matches_pil(h, w):
    from esvit_tpu_torch.evals.knn import eval_transform, eval_transform_bytes

    data = _jpeg(_rand_img(np.random.default_rng(11 + h), h, w, smooth=True),
                 quality=92)
    ref = eval_transform(Image.open(io.BytesIO(data)))
    ours = eval_transform_bytes(data)
    assert ours is not None and ours.shape == ref.shape == (224, 224, 3)
    d = np.abs(ours - ref)
    assert float(d.max()) <= 3.2 * LSB, float(d.max()) / LSB
    assert float(d.mean()) <= 0.35 * LSB


def test_eval_transform_bytes_small_image_falls_back():
    from esvit_tpu_torch.evals.knn import eval_transform_bytes

    assert eval_transform_bytes(b"junk") is None
    png = io.BytesIO()
    Image.fromarray(_rand_img(np.random.default_rng(0), 100, 120)).save(
        png, "PNG")
    assert eval_transform_bytes(png.getvalue()) is None
    small = _jpeg(_rand_img(np.random.default_rng(0), 100, 120))
    assert eval_transform_bytes(small).shape == (224, 224, 3)
    # A crop wider than the 256 px short side of the resize: PIL's.
    assert eval_transform_bytes(small, size=288) is None


def test_extract_uses_native_bytes_path(tmp_path):
    """extract_dataset_features through transform_bytes against the PIL
    path on an ImageFolder of JPEGs and one PNG (identity forward); the
    counts of each path."""
    from esvit_tpu_torch.evals.extract import extract_dataset_features
    from esvit_tpu_torch.evals.knn import eval_transform, eval_transform_bytes

    ds = tdata.ImageFolder(_jpeg_folder(tmp_path, 6, 12, (260, 300),
                                        png=(4,)))
    fwd = lambda x: np.asarray(x).reshape(len(x), -1)[:, :16]   # noqa: E731
    fa, la = extract_dataset_features(fwd, ds, eval_transform, batch_size=4)
    counts = {}
    fb, lb = extract_dataset_features(fwd, ds, eval_transform, batch_size=4,
                                      transform_bytes=eval_transform_bytes,
                                      counts=counts)
    np.testing.assert_array_equal(la, lb)
    assert float(np.abs(fa - fb).mean()) < 0.02
    assert counts == {"native": 5, "pil": 1}


def test_tsv_native_lineidx_and_raw_bytes(tmp_path):
    rng = np.random.default_rng(10)
    rows = []
    for i in range(5):
        data = _jpeg(_rand_img(rng, 60, 80, smooth=True))
        rows.append(f"k{i}\t{i % 3}\t{base64.b64encode(data).decode()}")
    tsv = tmp_path / "d.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    ds = tdata.TSVDataset(str(tsv))
    blob = tsv.read_bytes()
    pos, expect = 0, []
    for line in blob.splitlines(keepends=True):
        expect.append(pos)
        pos += len(line)
    assert list(ds.tsv.offsets) == expect
    data, label = ds.raw_bytes(3)
    img, label2 = ds[3]
    assert label == label2 == 0
    np.testing.assert_array_equal(native.jpeg_decode(data), np.asarray(img))


# ------------------------------------------------------- the port's own cases
def test_crops_equal_esvit_tpu_native_byte_for_byte():
    """The same source under the same g++ flags: the same bytes as
    esvit_tpu.native (where it builds here; always within PIL's 1 LSB)."""
    rng = np.random.default_rng(20)
    jpegs = [_jpeg(_rand_img(rng, 375, 500, smooth=True)),
             _jpeg(_rand_img(rng, 500, 375)), _jpeg(_rand_img(rng, 64, 900))]
    boxes = np.array([[[0, 0, 300, 370], [10.5, 3.0, 200, 150.5],
                       [50, 60, 40, 45]]] * 3, np.float64)
    boxes[2] = [[0, 0, 64, 900], [3, 100, 50, 400], [10, 10, 20, 20]]
    sizes = [224, 96, 96]
    outs = [np.zeros((3, s, s, 3), np.uint8) for s in sizes]
    status = native.multicrop_batch(jpegs, boxes, sizes, outs, [0, 1, 2],
                                    nthreads=2)
    assert not status.any()
    for i, data in enumerate(jpegs):
        pil = Image.open(io.BytesIO(data)).convert("RGB")
        for v, s in enumerate(sizes):
            t, l, h, w = boxes[i, v]
            want = np.asarray(pil.resize((s, s), Image.BICUBIC,
                                         box=(l, t, l + w, t + h)))
            assert np.abs(outs[v][i].astype(int) - want).max() <= 1
    ref = _reference_native()
    if ref is not None:
        ref_outs = [np.zeros_like(o) for o in outs]
        ref.multicrop_batch(jpegs, boxes, sizes, ref_outs, [0, 1, 2])
        for a, b in zip(outs, ref_outs):
            np.testing.assert_array_equal(a, b)
        arr = _rand_img(rng, 97, 131)
        np.testing.assert_array_equal(
            native.crop_resize(arr, (1.5, 2.5, 90, 120), (64, 48)),
            ref.crop_resize(arr, (1.5, 2.5, 90, 120), (64, 48)))


def _zip_store(tmp_path, n=12, seed=0):
    """A zip of n images (class i % 3): JPEGs, one PNG, one grayscale JPEG
    and one CMYK JPEG (which libjpeg refuses: PIL's fallback)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        arr = _rand_img(rng, 60 + 3 * i, 80 + i, smooth=True)
        b = io.BytesIO()
        if i == 3:
            Image.fromarray(arr).save(b, "PNG")
            name = f"c/{i}.png"
        else:
            img = Image.fromarray(arr)
            img = {5: img.convert("L"), 7: img.convert("CMYK")}.get(i, img)
            img.save(b, "JPEG", quality=90)
            name = f"c/{i}.jpg"
        items.append((name, b.getvalue(), i % 3))
    stores.write_zip(items, str(tmp_path / "a.zip"), str(tmp_path / "m.txt"))
    return str(tmp_path / "a.zip"), str(tmp_path / "m.txt")


@pytest.mark.parametrize("nat", [True, False])
def test_loader_batches_equal_esvit_tpu_per_sample_path(tmp_path, nat):
    """The port fills a batch with one multicrop_batch call into its
    view-major buffer; esvit_tpu decodes per sample and stacks. The bytes
    are the same (native: where esvit_tpu.native builds; PIL: always),
    the counts those of the samples' kinds."""
    zp, mp = _zip_store(tmp_path)
    B = 4
    it = tloader.MultiCropIterator(tdata.ZipData(zp, mp), T_CROPS, B,
                                   seed=3, num_threads=2, native_decode=nat,
                                   device="cpu")
    got = [(g.numpy(), loc.numpy()) for g, loc in it.host_batches()]
    assert (it.native_images, it.pil_images) == ((10, 2) if nat else (0, 12))
    if nat and _reference_native() is None:
        return
    jit_ = jloader.MultiCropIterator(jdata.ZipData(zp, mp), J_CROPS, B,
                                     seed=3, native_decode=nat)
    assert np.array_equal(it.indices, jit_.indices)
    for b, (g, loc) in enumerate(got):
        views = [jit_._sample_views(i, hash((3, 0, int(i), b * B + s))
                                    & 0x7FFFFFFF)
                 for s, i in enumerate(jit_.indices[b * B:(b + 1) * B])]
        rg, rl = jit_._assemble(views)
        np.testing.assert_array_equal(g, rg)
        np.testing.assert_array_equal(loc, rl)


def test_library_without_libjpeg(tmp_path, monkeypatch):
    """The -DDP_NO_JPEG variant: no JPEG functions; its crops of PIL's
    decode equal the full library's; the loader decodes with PIL and crops
    natively (the CMYK JPEG too, which PIL converts), the same bytes as the
    full library's batches but for that image, within 1 LSB."""
    lib = native.load(jpeg=False)
    assert not lib.jpeg and native.load(jpeg=True).jpeg
    data = _jpeg(_rand_img(np.random.default_rng(30), 120, 160, smooth=True))
    with pytest.raises(RuntimeError, match="without its JPEG half"):
        lib.jpeg_dims(data)
    png = io.BytesIO()
    Image.fromarray(_rand_img(np.random.default_rng(31), 8, 8)).save(png,
                                                                     "PNG")
    assert lib.source(png.getvalue()) is None
    assert native.load(jpeg=True).source(png.getvalue()) is None
    pixels, dims = lib.source(data)
    assert dims == (160, 120) and pixels.shape == (120, 160, 3)
    pixels = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    boxes = np.array([[[5, 6, 100, 120], [0, 0, 120, 160]]], np.float64)
    outs = [np.zeros((1, s, s, 3), np.uint8) for s in (64, 32)]
    assert not lib.crop_batch([pixels], boxes, [64, 32], outs, [0]).any()
    want = native.decode_multicrop(data, boxes[0], [64, 32],
                                   allow_scaled=False)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o[0], w)

    zp, mp = _zip_store(tmp_path)
    ds = tdata.ZipData(zp, mp)
    kw = dict(seed=3, num_threads=2, native_decode=True, device="cpu")
    full = [(g.numpy(), loc.numpy()) for g, loc in
            tloader.MultiCropIterator(ds, T_CROPS, 4, **kw).host_batches()]
    monkeypatch.setattr(native, "library", lambda: lib)
    it = tloader.MultiCropIterator(ds, T_CROPS, 4, **kw)
    got = [(g.numpy(), loc.numpy()) for g, loc in it.host_batches()]
    assert (it.native_images, it.pil_images) == (11, 1)
    cmyk = [p for p, i in enumerate(it.indices) if i == 7][0]
    for b, ((g, loc), (fg, floc)) in enumerate(zip(got, full)):
        for x, y in ((g, fg), (loc, floc)):
            d = np.abs(x.astype(int) - y.astype(int))
            assert d.max() <= 1
            rows = np.nonzero(d.reshape(len(d), -1).max(1))[0]
            assert all((r % 4) + b * 4 == cmyk for r in rows)


def test_build_is_locked_and_renamed_into_place(tmp_path, monkeypatch):
    """Four threads build at once into an empty directory: one library,
    no temporary left; a second call finds it."""
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build(jpeg=False))
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and paths[0].exists()
    files = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert files == sorted([paths[0].name, "datapath.lock"])
    assert native.build(jpeg=False) == paths[0]


def test_build_failure_is_raised_with_the_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "datapath.cpp"
    bad.write_text("int dp_version(void) { return }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(native.BuildError, match="error"):
        native.build(jpeg=False)
    assert not any((tmp_path / "build").glob("*.tmp"))

    def broken():
        raise native.BuildError("g++ failed (1) on datapath.cpp: boom")

    ds = tdata.ImageFolder(_jpeg_folder(tmp_path / "img", 4, 0, (60, 60)))
    monkeypatch.setattr(native, "library", broken)
    with pytest.raises(native.BuildError, match="boom"):
        tloader.MultiCropIterator(ds, T_CROPS, 2, native_decode=True,
                                  device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    it = tloader.MultiCropIterator(ds, T_CROPS, 2, device="cpu")
    assert it.native is None                      # auto: PIL
    assert next(it.host_batches())[0].shape == (4, 64, 64, 3)


def test_native_threads_and_bad_arguments():
    """multicrop_batch across more threads than images gives the serial
    bytes; wrong buffers are refused before any pointer is passed."""
    rng = np.random.default_rng(40)
    jpegs = [_jpeg(_rand_img(rng, 90, 70, smooth=True)) for _ in range(3)]
    boxes = np.tile(np.array([[0, 0, 90, 70], [10, 5, 40, 30]], np.float64),
                    (3, 1, 1))
    runs = []
    for threads in (1, 8):
        outs = [np.zeros((3, s, s, 3), np.uint8) for s in (32, 16)]
        native.multicrop_batch(jpegs, boxes, [32, 16], outs, [0, 1, 2],
                               nthreads=threads)
        runs.append(outs)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.multicrop_batch(jpegs, boxes, [32, 16],
                               [np.zeros((3, 32, 32, 3), np.float32),
                                runs[0][1]], [0, 1, 2])
    with pytest.raises(ValueError, match="boxes"):
        native.multicrop_batch(jpegs, boxes[:, :1], [32, 16], runs[0],
                               [0, 1, 2])
    with pytest.raises(ValueError, match="view_outs"):
        native.multicrop_batch(jpegs, boxes, [32, 16],
                               [runs[0][1], runs[0][1]], [0, 1, 2])
