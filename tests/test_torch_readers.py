"""The port's dataset readers (esvit_tpu_torch/data/datasets.py,
data/stores.py) against esvit_tpu's, on the CPU.

Every store is written here from a numpy seed: JPEGs and PNGs in a zip
with its map file, in TSVs (one and several shards, OpenImages labels,
image-text pairs) and under a file list. Each reader of the port gives
the same length, labels, pixels and encoded bytes as esvit_tpu's reader
of the same files (bit for bit: the same PIL decode), the same
``.lineidx`` bytes and offsets, the same chunk bookkeeping; the chunk
sampler through the iterator takes the same indices as esvit_tpu's
iterator.
"""

import io
import json
import os
import threading

import numpy as np
import pytest
from PIL import Image

from esvit_tpu import config as jcfg
from esvit_tpu.data import datasets as jdata
from esvit_tpu.data import loader as jloader
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.data import datasets as tdata
from esvit_tpu_torch.data import loader as tloader
from esvit_tpu_torch.data import stores
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _items(n, seed, png=(3,)):
    """n (name, bytes, label) items: smooth random JPEGs (class i % 4),
    PNGs at ``png``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        arr = rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(arr).resize((50, 40 + i),
                                                     Image.BILINEAR))
        b = io.BytesIO()
        fmt, ext = ("PNG", "png") if i in png else ("JPEG", "jpg")
        Image.fromarray(arr).save(b, fmt)
        out.append((f"d{i % 2}/img{i:03d}.{ext}", b.getvalue(), i % 4))
    return out


def _same_items(port, ref, raw=True):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        (a, la), (b, lb) = port[i], ref[i]
        assert la == lb and a.mode == b.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if raw:
            assert port.raw_bytes(i) == ref.raw_bytes(i)


def test_image_folder_and_raw_bytes(tmp_path):
    for name, data, label in _items(6, 0):
        path = tmp_path / f"class{label}" / os.path.basename(name)
        path.parent.mkdir(exist_ok=True)
        path.write_bytes(data)
    port, ref = tdata.ImageFolder(str(tmp_path)), jdata.ImageFolder(
        str(tmp_path))
    assert port.samples == ref.samples and port.class_to_idx == ref.class_to_idx
    _same_items(port, ref)
    assert port.raw_bytes(port.samples.index(
        next(s for s in port.samples if s[0].endswith(".png")))) is None


def test_zip_data(tmp_path):
    items = _items(7, 1)
    stores.write_zip(items, str(tmp_path / "a.zip"), str(tmp_path / "m.txt"))
    port = tdata.ZipData(str(tmp_path / "a.zip"), str(tmp_path / "m.txt"))
    ref = jdata.ZipData(str(tmp_path / "a.zip"), str(tmp_path / "m.txt"))
    assert port.samples == ref.samples == [(n, lab) for n, _, lab in items]
    _same_items(port, ref)
    assert port.raw_bytes(3) is None and port.raw_bytes(2) == (items[2][1], 2)


def test_zip_data_one_handle_per_thread(tmp_path):
    """Threads read the zip at once, each through its own ZipFile."""
    items = _items(8, 2, png=())
    stores.write_zip(items, str(tmp_path / "a.zip"), str(tmp_path / "m.txt"))
    ds = tdata.ZipData(str(tmp_path / "a.zip"), str(tmp_path / "m.txt"))
    handles, errors = [], []
    together = threading.Barrier(4, timeout=60)

    def read():
        try:
            together.wait()
            for i in range(len(ds)):
                assert ds.raw_bytes(i)[0] == items[i][1]
            handles.append(ds._zf())            # kept alive for the count
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=read) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len({id(h) for h in handles}) == 4


def test_generate_lineidx_and_tsv_file(tmp_path):
    stores.write_tsv(_items(5, 3), str(tmp_path / "a.tsv"))
    # The writer's sidecar is esvit_tpu's generate_lineidx's, byte for byte.
    jdata.generate_lineidx(str(tmp_path / "a.tsv"), str(tmp_path / "j.idx"))
    tdata.generate_lineidx(str(tmp_path / "a.tsv"), str(tmp_path / "t.idx"))
    assert ((tmp_path / "a.lineidx").read_bytes()
            == (tmp_path / "j.idx").read_bytes()
            == (tmp_path / "t.idx").read_bytes())
    os.unlink(tmp_path / "a.lineidx")           # the reader writes it again
    port = tdata.TSVFile(str(tmp_path / "a.tsv"))
    assert (tmp_path / "a.lineidx").read_bytes() == (
        tmp_path / "j.idx").read_bytes()
    ref = jdata.TSVFile(str(tmp_path / "a.tsv"))
    assert list(port.offsets) == list(ref.offsets) and len(port) == 5
    for i in range(5):
        assert port.seek(i) == ref.seek(i)


@pytest.mark.parametrize("cell,want", [("3", 3), ('[{"class": 7}]', 7),
                                       ('[{"class": "x"}]', -1), ("[]", -1),
                                       ('{"class": 2}', -1)])
def test_label_cells(cell, want):
    assert tdata._label_from_json(cell) == jdata._label_from_json(cell) == want


def test_tsv_dataset(tmp_path):
    stores.write_tsv(_items(6, 4), str(tmp_path / "a.tsv"))
    _same_items(tdata.TSVDataset(str(tmp_path / "a.tsv")),
                jdata.TSVDataset(str(tmp_path / "a.tsv")))


def test_composite_tsv_dataset(tmp_path):
    paths = []
    for k, n in enumerate((3, 5, 2)):
        paths.append(str(tmp_path / f"s{k}.tsv"))
        stores.write_tsv(_items(n, 10 + k), paths[-1])
    port, ref = tdata.CompositeTSVDataset(paths), jdata.CompositeTSVDataset(
        paths)
    assert port.chunk_sizes == ref.chunk_sizes == [3, 5, 2]
    assert [port.shard_of(i) for i in range(10)] == [
        ref.shard_of(i) for i in range(10)]
    _same_items(port, ref)


def test_openimages_tsv_dataset(tmp_path):
    items = _items(5, 5)
    stores.write_tsv(items, str(tmp_path / "img.tsv"))
    labels = [json.dumps([{"class": 9}, {"class": 1}]), "[]", "not json",
              json.dumps([{"class": 4}]), json.dumps([{}])]
    with open(tmp_path / "lab.tsv", "w") as f:
        for (name, _, _), cell in zip(items, labels):
            f.write(f"{name}\t{cell}\n")
    port = tdata.TSVOpenImageDataset(str(tmp_path / "img.tsv"),
                                     str(tmp_path / "lab.tsv"))
    ref = jdata.TSVOpenImageDataset(str(tmp_path / "img.tsv"),
                                    str(tmp_path / "lab.tsv"))
    _same_items(port, ref)
    assert [port[i][1] for i in range(5)] == [9, -1, -1, 4, -1]


@pytest.mark.parametrize("text_format,num_captions,tokenize", [
    ("txt", 1, False), ("json", 1, False), ("json", 2, False),
    ("json", 1, True)])
def test_tsv_image_text_dataset(tmp_path, text_format, num_captions,
                                tokenize):
    imgs, txts = [], []
    for k, n in enumerate((2, 3)):
        items = _items(n, 20 + k)
        imgs.append(str(tmp_path / f"i{k}.tsv"))
        stores.write_tsv(items, imgs[-1])
        txts.append(str(tmp_path / f"t{k}.tsv"))
        with open(txts[-1], "w") as f:
            for i, (name, _, _) in enumerate(items):
                caps = [f"a {name} {j}" for j in range(3)]
                cell = (json.dumps({"captions": caps})
                        if text_format == "json" else caps[0])
                f.write(f"{name}\t{cell}\n")
    tok = ((lambda text, context_length: np.zeros((1, context_length)))
           if tokenize else None)
    kw = dict(text_format=text_format, num_captions=num_captions,
              tokenize=tok, context_length=8, seed=5)
    port = tdata.TSVImageTextDataset(imgs, txts, **kw)
    ref = jdata.TSVImageTextDataset(imgs, txts, **kw)
    assert port.chunk_sizes == ref.chunk_sizes == [2, 3]
    for i in range(len(ref)):
        (a, ta), (b, tb) = port[i], ref[i]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if tokenize:
            assert ta.shape == tb.shape == (8,)
        else:
            assert ta == tb


def test_image_text_dataset_refuses_mismatches(tmp_path):
    stores.write_tsv(_items(2, 30), str(tmp_path / "i.tsv"))
    with open(tmp_path / "t.tsv", "w") as f:
        f.write("other\tcaption\nkey\tcaption\n")
    ds = tdata.TSVImageTextDataset(str(tmp_path / "i.tsv"),
                                   str(tmp_path / "t.tsv"))
    with pytest.raises(ValueError, match="keys do not match"):
        ds[0]
    with pytest.raises(ValueError, match="both be single"):
        tdata.TSVImageTextDataset(str(tmp_path / "i.tsv"),
                                  [str(tmp_path / "t.tsv")])


def test_file_list_dataset(tmp_path):
    items = _items(6, 6)
    stores.write_filelist(items, str(tmp_path / "root"),
                          str(tmp_path / "list.txt"))
    port = tdata.FileListDataset(str(tmp_path / "root"),
                                 str(tmp_path / "list.txt"))
    ref = jdata.FileListDataset(str(tmp_path / "root"),
                                str(tmp_path / "list.txt"))
    assert port.samples == ref.samples
    _same_items(port, ref)


@pytest.mark.parametrize("kind", ["folder", "zip", "tsv", "composite_tsv",
                                  "openimages_tsv", "filelist"])
def test_build_dataset_kinds(tmp_path, kind):
    """build_dataset builds each store kind from esvit_tpu's keywords, the
    same dataset as esvit_tpu's build_dataset."""
    items = _items(4, 7)
    stores.write_zip(items, str(tmp_path / "a.zip"), str(tmp_path / "m.txt"))
    stores.write_tsv(items, str(tmp_path / "a.tsv"))
    stores.write_tsv(items, str(tmp_path / "b.tsv"))
    stores.write_filelist(items, str(tmp_path / "root"),
                          str(tmp_path / "list.txt"))
    kw = {"folder": dict(root=str(tmp_path / "root")),
          "zip": dict(zip_path=str(tmp_path / "a.zip"),
                      map_file=str(tmp_path / "m.txt")),
          "tsv": dict(tsv_path=str(tmp_path / "a.tsv")),
          "composite_tsv": dict(tsv_paths=[str(tmp_path / "a.tsv"),
                                           str(tmp_path / "b.tsv")]),
          "openimages_tsv": dict(image_tsv=str(tmp_path / "a.tsv"),
                                 label_tsv=str(tmp_path / "b.tsv")),
          "filelist": dict(root=str(tmp_path / "root"),
                           list_file=str(tmp_path / "list.txt"))}[kind]
    port, ref = tdata.build_dataset(kind, **kw), jdata.build_dataset(kind,
                                                                     **kw)
    assert type(port).__name__ == type(ref).__name__
    _same_items(port, ref)


@pytest.mark.parametrize("epoch,pi,pc", [(0, 0, 1), (3, 1, 2)])
def test_chunk_sampler_through_the_iterator(tmp_path, epoch, pi, pc):
    """sampler_kind='chunk' over a composite TSV: the port's iterator takes
    esvit_tpu's iterator's indices, and its host batches are the same
    bytes through PIL."""
    paths = []
    for k, n in enumerate((4, 6, 2, 4)):
        paths.append(str(tmp_path / f"s{k}.tsv"))
        stores.write_tsv(_items(n, 40 + k, png=()), paths[-1])
    tcrops = tcfg.CropConfig(global_size=32, local_size=16,
                             local_crops_number=2)
    jcrops = jcfg.CropConfig(global_size=32, local_size=16,
                             local_crops_number=2)
    kw = dict(epoch=epoch, seed=2, sampler_kind="chunk", process_index=pi,
              process_count=pc, native_decode=False)
    port = tloader.MultiCropIterator(tdata.CompositeTSVDataset(paths),
                                     tcrops, 2, device="cpu", **kw)
    ref = jloader.MultiCropIterator(jdata.CompositeTSVDataset(paths), jcrops,
                                    2, **kw)
    assert np.array_equal(port.indices, ref.indices) and len(port) > 0
    for b, (g, loc) in enumerate(port.host_batches()):
        views = [ref._sample_views(i, hash((2, epoch, int(i), b * 2 + s))
                                   & 0x7FFFFFFF)
                 for s, i in enumerate(ref.indices[b * 2:(b + 1) * 2])]
        rg, rl = ref._assemble(views)
        np.testing.assert_array_equal(g.numpy(), rg)
        np.testing.assert_array_equal(loc.numpy(), rl)
