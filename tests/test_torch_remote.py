"""The port's remote shard cache (esvit_tpu_torch/data/remote.py) against
esvit_tpu's, on the CPU, with a fake copier.

The copier is a local command that copies a file standing for the
shard's remote object (``fake://bucket/<name>`` -> a file in a "bucket"
directory) and logs each call; nothing touches the network. Held: the
command chosen per URL scheme; a first fetch downloads through a
rank-suffixed temporary and renames it, a second is a cache hit; the
least recently fetched shard is evicted past ``max_files``; a failing
copier is retried, then raised; a rank that finds the file already
renamed by another keeps it and drops its own; RemoteCompositeTSV reads
the same items as esvit_tpu's, fetches each shard when first read, and
fetches an evicted shard again.
"""

import os
import sys

import numpy as np
import pytest

from esvit_tpu.data import remote as jremote
from esvit_tpu_torch.data import remote as tremote
from esvit_tpu_torch.data import stores
from tests.torch_threads import one_intra_op_thread  # noqa: F401

COPY = ("import shutil, sys\n"
        "open(sys.argv[3], 'a').write(sys.argv[1] + ' ' + sys.argv[2] + '\\n')\n"
        "shutil.copyfile(sys.argv[1], sys.argv[2])\n")


def _fake_copier(bucket, log):
    def cmd(url, dst):
        src = os.path.join(bucket, url.split("://", 1)[1].split("/", 1)[1])
        return [sys.executable, "-c", COPY, src, dst, str(log)]
    return cmd


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


@pytest.fixture
def bucket(tmp_path):
    b = tmp_path / "bucket"
    b.mkdir()
    for k in range(4):
        (b / f"shard{k}.bin").write_bytes(bytes([k]) * (10 + k))
    return b


@pytest.mark.parametrize("url,head", [
    ("gs://b/x.tsv", ["gsutil", "-q", "cp"]),
    ("https://acc.blob.core.windows.net/c/x.tsv", ["azcopy", "copy"]),
    ("https://example.org/x.tsv", ["curl", "-fsSL", "-o"])])
def test_copier_by_scheme_matches_esvit_tpu(url, head):
    assert tremote.copier_cmd(url, "/d") == jremote._copier_cmd(url, "/d")
    assert tremote.copier_cmd(url, "/d")[:len(head)] == head
    with pytest.raises(ValueError):
        tremote.copier_cmd("ftp://x", "/d")


def test_fetch_renames_into_place_and_hits(tmp_path, bucket):
    log = tmp_path / "log"
    cache = tremote.RemoteShardCache(str(tmp_path / "cache"), rank=3,
                                     copier=_fake_copier(bucket, log))
    path = cache.fetch("fake://b/shard1.bin")
    assert path == str(tmp_path / "cache" / "shard1.bin")
    assert open(path, "rb").read() == (bucket / "shard1.bin").read_bytes()
    calls = _calls(log)
    assert len(calls) == 1 and calls[0].endswith("shard1.bin.rank3.tmp")
    assert os.listdir(tmp_path / "cache") == ["shard1.bin"]
    assert cache.fetch("fake://b/shard1.bin") == path
    assert len(_calls(log)) == 1                  # a hit: no copy


def test_lru_eviction_matches_esvit_tpu(tmp_path, bucket, monkeypatch):
    """The same fetch sequence through both caches leaves the same files
    and makes the same copies."""
    order = [0, 1, 0, 2, 3, 1, 0]
    logs = {}
    for side in ("port", "ref"):
        log = tmp_path / f"{side}.log"
        copier = _fake_copier(bucket, log)
        d = str(tmp_path / side)
        if side == "port":
            cache = tremote.RemoteShardCache(d, max_files=2, copier=copier)
        else:
            monkeypatch.setattr(jremote, "_copier_cmd", copier)
            cache = jremote.RemoteShardCache(d, max_files=2)
        for k in order:
            cache.fetch(f"fake://b/shard{k}.bin")
        logs[side] = ([os.path.basename(c.split()[0]) for c in _calls(log)],
                      sorted(os.listdir(d)))
    assert logs["port"] == logs["ref"]
    assert logs["port"][1] == ["shard0.bin", "shard1.bin"]


def test_failing_copier_is_retried_then_raised(tmp_path, monkeypatch):
    log = tmp_path / "log"
    slept = []
    monkeypatch.setattr(tremote.time, "sleep", slept.append)
    cache = tremote.RemoteShardCache(
        str(tmp_path / "cache"), retries=3,
        copier=_fake_copier(str(tmp_path / "nowhere"), log))
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        cache.fetch("fake://b/missing.bin")
    assert len(_calls(log)) == 3 and slept == [1, 2]
    assert os.listdir(tmp_path / "cache") == []


def test_a_rank_that_loses_the_rename_keeps_the_winner(tmp_path, bucket):
    """Two ranks download one shard into one cache directory: the second
    to finish finds the file and drops its temporary."""
    d = str(tmp_path / "cache")
    first = tremote.RemoteShardCache(d, rank=0,
                                     copier=_fake_copier(bucket, tmp_path / "a"))
    first.fetch("fake://b/shard2.bin")
    won = os.stat(os.path.join(d, "shard2.bin")).st_ino

    def late(url, dst):      # rank 1 started before rank 0's rename
        assert dst.endswith(".rank1.tmp")
        return [sys.executable, "-c", COPY, str(bucket / "shard3.bin"), dst,
                str(tmp_path / "b")]

    second = tremote.RemoteShardCache(d, rank=1, copier=late)
    second._download("fake://b/shard2.bin", os.path.join(d, "shard2.bin"))
    assert os.listdir(d) == ["shard2.bin"]
    assert os.stat(os.path.join(d, "shard2.bin")).st_ino == won
    assert (tmp_path / "b").exists()             # it did download


def _tsv_bucket(tmp_path, sizes):
    from PIL import Image
    import io

    b = tmp_path / "tsvbucket"
    b.mkdir()
    rng = np.random.default_rng(0)
    for k, n in enumerate(sizes):
        items = []
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8)).save(
                buf, "JPEG")
            items.append((f"s{k}_{i}.jpg", buf.getvalue(), k))
        stores.write_tsv(items, str(b / f"s{k}.tsv"))
    return b


def test_remote_composite_tsv(tmp_path, monkeypatch):
    """Items and raw bytes as esvit_tpu's RemoteCompositeTSV; each shard
    fetched when first read; with one file cached, a shard read again
    after its eviction is fetched again."""
    sizes = [3, 2, 4]
    b = _tsv_bucket(tmp_path, sizes)
    urls = [f"fake://b/s{k}.tsv" for k in range(3)]
    log = tmp_path / "log"
    port = tremote.RemoteCompositeTSV(
        urls, tremote.RemoteShardCache(str(tmp_path / "c1"), max_files=1,
                                       copier=_fake_copier(b, log)),
        chunk_sizes=sizes)
    monkeypatch.setattr(jremote, "_copier_cmd",
                        _fake_copier(b, tmp_path / "jlog"))
    ref = jremote.RemoteCompositeTSV(
        urls, jremote.RemoteShardCache(str(tmp_path / "c2"), max_files=8),
        chunk_sizes=sizes)
    assert len(port) == len(ref) == 9 and port.chunk_sizes == sizes
    # The .lineidx comes with neither copy: the reader writes it.
    for i in range(9):
        (a, la), (c, lc) = port[i], ref[i]
        assert la == lc
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    assert [c.split()[0][-6:] for c in _calls(log)] == ["s0.tsv", "s1.tsv",
                                                        "s2.tsv"]
    data, label = port.raw_bytes(0)              # s0 was evicted: again
    assert label == 0 and data[:2] == b"\xff\xd8"
    assert len(_calls(log)) == 4
    with pytest.raises(ValueError, match="chunk_sizes"):
        tremote.RemoteCompositeTSV(urls, port.cache)
