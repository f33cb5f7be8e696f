"""Remote shard storage with a local LRU cache (port of
esvit_tpu/data/remote.py; ref: datasets/blob_storage.py:49-186).

TSV or zip shards that live in object storage are fetched on first touch
by an external copier (gsutil, azcopy or curl, by the URL's scheme; or a
``copier`` the caller passes), kept in a bounded local cache with LRU
eviction, with bounded retries, each rank downloading to a name of its own
and renaming it into place, so concurrent ranks never clobber each
other's files. Nothing here touches the network until ``fetch`` runs a
copier.
"""

from __future__ import annotations

import bisect
import os
import subprocess
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from esvit_tpu_torch.data.datasets import TSVDataset


def copier_cmd(url: str, dst: str) -> list[str]:
    """The command that copies ``url`` to the local file ``dst``."""
    if url.startswith("gs://"):
        return ["gsutil", "-q", "cp", url, dst]
    if url.startswith(("http://", "https://")) and "blob.core.windows.net" in url:
        return ["azcopy", "copy", url, dst]
    if url.startswith(("http://", "https://")):
        return ["curl", "-fsSL", "-o", dst, url]
    raise ValueError(f"no copier for url {url!r}")


class RemoteShardCache:
    """At most ``max_files`` shards in ``cache_dir``, the least recently
    fetched evicted first. ``copier(url, dst)`` gives the command that
    copies a shard; ``retries`` attempts, 1 s apart, doubling up to 10.
    Thread-safe."""

    def __init__(self, cache_dir: str, max_files: int = 8,
                 retries: int = 3, rank: int = 0,
                 copier: Callable[[str, str], list[str]] = copier_cmd):
        self.cache_dir = os.path.abspath(cache_dir)
        os.makedirs(self.cache_dir, exist_ok=True)
        self.max_files = max_files
        self.retries = retries
        self.rank = rank
        self.copier = copier
        self._lru: "OrderedDict[str, str]" = OrderedDict()
        self._lock = threading.Lock()

    def local_path(self, url: str) -> str:
        return os.path.join(self.cache_dir, os.path.basename(url))

    def cached(self, path: str) -> bool:
        """Whether ``path`` is in the cache (not evicted)."""
        with self._lock:
            return path in self._lru

    def fetch(self, url: str) -> str:
        """A local path of the shard, downloaded if needed."""
        path = self.local_path(url)
        with self._lock:
            if path in self._lru:
                self._lru.move_to_end(path)
                return path
            if not os.path.isfile(path):
                self._download(url, path)
            self._lru[path] = url
            self._evict()
        return path

    def _download(self, url: str, path: str) -> None:
        # A rank-suffixed temporary, then a rename (blob_storage.py:
        # 156-164): concurrent ranks each download to their own file; the
        # first rename wins.
        tmp = f"{path}.rank{self.rank}.tmp"
        err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                subprocess.run(self.copier(url, tmp), check=True,
                               capture_output=True)
                if not os.path.isfile(path):
                    os.replace(tmp, path)
                else:
                    os.unlink(tmp)
                return
            except (subprocess.CalledProcessError, OSError) as e:
                err = e
                if attempt + 1 < self.retries:
                    time.sleep(min(2 ** attempt, 10))
        raise RuntimeError(f"failed to fetch {url} after {self.retries} "
                           f"attempts") from err

    def _evict(self) -> None:
        while len(self._lru) > self.max_files:
            path, _ = self._lru.popitem(last=False)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


class RemoteCompositeTSV:
    """CompositeTSVDataset over remote shard URLs: each shard is fetched
    through the cache when an index in it is read (pair it with the
    chunk-aware sampler so each process touches few shards an epoch).
    ``chunk_sizes``, the rows per shard, come from a manifest (the
    reference keeps them beside the shard list, tsv_file.py:167-257). A
    shard the cache evicted is fetched again when it is read again."""

    def __init__(self, urls: list[str], cache: RemoteShardCache,
                 chunk_sizes: Optional[list[int]] = None):
        if chunk_sizes is None:
            raise ValueError("chunk_sizes manifest required for remote TSVs")
        if len(chunk_sizes) != len(urls):
            raise ValueError("one chunk size per shard URL")
        self.urls = urls
        self.cache = cache
        self.chunk_sizes = list(chunk_sizes)
        self.cum = [0]
        for n in self.chunk_sizes:
            self.cum.append(self.cum[-1] + n)
        self._open: dict[int, TSVDataset] = {}
        self._lock = threading.Lock()

    def __len__(self):
        return self.cum[-1]

    def _shard(self, i: int) -> tuple[TSVDataset, int]:
        s = bisect.bisect_right(self.cum, i) - 1
        path = self.cache.fetch(self.urls[s])
        with self._lock:
            ds = self._open.get(s)
            if ds is None:
                ds = self._open[s] = TSVDataset(path)
            # Forget the shards the cache has evicted.
            for k in [k for k, d in self._open.items()
                      if not self.cache.cached(d.tsv.tsv_path)]:
                del self._open[k]
        return ds, i - self.cum[s]

    def __getitem__(self, i: int):
        ds, j = self._shard(i)
        return ds[j]

    def raw_bytes(self, i: int):
        ds, j = self._shard(i)
        return ds.raw_bytes(j)
