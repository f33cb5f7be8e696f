"""Shared feature-extraction machinery for the evals (port of
esvit_tpu/evals/extract.py).

- **Several processes**: each extracts a disjoint *strided* shard
  ``indices[rank::world]``, and the shards, padded to one length, are
  all-gathered (parallel/mesh.py) and merged back into dataset order, so
  every index is computed exactly once and every process returns the same
  full set (the reference shards with a DistributedSampler and gathers
  per batch, eval_knn.py:148-189; one padded gather at the end is the
  batched equivalent).
- **Host throughput**: decode + resize run on a thread pool with a bounded
  batch lookahead, overlapping host preprocessing with the device forward
  (the reference gets this from DataLoader workers, eval_knn.py:60-78);
  JPEGs can take the native decode and crop (``transform_bytes``), which
  runs outside the GIL.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np

from esvit_tpu_torch.parallel.mesh import make_mesh


def strided_shard(n: int, process_index: int, process_count: int
                  ) -> np.ndarray:
    """This process's dataset indices: disjoint, union covers range(n)."""
    return np.arange(process_index, n, process_count)


def pad_shard(x: np.ndarray, per: int, fill=0) -> np.ndarray:
    """Pad the leading dim to ``per`` rows (a shard to the gather's
    length, the last batch to the batch size)."""
    if len(x) == per:
        return x
    pad = np.full((per - len(x),) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad])


def merge_strided_shards(shards: np.ndarray, n: int) -> np.ndarray:
    """Inverse of strided_shard after a padded all-gather.

    shards: (process_count, ceil(n / process_count), ...), process p's rows
    the features of indices p, p+P, p+2P, ... Returns (n, ...) in dataset
    order, each index appearing exactly once."""
    pc = shards.shape[0]
    out = np.empty((n,) + shards.shape[2:], shards.dtype)
    for p in range(pc):
        ids = np.arange(p, n, pc)
        out[ids] = shards[p, :len(ids)]
    return out


def iter_batches(dataset, indices: Sequence[int],
                 transform: Callable[[object], np.ndarray],
                 batch_size: int, *, num_threads: int = 8,
                 lookahead: int = 2,
                 transform_bytes: Callable[[bytes], np.ndarray | None]
                 | None = None, counts: dict | None = None
                 ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Yield (images (B, ...), labels (B,), n_real) batches.

    Decodes with a thread pool and keeps ``lookahead`` batches in flight so
    host work overlaps the consumer's device work. The final batch is
    zero-padded to ``batch_size`` (n_real < batch_size marks the padding).

    transform_bytes: a path from the encoded bytes of
    ``dataset.raw_bytes`` straight to the transformed array (the native
    decode and crop, knn.eval_transform_bytes); where it returns None, or
    the sample has no bytes, the PIL ``transform`` runs. ``counts``, when
    given, has 'native' and 'pil' increased by the samples each path
    made.
    """
    raw = getattr(dataset, "raw_bytes", None) if transform_bytes else None

    def load(i):
        if raw is not None:
            item = raw(int(i))
            if item is not None:
                x = transform_bytes(item[0])
                if x is not None:
                    return x, item[1], "native"
        img, label = dataset[int(i)]
        return transform(img), label, "pil"

    chunks = [indices[s:s + batch_size]
              for s in range(0, len(indices), batch_size)]
    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        pending = []
        for c in chunks[:lookahead]:
            pending.append([ex.submit(load, i) for i in c])
        for ci in range(len(chunks)):
            if ci + lookahead < len(chunks):
                pending.append([ex.submit(load, i)
                                for i in chunks[ci + lookahead]])
            futs = pending.pop(0)
            items = [f.result() for f in futs]
            if counts is not None:
                for _, _, path in items:
                    counts[path] = counts.get(path, 0) + 1
            x = np.stack([p[0] for p in items])
            y = np.asarray([p[1] for p in items], np.int32)
            n = len(items)
            if n < batch_size:
                x = pad_shard(x, batch_size)
                y = pad_shard(y, batch_size, fill=-1)
            yield x, y, n


def extract_dataset_features(fwd: Callable[[np.ndarray], np.ndarray],
                             dataset, transform, *, batch_size: int = 64,
                             num_threads: int = 8, transform_bytes=None,
                             counts: dict | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """(features (N, C) f32, labels (N,) i32) in dataset order.

    fwd: batched image array -> feature array (the caller's forward on its
    device); ``transform_bytes`` and ``counts`` as ``iter_batches``'.
    Several processes: each computes its strided shard; the shards are
    all-gathered and merged, so every process returns the same full
    set."""
    n = len(dataset)
    mesh = make_mesh()
    my = strided_shard(n, mesh.rank, mesh.world)
    feats, labels = [], []
    for x, y, n_real in iter_batches(dataset, my, transform, batch_size,
                                     num_threads=num_threads,
                                     transform_bytes=transform_bytes,
                                     counts=counts):
        feats.append(np.asarray(fwd(x), np.float32)[:n_real])
        labels.append(y[:n_real])
    f = (np.concatenate(feats) if feats
         else np.zeros((0, 1), np.float32))
    lab = (np.concatenate(labels) if labels
           else np.zeros((0,), np.int32))
    if mesh.world > 1:
        per = -(-n // mesh.world)               # ceil: the longest shard
        f = merge_strided_shards(mesh.all_gather(pad_shard(f, per)), n)
        lab = merge_strided_shards(
            mesh.all_gather(pad_shard(lab, per, fill=-1)), n)
    return f, lab
