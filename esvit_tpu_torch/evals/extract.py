"""Shared feature-extraction machinery for the evals (port of
esvit_tpu/evals/extract.py).

- **One process**: the dataset is extracted in order by this process;
  under an initialised ``torch.distributed`` group of more than one
  process, :func:`extract_dataset_features` refuses (multi-process
  extraction comes with DDP, ROADMAP queue 1 item 8).
- **Host throughput**: decode + resize run on a thread pool with a bounded
  batch lookahead, overlapping host preprocessing with the device forward
  (the reference gets this from DataLoader workers, eval_knn.py:60-78).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch


def pad_rows(x: np.ndarray, per: int, fill=0) -> np.ndarray:
    """Pad the leading dim to ``per`` rows (the last, short batch)."""
    if len(x) == per:
        return x
    pad = np.full((per - len(x),) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad])


def single_process_check():
    """Refuse a multi-process run: the port extracts in one process."""
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise NotImplementedError(
            "multi-process feature extraction is not ported yet (ROADMAP "
            "queue 1 item 8)")


def iter_batches(dataset, indices: Sequence[int],
                 transform: Callable[[object], np.ndarray],
                 batch_size: int, *, num_threads: int = 8,
                 lookahead: int = 2
                 ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Yield (images (B, ...), labels (B,), n_real) batches.

    Decodes with a thread pool and keeps ``lookahead`` batches in flight so
    host work overlaps the consumer's device work. The final batch is
    zero-padded to ``batch_size`` (n_real < batch_size marks the padding).
    """

    def load(i):
        img, label = dataset[int(i)]
        return transform(img), label

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
            pairs = [f.result() for f in futs]
            x = np.stack([p[0] for p in pairs])
            y = np.asarray([p[1] for p in pairs], np.int32)
            n = len(pairs)
            if n < batch_size:
                x = pad_rows(x, batch_size)
                y = pad_rows(y, batch_size, fill=-1)
            yield x, y, n


def extract_dataset_features(fwd: Callable[[np.ndarray], np.ndarray],
                             dataset, transform, *, batch_size: int = 64,
                             num_threads: int = 8
                             ) -> tuple[np.ndarray, np.ndarray]:
    """(features (N, C) f32, labels (N,) i32) in dataset order.

    fwd: batched image array -> feature array (the caller's forward on its
    device)."""
    single_process_check()
    feats, labels = [], []
    for x, y, n_real in iter_batches(dataset, range(len(dataset)),
                                     transform, batch_size,
                                     num_threads=num_threads):
        feats.append(np.asarray(fwd(x), np.float32)[:n_real])
        labels.append(y[:n_real])
    f = (np.concatenate(feats) if feats
         else np.zeros((0, 1), np.float32))
    lab = (np.concatenate(labels) if labels
           else np.zeros((0,), np.int32))
    return f, lab
