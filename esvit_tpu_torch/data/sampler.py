"""Epoch samplers (port of esvit_tpu/data/sampler.py): sharded shuffling,
class-balanced, repeated-augmentation and chunk-aware order for TSV shards.

Replaces torch's DistributedSampler / the reference's DistributedChunkSampler
(datasets/samplers/distributed_chunk_sampler.py): pure numpy index math,
deterministic per (seed, epoch), the same arrays as esvit_tpu's for the
same arguments. ``process_index`` / ``process_count`` are the caller's rank
and world size.
"""

from __future__ import annotations

import numpy as np


def sharded_indices(n: int, *, epoch: int, seed: int = 0, shuffle: bool = True,
                    process_index: int = 0, process_count: int = 1,
                    drop_last: bool = True) -> np.ndarray:
    """Per-process index slice for one epoch, torch-DistributedSampler style
    (pad-to-divisible, rank-strided)."""
    rng = np.random.default_rng((seed, epoch))
    idx = rng.permutation(n) if shuffle else np.arange(n)
    if drop_last:
        per = n // process_count
        idx = idx[: per * process_count]
    else:
        pad = (-len(idx)) % process_count
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
    return idx[process_index::process_count]


def class_aware_indices(labels, *, epoch: int, seed: int = 0,
                        samples_per_class: int | None = None,
                        process_index: int = 0, process_count: int = 1
                        ) -> np.ndarray:
    """Class-balanced sampling: cycle classes, drawing one sample per class
    per round (ref: datasets/samplers/class_aware_sampler.py:34-200 —
    per-class cycling iterators; here one epoch's worth is materialized).

    samples_per_class: cap per class per epoch (target-size variant);
    default = ceil(mean class size).
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng((seed, epoch))
    classes = np.unique(labels)
    if samples_per_class is None:
        samples_per_class = int(np.ceil(len(labels) / len(classes)))
    cols = []
    for c in classes:
        idx = np.flatnonzero(labels == c)
        # cycle with reshuffling to reach samples_per_class
        reps = []
        while sum(len(r) for r in reps) < samples_per_class:
            reps.append(rng.permutation(idx))
        cols.append(np.concatenate(reps)[:samples_per_class])
    # interleave classes in shuffled order each round
    grid = np.stack(cols, axis=0)                      # (C, per)
    order = np.stack([rng.permutation(len(classes))
                      for _ in range(samples_per_class)], axis=1)
    out = grid[order, np.arange(samples_per_class)[None, :]].T.reshape(-1)
    return out[process_index::process_count]


def repeated_aug_indices(n: int, *, epoch: int, seed: int = 0,
                         num_repeats: int = 3, process_index: int = 0,
                         process_count: int = 1) -> np.ndarray:
    """Repeated-augmentation sampling (ref: datasets/samplers/ra_sampler.py:
    12-63): each selected image appears num_repeats times in the epoch
    (different augmentations downstream), ranks take interleaved slices,
    epoch truncated to n // num_repeats unique images per full pass."""
    rng = np.random.default_rng((seed, epoch))
    idx = rng.permutation(n)
    repeated = np.repeat(idx, num_repeats)
    per = (len(repeated) // process_count) * process_count
    return repeated[:per][process_index::process_count]


def chunk_aware_indices(chunk_sizes: list[int], *, epoch: int, seed: int = 0,
                        process_index: int = 0, process_count: int = 1
                        ) -> np.ndarray:
    """Shuffle at chunk granularity, then within chunks, so each process
    touches few TSV shards per epoch (the DistributedChunkSampler idea,
    distributed_chunk_sampler.py:126-209). Chunks are dealt round-robin to
    processes; alternate epochs reverse the deal order for cache reuse."""
    rng = np.random.default_rng((seed, epoch))
    starts = np.concatenate([[0], np.cumsum(chunk_sizes)[:-1]])
    order = rng.permutation(len(chunk_sizes))
    if epoch % 2 == 1:
        order = order[::-1]
    mine = order[process_index::process_count]
    out = []
    for c in mine:
        within = rng.permutation(chunk_sizes[c]) + starts[c]
        out.append(within)
    return np.concatenate(out) if out else np.zeros((0,), np.int64)
