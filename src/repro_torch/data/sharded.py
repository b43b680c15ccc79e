"""mmap token-shard dataset with per-host slicing and stateless resume.

A copy of ``repro.data.sharded`` (numpy only, so it stands as it is;
``tests/test_torch_train.py`` holds it to the reference batch for batch).

Production layout: a directory of fixed-size ``uint16``/``int32`` token
shards (``shard_00000.npy`` ...).  The dataset is *stateless-resumable*:
``batch_at(step)`` is a pure function of (step, host) so a restarted job
(possibly on a different host count -- elastic) resumes bit-exact without
persisted iterator state.  This is the fault-tolerance contract the trainer
relies on (DESIGN.md §4).
"""

from __future__ import annotations

import os

import numpy as np


class TokenShardDataset:
    def __init__(
        self,
        path: str,
        *,
        seq_len: int,
        global_batch: int,
        host_index: int = 0,
        host_count: int = 1,
        codebooks: int = 0,
    ):
        if global_batch % host_count:
            raise ValueError("global_batch must divide host_count")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = global_batch // host_count
        self.codebooks = codebooks
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".npy")
        )
        if not files:
            raise FileNotFoundError(f"no .npy token shards under {path}")
        self._arrays = [np.load(f, mmap_mode="r") for f in files]
        self._sizes = [a.shape[0] for a in self._arrays]
        self._total = sum(self._sizes)
        # +1 so labels are the shifted continuation of tokens
        self._window = seq_len + 1
        self.n_windows = self._total // self._window

    def _window_at(self, idx: int) -> np.ndarray:
        start = (idx % self.n_windows) * self._window
        out, need = [], self._window
        for arr, size in zip(self._arrays, self._sizes):
            if start >= size:
                start -= size
                continue
            take = min(need, size - start)
            out.append(np.asarray(arr[start : start + take]))
            need -= take
            start = 0
            if need == 0:
                break
        return np.concatenate(out) if len(out) > 1 else out[0]

    def batch_at(self, step: int) -> dict:
        """Pure function of (step, host): the resume contract."""
        base = step * self.global_batch + self.host_index * self.local_batch
        rows = [self._window_at(base + i) for i in range(self.local_batch)]
        block = np.stack(rows).astype(np.int32)
        batch = {"tokens": block[:, :-1], "labels": block[:, 1:]}
        if self.codebooks:
            batch = {
                k: np.repeat(v[..., None], self.codebooks, axis=-1)
                for k, v in batch.items()
            }
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def write_synthetic_shards(
    path: str, *, n_shards: int = 2, tokens_per_shard: int = 1 << 16,
    vocab: int = 32000, seed: int = 0,
) -> None:
    """Materialize a small synthetic corpus (tests / examples)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_shards):
        arr = rng.integers(0, vocab, (tokens_per_shard,), dtype=np.int32)
        np.save(os.path.join(path, f"shard_{i:05d}.npy"), arr)
