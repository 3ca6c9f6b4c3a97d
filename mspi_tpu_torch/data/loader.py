"""Batching data loader with threaded prefetch: the port's copy of
`mspi_tpu/data/loader.py::DataLoader`.

A thread pool decodes samples ahead of the training step (JPEG decode and
the FFT release the GIL), so no worker processes are spawned. Batches are
numpy dicts; the trainer moves them to the card with pinned, non-blocking
copies (`mspi_tpu_torch.train.engine.to_device`), and uint8 clips are
normalised there. The datasets decode frames with PIL, or with the C++
loader (`mspi_tpu_torch.data.native`) when built with native=True.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator

import numpy as np


class DataLoader:
    """rows: the slice of every batch's sample indices this loader decodes
    and yields (a data-parallel rank's share, `parallel.data_rows`); the
    order and the batches are the seed's, the same on every rank."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 4, prefetch: int = 4, seed: int = 2023,
                 rows: slice = slice(None)):
        self.dataset = dataset
        self.rows = rows
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def collate(samples) -> Dict[str, np.ndarray]:
        batch = {"clips": np.stack([s.clip for s in samples]),  # [B,T,H,W,3] uint8
                 "audio": np.stack([s.audio for s in samples]),
                 "gt": np.stack([s.gt for s in samples])}
        if samples[0].fixation is not None:
            batch["fixations"] = np.stack([s.fixation for s in samples])
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n = len(self)
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []

            def submit(i):
                idxs = order[i * self.batch_size:(i + 1) * self.batch_size][self.rows]
                pending.append([pool.submit(self.dataset.__getitem__, int(j)) for j in idxs])

            for i in range(min(self.prefetch, n)):
                submit(i)
            for i in range(n):
                futures = pending.pop(0)
                if i + self.prefetch < n:
                    submit(i + self.prefetch)
                yield self.collate([f.result() for f in futures])
