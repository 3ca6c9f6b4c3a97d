"""Asynchronous demo pipeline. Counterpart of `mspi_tpu/utils/demo.py`
(reference SlowFast/slowfast/visualization/{async_predictor.py:17-319,
demo_loader.py:17-366} and tools/demo_net.py:21-96): read -> predict ->
write over a frame directory.

One process owns the card; host threads pipeline frame reading and result
writing around the predictor, the async_predictor's producer/consumer
layout without process plumbing: a reader thread fills the task queue, the
main thread runs the predictor on batches, a writer thread drains the
results in order. Sources are frame directories (no video decoder is
assumed).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np


class FrameDirSource:
    """Sliding-window clip source over a directory of JPEG frames
    (demo_loader.py ThreadVideoManager role)."""

    def __init__(self, frame_dir: str, clip_len: int = 16,
                 size: Tuple[int, int] = (224, 384), stride: int = 1):
        from mspi_tpu_torch.data.video import load_frame

        self.files = sorted(
            (f for f in os.listdir(frame_dir) if f.endswith((".jpg", ".png"))),
        )
        self.frames = [load_frame(os.path.join(frame_dir, f), size) for f in self.files]
        self.clip_len = clip_len
        self.stride = stride

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        for start in range(0, len(self.frames) - self.clip_len + 1, self.stride):
            clip = np.stack(self.frames[start:start + self.clip_len])
            yield start + self.clip_len - 1, clip


class AsyncDemo:
    """Producer/predictor/consumer pipeline (async_predictor.py semantics):
    a reader thread fills the task queue, the main thread runs the
    predictor on batches of up to `batch_size` clips, a writer thread
    drains the results in order."""

    def __init__(self, predict_fn: Callable[[np.ndarray], np.ndarray],
                 write_fn: Callable[[int, np.ndarray], None],
                 batch_size: int = 4, queue_size: int = 16):
        self.predict_fn = predict_fn
        self.write_fn = write_fn
        self.batch_size = batch_size
        self.tasks: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.results: "queue.Queue" = queue.Queue()
        self._done = object()

    def run(self, source: Iterator[Tuple[int, np.ndarray]]):
        def reader():
            for item in source:
                self.tasks.put(item)
            self.tasks.put(self._done)

        def writer():
            while True:
                item = self.results.get()
                if item is self._done:
                    return
                idx, pred = item
                self.write_fn(idx, pred)

        rt = threading.Thread(target=reader, daemon=True)
        wt = threading.Thread(target=writer, daemon=True)
        rt.start()
        wt.start()

        pending = []
        while True:
            item = self.tasks.get()
            end = item is self._done
            if not end:
                pending.append(item)
            if pending and (end or len(pending) == self.batch_size):
                idxs = [i for i, _ in pending]
                clips = np.stack([c for _, c in pending])
                preds = np.asarray(self.predict_fn(clips))
                for i, p in zip(idxs, preds):
                    self.results.put((i, p))
                pending = []
            if end:
                break
        self.results.put(self._done)
        rt.join()
        wt.join()
