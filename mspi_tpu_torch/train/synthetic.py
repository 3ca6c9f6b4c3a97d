"""Synthetic structured training batches: the port's copy of
`tools/train_synthetic.py::make_batch`. A bright block drifts across the
clip, the ground-truth map is a Gaussian at its first position and the
spectrogram carries a band at the matching height, so the loss can fall."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def make_batch(rng: np.random.Generator, batch: int, num_frames: int, res: Sequence[int],
               spectro_shape: Sequence[int]) -> Dict[str, np.ndarray]:
    """clips [B,T,H,W,3] float32 in [0, 1], audio [B,F,Tw,1], gt [B,H,W]."""
    h, w = res
    clips = rng.random((batch, num_frames, h, w, 3), dtype=np.float32) * 0.1
    gt = np.zeros((batch, h, w), np.float32)
    audio = rng.standard_normal((batch, *spectro_shape, 1)).astype(np.float32) * 0.05
    for b in range(batch):
        r0 = int(rng.integers(0, h - h // 4))
        c0 = int(rng.integers(0, w - w // 4))
        dr, dc = int(rng.integers(-2, 3)), int(rng.integers(-2, 3))
        for t in range(num_frames):
            r = np.clip(r0 + dr * t, 0, h - h // 4)
            c = np.clip(c0 + dc * t, 0, w - w // 4)
            clips[b, t, r:r + h // 4, c:c + w // 4] += 0.8
        rc, cc = r0 + h // 8, c0 + w // 8
        yy, xx = np.mgrid[0:h, 0:w]
        gt[b] = np.exp(-(((yy - rc) / (h / 8)) ** 2 + ((xx - cc) / (w / 8)) ** 2))
        band = int(spectro_shape[0] * rc / h)
        audio[b, max(0, band - 4):band + 4] += 1.0
    gt += 1e-4
    return {"clips": np.clip(clips, 0, 1), "audio": audio, "gt": gt}
