"""Kinetics-style video classification dataset: the port's own copy of
`mspi_tpu/data/kinetics.py` (host numpy, PIL and OpenCV; no JAX in either).

Reference: SlowFast/slowfast/datasets/kinetics.py:31-… with the decode /
sampling utilities of datasets/{decoder,utils}.py: CSV lists
("path<sep>label"), train = random temporal offset + jittered spatial scale
+ random crop + horizontal flip; test = NUM_ENSEMBLE_VIEWS uniform temporal
clips x NUM_SPATIAL_CROPS crops.

This image has no PyAV/ffmpeg, so the decode backend reads *frame
directories* (one JPEG per frame, the same layout the AVSP datasets use).
A clip of `num_frames` with `sampling_rate` stride is gathered with
boundary clamping, matching decoder.py's temporal_sampling.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def temporal_sampling(num_available: int, start_idx: float, end_idx: float,
                      num_samples: int) -> np.ndarray:
    """decoder.py temporal_sampling: linspace then clamp."""
    index = np.linspace(start_idx, end_idx, num_samples)
    return np.clip(index, 0, num_available - 1).astype(np.int64)


def get_start_end_idx(video_size: int, clip_size: float, clip_idx: int,
                      num_clips: int, rng: Optional[np.random.Generator] = None):
    """decoder.py get_start_end_idx: random for train (clip_idx==-1), else
    uniformly spaced test clips."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        start_idx = float((rng or np.random.default_rng()).uniform(0, delta))
    else:
        start_idx = delta * clip_idx / max(num_clips - 1, 1) if num_clips > 1 else 0.0
    return start_idx, start_idx + clip_size - 1


def spatial_resize_crop(frames: np.ndarray, min_scale: int, max_scale: int,
                        crop_size: int, spatial_idx: int,
                        rng: Optional[np.random.Generator] = None,
                        flip: bool = False) -> np.ndarray:
    """datasets/utils.py spatial_sampling (random_short_side_scale_jitter +
    crop + flip for train spatial_idx==-1; deterministic 3-crop for test)."""
    import cv2

    rng = rng or np.random.default_rng()
    T, H, W, C = frames.shape
    if spatial_idx == -1:
        size = int(round(float(rng.uniform(min_scale, max_scale))))
    else:
        size = min_scale
    if H <= W:
        new_h, new_w = size, int(round(W * size / H))
    else:
        new_h, new_w = int(round(H * size / W)), size
    frames = np.stack([cv2.resize(f, (new_w, new_h)) for f in frames])

    if spatial_idx == -1:
        y = int(rng.integers(0, max(new_h - crop_size, 0) + 1))
        x = int(rng.integers(0, max(new_w - crop_size, 0) + 1))
    else:
        # 0/1/2 = left/center/right (or top/center/bottom)
        if new_h > new_w:
            y = [0, (new_h - crop_size) // 2, new_h - crop_size][spatial_idx]
            x = (new_w - crop_size) // 2
        else:
            y = (new_h - crop_size) // 2
            x = [0, (new_w - crop_size) // 2, new_w - crop_size][spatial_idx]
    frames = frames[:, y:y + crop_size, x:x + crop_size]
    if flip and spatial_idx == -1 and rng.random() < 0.5:
        frames = frames[:, :, ::-1]
    return frames


@dataclass
class KineticsSample:
    clip: np.ndarray  # [T, crop, crop, 3] uint8
    label: int
    index: int  # clip index for TestMeter ensembling


class KineticsFrames:
    """Map-style dataset over 'frame_dir<sep>label' CSV lists."""

    def __init__(self, data_dir: str, split: str = "train", num_frames: int = 16,
                 sampling_rate: int = 4, crop_size: int = 224,
                 jitter_scales: Tuple[int, int] = (256, 320),
                 num_ensemble_views: int = 10, num_spatial_crops: int = 3,
                 path_label_separator: str = " ", seed: int = 0):
        self.split = split
        self.num_frames = num_frames
        self.sampling_rate = sampling_rate
        self.crop_size = crop_size
        self.jitter_scales = jitter_scales
        self.rng = np.random.default_rng(seed)
        self._clips_per_video = (1 if split in ("train", "val")
                                 else num_ensemble_views * num_spatial_crops)
        self.num_ensemble_views = num_ensemble_views
        self.num_spatial_crops = num_spatial_crops

        list_file = os.path.join(data_dir, f"{split if split != 'val' else 'val'}.csv")
        self.items: List[Tuple[str, int]] = []
        with open(list_file) as f:
            for line in f.read().splitlines():
                if not line:
                    continue
                path, label = line.rsplit(path_label_separator, 1)
                self.items.append((path, int(label)))

    def __len__(self):
        return len(self.items) * self._clips_per_video

    def _load_frames(self, frame_dir: str, indices: np.ndarray) -> np.ndarray:
        from PIL import Image

        files = sorted(os.listdir(frame_dir))
        out = []
        for i in indices:
            img = Image.open(os.path.join(frame_dir, files[int(i)])).convert("RGB")
            out.append(np.asarray(img, dtype=np.uint8))
        return np.stack(out)

    def __getitem__(self, idx: int) -> KineticsSample:
        video_idx = idx // self._clips_per_video
        clip_in_video = idx % self._clips_per_video
        path, label = self.items[video_idx]
        n = len(os.listdir(path))
        clip_len = self.num_frames * self.sampling_rate

        if self.split == "train":
            temporal_idx, spatial_idx = -1, -1
        elif self.split == "val":
            temporal_idx, spatial_idx = 0, 1
        else:
            temporal_idx = clip_in_video // self.num_spatial_crops
            spatial_idx = clip_in_video % self.num_spatial_crops

        start, end = get_start_end_idx(
            n, clip_len, temporal_idx if self.split == "test" else temporal_idx,
            self.num_ensemble_views, rng=self.rng)
        indices = temporal_sampling(n, start, end, self.num_frames)
        frames = self._load_frames(path, indices)
        min_s, max_s = self.jitter_scales
        if self.split != "train":
            min_s = max_s = min_s if self.split == "test" else min_s
        frames = spatial_resize_crop(frames, min_s, max_s, self.crop_size,
                                     spatial_idx, rng=self.rng, flip=True)
        return KineticsSample(clip=np.ascontiguousarray(frames), label=label, index=idx)
