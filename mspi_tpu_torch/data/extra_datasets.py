"""Additional classification datasets: Something-Something v2, Charades,
ImageNet. Counterpart of `mspi_tpu/data/extra_datasets.py`, the same
numpy/PIL code on the port's `data/kinetics.py::spatial_resize_crop`
(reference SlowFast/slowfast/datasets/{ssv2.py, charades.py,
imagenet.py}). All use the frame-directory decode backend:

- SSv2: TSN-style segment sampling - the clip is num_frames uniform segments
  with a random (train) or centre (test) frame per segment (ssv2.py
  temporal sampling), labels from a name->id JSON + per-video label JSON.
- Charades: multi-label (157 classes) over frame dirs; clip-level targets
  are the union of actions overlapping the sampled window.
- ImageNet: folder-per-class image dataset with the standard train crop /
  test centre-crop pipeline.

The random draws come from `np.random.default_rng(seed)` in the JAX
package's order, so the two give the same samples.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mspi_tpu_torch.data.kinetics import spatial_resize_crop


@dataclass
class ClipSample:
    clip: np.ndarray
    label: np.ndarray  # int or multi-hot
    index: int


def segment_indices(num_available: int, num_frames: int, train: bool,
                    rng: np.random.Generator) -> np.ndarray:
    """TSN/SSv2 segment sampling: one frame per uniform segment."""
    seg = np.linspace(0, num_available, num_frames + 1)
    lo = np.floor(seg[:-1]).astype(int)
    hi = np.maximum(np.ceil(seg[1:]).astype(int) - 1, lo)
    if train:
        return np.array([int(rng.integers(a, b + 1)) for a, b in zip(lo, hi)])
    return (lo + hi) // 2


class SSv2Frames:
    """Something-Something v2 over frame dirs.

    data_dir/
      labels.json                 {"pushing something": 0, ...}
      {split}.json                [{"id": ..., "template"/"label": ...}, ...]
      frames/{id}/000001.jpg ...
    """

    def __init__(self, data_dir: str, split: str = "train", num_frames: int = 16,
                 crop_size: int = 224, jitter_scales: Tuple[int, int] = (256, 320),
                 seed: int = 0):
        self.data_dir = data_dir
        self.split = split
        self.num_frames = num_frames
        self.crop_size = crop_size
        self.jitter_scales = jitter_scales
        self.rng = np.random.default_rng(seed)
        with open(os.path.join(data_dir, "labels.json")) as f:
            self.label_map = json.load(f)
        with open(os.path.join(data_dir, f"{split}.json")) as f:
            items = json.load(f)
        self.items = []
        for it in items:
            name = it.get("template", it.get("label", "")).replace("[", "").replace("]", "")
            self.items.append((str(it["id"]), int(self.label_map[name])))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> ClipSample:
        from PIL import Image

        vid, label = self.items[idx]
        frame_dir = os.path.join(self.data_dir, "frames", vid)
        files = sorted(os.listdir(frame_dir))
        indices = segment_indices(len(files), self.num_frames,
                                  self.split == "train", self.rng)
        frames = np.stack([
            np.asarray(Image.open(os.path.join(frame_dir, files[i])).convert("RGB"),
                       dtype=np.uint8) for i in indices])
        spatial_idx = -1 if self.split == "train" else 1
        min_s, max_s = self.jitter_scales
        if self.split != "train":
            min_s = max_s = min_s
        frames = spatial_resize_crop(frames, min_s, max_s, self.crop_size,
                                     spatial_idx, rng=self.rng,
                                     flip=False)  # ssv2: no flip (labels are chiral)
        return ClipSample(np.ascontiguousarray(frames), np.int64(label), idx)


class CharadesFrames:
    """Charades multi-label dataset over frame dirs.

    data_dir/
      {split}.csv    lines: "video_id,fps,action_triplets" where triplets are
                     "cA start end;cB start end" (class ids like 'c083')
      frames/{video_id}/*.jpg
    """

    NUM_CLASSES = 157

    def __init__(self, data_dir: str, split: str = "train", num_frames: int = 16,
                 sampling_rate: int = 4, crop_size: int = 224,
                 jitter_scales: Tuple[int, int] = (256, 320), seed: int = 0):
        self.data_dir = data_dir
        self.split = split
        self.num_frames = num_frames
        self.sampling_rate = sampling_rate
        self.crop_size = crop_size
        self.jitter_scales = jitter_scales
        self.rng = np.random.default_rng(seed)
        self.items: List[Tuple[str, float, List[Tuple[int, float, float]]]] = []
        with open(os.path.join(data_dir, f"{split}.csv")) as f:
            for line in f.read().splitlines():
                if not line:
                    continue
                vid, fps, actions = line.split(",", 2)
                acts = []
                for trip in actions.split(";"):
                    if not trip.strip():
                        continue
                    cls, start, end = trip.split()
                    acts.append((int(cls.lstrip("c")), float(start), float(end)))
                self.items.append((vid, float(fps), acts))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> ClipSample:
        from PIL import Image

        vid, fps, acts = self.items[idx]
        frame_dir = os.path.join(self.data_dir, "frames", vid)
        files = sorted(os.listdir(frame_dir))
        n = len(files)
        clip_len = self.num_frames * self.sampling_rate
        if self.split == "train":
            start = int(self.rng.integers(0, max(n - clip_len, 0) + 1))
        else:
            start = max((n - clip_len) // 2, 0)
        indices = np.clip(start + np.arange(self.num_frames) * self.sampling_rate,
                          0, n - 1)
        frames = np.stack([
            np.asarray(Image.open(os.path.join(frame_dir, files[i])).convert("RGB"),
                       dtype=np.uint8) for i in indices])
        # multi-hot label: actions overlapping the sampled window
        t0, t1 = start / fps, (start + clip_len) / fps
        label = np.zeros(self.NUM_CLASSES, np.float32)
        for cls, s, e in acts:
            if s < t1 and e > t0:
                label[cls] = 1.0
        spatial_idx = -1 if self.split == "train" else 1
        min_s, max_s = self.jitter_scales
        if self.split != "train":
            min_s = max_s = min_s
        frames = spatial_resize_crop(frames, min_s, max_s, self.crop_size,
                                     spatial_idx, rng=self.rng, flip=True)
        return ClipSample(np.ascontiguousarray(frames), label, idx)


class ImageNetFolder:
    """Folder-per-class image dataset (imagenet.py capability)."""

    def __init__(self, data_dir: str, split: str = "train", crop_size: int = 224,
                 jitter_scales: Tuple[int, int] = (256, 320), seed: int = 0):
        self.split = split
        self.crop_size = crop_size
        self.jitter_scales = jitter_scales
        self.rng = np.random.default_rng(seed)
        root = os.path.join(data_dir, split)
        classes = sorted(os.listdir(root))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.items = []
        for c in classes:
            for f in sorted(os.listdir(os.path.join(root, c))):
                self.items.append((os.path.join(root, c, f), self.class_to_idx[c]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> ClipSample:
        from PIL import Image

        path, label = self.items[idx]
        img = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)[None]
        spatial_idx = -1 if self.split == "train" else 1
        min_s, max_s = self.jitter_scales
        if self.split != "train":
            min_s = max_s = min_s
        img = spatial_resize_crop(img, min_s, max_s, self.crop_size, spatial_idx,
                                  rng=self.rng, flip=True)
        return ClipSample(np.ascontiguousarray(img[0]), np.int64(label), idx)
