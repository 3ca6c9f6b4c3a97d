"""AVSP datasets (DIEM, Coutrot_db1/2, AVAD, ETMD_av, SumMe): the port's
own copy of `mspi_tpu/data/datasets.py` (reference avsp_dataloader.py:
83-193).

Layout:
  <root>/fold_lists/{DS}_list_{mode}[_{split}]_fps.txt   "name frame_num fps"
  <root>/video_frames/{DS}/{video}/img_%05d.jpg
  <root>/annotations/{DS}/{video}/maps/eyeMap_%05d.jpg
  <root>/annotations/{DS}/{video}/fixMap_%05d.mat
  <root>/video_audio/{DS}/{video}/{video}.wav

train: a random 16-frame window per video, redrawn until the GT map of the
last frame is non-empty. test/val: windows with stride 2*len from 0 whose
GT is non-empty. A sample is (clip uint8 [T,H,W,3], audio float32
[F,Tw,1], gt float32 [H,W]); clips stay uint8 until the device. native=True
decodes the frames with the C++ loader (`mspi_tpu_torch.data.native`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mspi_tpu_torch.data.audio import get_audio_spectrogram
from mspi_tpu_torch.data.video import load_fixation, load_frame, load_gt_map

DATASETS = ("DIEM", "Coutrot_db1", "Coutrot_db2", "AVAD", "ETMD_av", "SumMe")


def fold_list_name(dataset_name: str, mode: str, split: int) -> str:
    if dataset_name == "DIEM":
        return f"DIEM_list_{mode}_fps.txt"
    return f"{dataset_name}_list_{mode}_{split}_fps.txt"


def read_fold_list(path_data: str, dataset_name: str, mode: str, split: int):
    """Returns (sorted names, {name: fps}, {name: frame_num})."""
    names, fps, frame_num = [], {}, {}
    path = os.path.join(path_data, "fold_lists", fold_list_name(dataset_name, mode, split))
    with open(path) as f:
        for line in f.readlines():
            name, n, v = line.split(" ")
            names.append(name)
            frame_num[name] = int(n)
            fps[name] = float(v)
    names.sort()
    return names, fps, frame_num


@dataclass
class AVSPSample:
    clip: np.ndarray   # [T,H,W,3] uint8
    audio: np.ndarray  # [F,Tw,1] float32
    gt: np.ndarray     # [H,W] float32
    fixation: Optional[np.ndarray] = None


class AudioVisualDataset:
    """Map-style dataset with the reference's sampling semantics."""

    def __init__(self, data_root: str, dataset_name: str = "DIEM", split: int = 1,
                 len_clip: int = 16, mode: str = "train", use_sound: bool = True,
                 size: Tuple[int, int] = (224, 384), load_fixations: bool = False,
                 seed: int = 2023, native: bool = False):
        self.path_data = data_root
        self.dataset_name = dataset_name
        self.mode = mode
        self.len_snippet = len_clip
        self.use_sound = use_sound
        self.size = size
        self.load_fixations = load_fixations
        self.native = native
        self.rng = np.random.default_rng(seed)
        self.list_indata, self.videos_fps, _ = read_fold_list(data_root, dataset_name, mode,
                                                              split)
        self.list_num_frame: List = []
        if mode == "train":
            self.list_num_frame = [len(os.listdir(self._maps_dir(v))) for v in self.list_indata]
        else:
            for v in self.list_indata:
                frames = sorted(os.listdir(self._maps_dir(v)))
                for i in range(0, len(frames) - self.len_snippet, 2 * self.len_snippet):
                    if self._gt_nonempty(v, i + self.len_snippet):
                        self.list_num_frame.append((v, i))

    def _maps_dir(self, video: str) -> str:
        return os.path.join(self.path_data, "annotations", self.dataset_name, video, "maps")

    def _gt_path(self, video: str, idx: int) -> str:
        return os.path.join(self._maps_dir(video), "eyeMap_%05d.jpg" % idx)

    def _gt_nonempty(self, video: str, idx: int) -> bool:
        import cv2

        img = cv2.imread(self._gt_path(video, idx), 0)
        return img is not None and img.max() != 0

    def __len__(self) -> int:
        return len(self.list_num_frame)

    def __getitem__(self, idx: int) -> AVSPSample:
        if self.mode == "train":
            video = self.list_indata[idx]
            n = self.list_num_frame[idx]
            while True:
                start = int(self.rng.integers(0, n - self.len_snippet + 1))
                if self._gt_nonempty(video, start + self.len_snippet):
                    break
        else:
            video, start = self.list_num_frame[idx]
        end = start + self.len_snippet
        frames_dir = os.path.join(self.path_data, "video_frames", self.dataset_name, video)
        clip = np.stack([load_frame(os.path.join(frames_dir, "img_%05d.jpg" % (start + i + 1)),
                                    self.size, native=self.native)
                         for i in range(self.len_snippet)])
        gt = load_gt_map(self._gt_path(video, end), self.size)
        if gt.max() == 0:
            raise ValueError(f"empty ground truth at {video} frame {end}")
        fixation = None
        if self.load_fixations:
            fixation = load_fixation(
                os.path.join(self.path_data, "annotations", self.dataset_name, video,
                             "fixMap_%05d.mat" % end), row=self.size[0], col=self.size[1])
        if self.use_sound:
            wav = os.path.join(self.path_data, "video_audio", self.dataset_name, video,
                               video + ".wav")
            aud = get_audio_spectrogram(wav, start, self.videos_fps[video],
                                        len_snippet=self.len_snippet)[..., None]
        else:
            aud = np.full((257, 111, 1), 0.02, dtype=np.float32)
        return AVSPSample(clip=clip, audio=aud, gt=gt, fixation=fixation)


class ConcatDataset:
    """torch.utils.data.ConcatDataset without torch's sampler machinery."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cum[-1]) if len(self.cum) else 0

    def __getitem__(self, idx: int):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


def build_training_datasets(data_root: str, split: int, len_clip: int, use_sound: bool,
                            size: Tuple[int, int], datasets: Sequence[str] = DATASETS,
                            seed: int = 2023, native: bool = False):
    """The 6-dataset train/val mixture; a dataset whose fold list is missing
    is skipped with a message, so partial local copies still train."""
    train_sets, val_sets = [], []
    for i, name in enumerate(datasets):
        try:
            train_sets.append(AudioVisualDataset(data_root, name, split, len_clip, "train",
                                                 use_sound, size, seed=seed + i, native=native))
            val_sets.append(AudioVisualDataset(data_root, name, split, len_clip, "test",
                                               use_sound, size, seed=seed + 100 + i,
                                               native=native))
        except FileNotFoundError as e:
            print(f"[data] skipping {name}: {e}")
    return ConcatDataset(train_sets), ConcatDataset(val_sets)
