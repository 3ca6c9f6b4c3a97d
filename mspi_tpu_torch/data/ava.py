"""AVA spatio-temporal action detection dataset: counterpart of
`mspi_tpu/data/ava.py`, the same numpy/cv2 code (reference
SlowFast/slowfast/datasets/ava_dataset.py:1-436, ava_helper.py:1-237 and the
box-aware spatial transforms of datasets/cv2_transform.py).

- channels-last [T, H, W, 3] clips;
- every sample is padded to a static `max_boxes` with a validity mask, so a
  batch stacks without a detection collate;
- the random draws (scale jitter, crop, flip) come from
  `np.random.default_rng(seed)` in the same order as the JAX package's, so
  the two datasets give the same samples bit for bit.

Annotation formats are exactly the reference's:
- frame lists: "original_video_id video_id frame_id path labels" with a
  header line (ava_helper.py:40-57);
- box CSVs: "video_name,frame_sec,x1,y1,x2,y2,label[,score]" with [0,1]
  coordinates (ava_helper.py:183-236).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FPS = 30
AVA_VALID_FRAMES = range(902, 1799)  # ava_helper.py:13
IMAGENET_MEAN = np.array([0.45, 0.45, 0.45], np.float32)
IMAGENET_STD = np.array([0.225, 0.225, 0.225], np.float32)


def sec_to_frame(sec: int) -> int:
    """ava_helper.py:130-136 (second 900 = frame 0)."""
    return (sec - 900) * FPS


def load_image_lists(frame_list_dir: str, frame_dir: str,
                     list_files: Sequence[str]) -> Tuple[List[List[str]], List[str]]:
    """ava_helper.py:16-66: per-video ordered frame paths + video names."""
    image_paths: Dict[int, List[str]] = defaultdict(list)
    video_name_to_idx: Dict[str, int] = {}
    video_idx_to_name: List[str] = []
    for fname in list_files:
        with open(os.path.join(frame_list_dir, fname)) as f:
            f.readline()  # header
            for line in f:
                row = line.split()
                assert len(row) == 5, row
                video_name = row[0]
                if video_name not in video_name_to_idx:
                    video_name_to_idx[video_name] = len(video_name_to_idx)
                    video_idx_to_name.append(video_name)
                image_paths[video_name_to_idx[video_name]].append(
                    os.path.join(frame_dir, row[3]))
    return [image_paths[i] for i in range(len(image_paths))], video_idx_to_name


def parse_bboxes_file(ann_filenames: Sequence[str], ann_is_gt_box: Sequence[bool],
                      detect_thresh: float, boxes_sample_rate: int = 1):
    """ava_helper.py:183-237: {video: {sec: [[box, [labels]], ...]}}."""
    all_boxes: Dict[str, Dict[int, Dict[str, list]]] = {}
    count = 0
    unique_box_count = 0
    for filename, is_gt_box in zip(ann_filenames, ann_is_gt_box):
        with open(filename) as f:
            for line in f:
                row = line.strip().split(",")
                if not is_gt_box:
                    if float(row[7]) < detect_thresh:
                        continue
                video_name, frame_sec = row[0], int(row[1])
                if frame_sec % boxes_sample_rate != 0:
                    continue
                box_key = ",".join(row[2:6])
                box = list(map(float, row[2:6]))
                label = -1 if row[6] == "" else int(row[6])
                if video_name not in all_boxes:
                    all_boxes[video_name] = {sec: {} for sec in AVA_VALID_FRAMES}
                if box_key not in all_boxes[video_name][frame_sec]:
                    all_boxes[video_name][frame_sec][box_key] = [box, []]
                    unique_box_count += 1
                all_boxes[video_name][frame_sec][box_key][1].append(label)
                if label != -1:
                    count += 1
    out = {v: {sec: list(d.values()) for sec, d in secs.items()}
           for v, secs in all_boxes.items()}
    return out, count, unique_box_count


def get_keyframe_data(boxes_and_labels: List[Dict[int, list]]):
    """ava_helper.py:108-160: (video_idx, sec_idx, sec, frame) per keyframe."""
    keyframe_indices = []
    keyframe_boxes_and_labels = []
    for video_idx in range(len(boxes_and_labels)):
        sec_idx = 0
        keyframe_boxes_and_labels.append([])
        for sec in boxes_and_labels[video_idx].keys():
            if sec not in AVA_VALID_FRAMES:
                continue
            if len(boxes_and_labels[video_idx][sec]) > 0:
                keyframe_indices.append(
                    (video_idx, sec_idx, sec, sec_to_frame(sec)))
                keyframe_boxes_and_labels[video_idx].append(
                    boxes_and_labels[video_idx][sec])
                sec_idx += 1
    return keyframe_indices, keyframe_boxes_and_labels


def get_sequence(center_idx: int, half_len: int, sample_rate: int,
                 num_frames: int) -> List[int]:
    """datasets/utils.py get_sequence: centred strided window, clamped."""
    seq = list(range(center_idx - half_len, center_idx + half_len, sample_rate))
    return [min(max(i, 0), num_frames - 1) for i in seq]


# ---------------------------------------------------------------- transforms
# Box-aware geometry (cv2_transform.py equivalents, numpy/cv2, HWC).

def clip_boxes_to_image(boxes: np.ndarray, height: int, width: int) -> np.ndarray:
    boxes = boxes.copy()
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, width - 1)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, height - 1)
    return boxes


def _resize(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    import cv2

    return np.stack([cv2.resize(f, (new_w, new_h),
                                interpolation=cv2.INTER_LINEAR) for f in frames])


def short_side_scale(frames: np.ndarray, boxes: np.ndarray, size: int):
    """cv2_transform.py scale + scale_boxes."""
    T, H, W, C = frames.shape
    if (W <= H) == (W <= H) and min(H, W) == size:
        return frames, boxes
    if W < H:
        new_w, new_h = size, int(np.floor(H / W * size))
        ratio = size / W
    else:
        new_w, new_h = int(np.floor(W / H * size)), size
        ratio = size / H
    return _resize(frames, new_h, new_w), boxes * ratio


def random_short_side_scale_jitter(frames, boxes, min_size, max_size, rng):
    size = int(round(rng.uniform(min_size, max_size)))
    return short_side_scale(frames, boxes, size)


def random_crop_with_boxes(frames, boxes, size, rng):
    """cv2_transform.py random_crop_list."""
    T, H, W, C = frames.shape
    y = 0 if H == size else int(rng.integers(0, H - size))
    x = 0 if W == size else int(rng.integers(0, W - size))
    frames = frames[:, y:y + size, x:x + size]
    boxes = boxes - np.array([x, y, x, y], np.float32)
    return frames, clip_boxes_to_image(boxes, size, size)


def center_crop_with_boxes(frames, boxes, size):
    """cv2_transform.py spatial_shift_crop_list(spatial_idx=1)."""
    T, H, W, C = frames.shape
    y = int(np.ceil((H - size) / 2))
    x = int(np.ceil((W - size) / 2))
    frames = frames[:, y:y + size, x:x + size]
    boxes = boxes - np.array([x, y, x, y], np.float32)
    return frames, clip_boxes_to_image(boxes, size, size)


def horizontal_flip_with_boxes(frames, boxes, prob, rng):
    if rng.random() < prob:
        T, H, W, C = frames.shape
        frames = frames[:, :, ::-1]
        x1 = W - boxes[:, 2] - 1
        x2 = W - boxes[:, 0] - 1
        boxes = boxes.copy()
        boxes[:, 0], boxes[:, 2] = x1, x2
    return frames, boxes


# ------------------------------------------------------------------ dataset

class AvaDataset:
    """AVA keyframe dataset with padded static box shapes.

    __getitem__ -> dict(clips [T,H,W,3] float32 normalised,
                        boxes [max_boxes,4] crop-resolution xyxy,
                        ori_boxes [max_boxes,4] normalised-original xyxy,
                        labels [max_boxes,num_classes] multi-hot,
                        box_mask [max_boxes] bool,
                        metadata [max_boxes,2] (video_idx, sec))
    """

    def __init__(self, frame_list_dir: str, frame_dir: str, annotation_dir: str,
                 split: str = "train",
                 train_lists: Sequence[str] = ("train.csv",),
                 test_lists: Sequence[str] = ("val.csv",),
                 train_gt_box_lists: Sequence[str] = ("ava_train_v2.2.csv",),
                 train_predict_box_lists: Sequence[str] = (),
                 test_predict_box_lists: Sequence[str] = (),
                 detection_score_thresh: float = 0.9,
                 num_frames: int = 16, sampling_rate: int = 2,
                 crop_size: int = 224,
                 jitter_scales: Tuple[int, int] = (256, 320),
                 num_classes: int = 80, max_boxes: int = 16,
                 random_flip: bool = True, full_test_on_val: bool = False,
                 seed: int = 0):
        self.split = split
        self.num_frames = num_frames
        self.sampling_rate = sampling_rate
        self.seq_len = num_frames * sampling_rate
        self.crop_size = crop_size
        self.jitter_scales = jitter_scales
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

        is_train = split == "train"
        self.image_paths, self.video_idx_to_name = load_image_lists(
            frame_list_dir, frame_dir,
            train_lists if is_train else test_lists)
        gt_lists = list(train_gt_box_lists) if is_train else []
        pred_lists = list(train_predict_box_lists if is_train
                          else test_predict_box_lists)
        files = [os.path.join(annotation_dir, f) for f in gt_lists + pred_lists]
        is_gt = [True] * len(gt_lists) + [False] * len(pred_lists)
        sample_rate = 4 if (split == "val" and not full_test_on_val) else 1
        boxes_and_labels, self.num_annotations, self.num_unique_boxes = \
            parse_bboxes_file(files, is_gt, detection_score_thresh, sample_rate)
        boxes_and_labels = [boxes_and_labels[name]
                            for name in self.video_idx_to_name]
        self.keyframe_indices, self.keyframe_boxes_and_labels = \
            get_keyframe_data(boxes_and_labels)

    def __len__(self) -> int:
        return len(self.keyframe_indices)

    def _load_frames(self, video_idx: int, seq: List[int]) -> np.ndarray:
        import cv2

        frames = []
        for i in seq:
            img = cv2.imread(self.image_paths[video_idx][i])  # BGR HWC
            assert img is not None, self.image_paths[video_idx][i]
            frames.append(img[:, :, ::-1])  # RGB (DATA.BGR False default)
        return np.stack(frames).astype(np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        video_idx, sec_idx, sec, center_idx = self.keyframe_indices[idx]
        seq = get_sequence(center_idx, self.seq_len // 2, self.sampling_rate,
                           len(self.image_paths[video_idx]))
        clip_label_list = self.keyframe_boxes_and_labels[video_idx][sec_idx]
        boxes = np.array([bl[0] for bl in clip_label_list], np.float32)[:, :4]
        labels = [bl[1] for bl in clip_label_list]
        ori_boxes = boxes.copy()

        frames = self._load_frames(video_idx, seq)
        H, W = frames.shape[1:3]
        boxes[:, [0, 2]] *= W
        boxes[:, [1, 3]] *= H
        boxes = clip_boxes_to_image(boxes, H, W)

        if self.split == "train":
            frames, boxes = random_short_side_scale_jitter(
                frames, boxes, *self.jitter_scales, self.rng)
            frames, boxes = random_crop_with_boxes(
                frames, boxes, self.crop_size, self.rng)
            if self.random_flip:
                frames, boxes = horizontal_flip_with_boxes(
                    frames, boxes, 0.5, self.rng)
        else:
            frames, boxes = short_side_scale(frames, boxes, self.crop_size)
            if self.split == "val":
                frames, boxes = center_crop_with_boxes(
                    frames, boxes, self.crop_size)

        frames = frames / 255.0
        frames = (frames - IMAGENET_MEAN) / IMAGENET_STD
        boxes = clip_boxes_to_image(boxes, frames.shape[1], frames.shape[2])

        n = min(len(boxes), self.max_boxes)
        label_arr = np.zeros((self.max_boxes, self.num_classes), np.int32)
        for i, box_labels in enumerate(labels[:n]):
            for label in box_labels:
                if label == -1:
                    continue
                assert 1 <= label <= 80, label
                label_arr[i, label - 1] = 1
        pad_boxes = np.zeros((self.max_boxes, 4), np.float32)
        pad_boxes[:n] = boxes[:n]
        pad_ori = np.zeros((self.max_boxes, 4), np.float32)
        pad_ori[:n] = ori_boxes[:n]
        mask = np.zeros((self.max_boxes,), bool)
        mask[:n] = True
        metadata = np.zeros((self.max_boxes, 2), np.int32)
        metadata[:n] = [video_idx, sec]

        return {"clips": np.ascontiguousarray(frames, np.float32),
                "boxes": pad_boxes, "ori_boxes": pad_ori,
                "labels": label_arr, "box_mask": mask, "metadata": metadata}
