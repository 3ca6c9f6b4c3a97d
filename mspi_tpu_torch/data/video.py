"""Frame, ground-truth and fixation loading on the host: counterpart of
`mspi_tpu/data/video.py` (reference avsp_dataloader.py:16-31, 83-193).

Frames are decoded and resized to uint8 on the host; the ImageNet
normalisation runs on the device (`mspi_tpu_torch.ops.layers.
normalize_frames`); `normalize_frames` here is the host version of the
same affine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_frame(path: str, size: Tuple[int, int], native: bool = False) -> np.ndarray:
    """JPEG -> [H, W, 3] uint8 resized to `size` (h, w) with PIL bilinear
    (antialiased, as torchvision Resize). native=True decodes and resizes
    with the C++ loader (`mspi_tpu_torch.data.native`, the JAX package's
    MSPI_NATIVE_LOADER=1), which raises on a file it cannot decode."""
    if native:
        from mspi_tpu_torch.data.native import load_frame_native

        return load_frame_native(path, size)
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB").resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def normalize_frames(frames: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] uint8 -> float32 ImageNet-normalised (host path)."""
    x = frames.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def load_gt_map(path: str, size: Tuple[int, int]) -> np.ndarray:
    """eyeMap JPEG -> grayscale float32 [h, w] in [0, 1]: cv2 bilinear
    resize, /255 when above 1."""
    import cv2
    from PIL import Image

    with Image.open(path) as img:
        gt = np.array(img.convert("L")).astype(np.float64)
    gt = cv2.resize(gt, (size[1], size[0]))
    if gt.max() > 1.0:
        gt = gt / 255.0
    return gt.astype(np.float32)


def resize_fixation(image: np.ndarray, row: int, col: int) -> np.ndarray:
    """Coordinate remap of a binary fixation map to (row, col)."""
    resized = np.zeros((row, col), dtype=np.float32)
    coords = np.argwhere(image)
    if len(coords):
        rr = np.minimum(np.round(coords[:, 0] * (row / image.shape[0])).astype(int), row - 1)
        cc = np.minimum(np.round(coords[:, 1] * (col / image.shape[1])).astype(int), col - 1)
        resized[rr, cc] = 1.0
    return resized


def load_fixation(path: str, row: int = 224, col: int = 384) -> np.ndarray:
    """fixMap_%05d.mat ['eyeMap'] -> remapped binary map."""
    import scipy.io

    return resize_fixation(np.array(scipy.io.loadmat(path)["eyeMap"]), row=row, col=col)
