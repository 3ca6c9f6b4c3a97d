"""Frame loading on the host: counterpart of `mspi_tpu/data/video.py`.

Frames are decoded and resized to uint8 on the host; the ImageNet
normalisation runs on the device (`mspi_tpu_torch.ops.layers.
normalize_frames`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_frame(path: str, size: Tuple[int, int]) -> np.ndarray:
    """JPEG -> [H, W, 3] uint8 resized to `size` (h, w) with PIL bilinear
    (antialiased, as torchvision Resize)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB").resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)
