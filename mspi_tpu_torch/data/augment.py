"""Batch augmentations of the classification trainer: counterpart of
`mspi_tpu/data/augment.py` (reference SlowFast datasets/mixup.py and
random_erasing.py).

On tensors, on whatever device the batch is. Each transform takes its
random draw as arguments (MixUp's lambda, CutMix's lambda and box centre,
random erasing's per-sample boxes and noise), and a `draw_*` function makes
that draw from a CPU `torch.Generator`; so a test can hand both packages
the same draw. As in the JAX package, MixUp and CutMix pair each clip with
the reversed batch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0,
                   lam: float = 1.0, labels2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed one-hot targets, lam of labels and 1 - lam of
    labels2 where given."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = F.one_hot(labels.long(), num_classes).float() * (on - off) + off
    if labels2 is None:
        return y1
    y2 = F.one_hot(labels2.long(), num_classes).float() * (on - off) + off
    return lam * y1 + (1.0 - lam) * y2


def draw_beta(generator: torch.Generator, alpha: float) -> float:
    """lambda ~ Beta(alpha, alpha), from a seed drawn off `generator`."""
    seed = int(torch.randint(2 ** 62, (), generator=generator))
    return float(np.random.default_rng(seed).beta(alpha, alpha))


def mixup_batch(clips: torch.Tensor, labels: torch.Tensor, num_classes: int, lam: float,
                smoothing: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """MixUp: lam * clips + (1 - lam) * the reversed batch."""
    mixed = lam * clips + (1.0 - lam) * clips.flip(0)
    return mixed, one_hot_smooth(labels, num_classes, smoothing, lam, labels.flip(0))


def draw_cutmix(generator: torch.Generator, alpha: float, H: int, W: int
                ) -> Tuple[float, int, int]:
    """(lambda ~ Beta(alpha, alpha), box centre row, column)."""
    lam = draw_beta(generator, alpha)
    cy = int(torch.randint(H, (), generator=generator))
    cx = int(torch.randint(W, (), generator=generator))
    return lam, cy, cx


def cutmix_batch(clips: torch.Tensor, labels: torch.Tensor, num_classes: int, lam: float,
                 cy: int, cx: int, smoothing: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """CutMix: a box of side sqrt(1 - lam) of each spatial side around (cy,
    cx), clipped to the frame, from the reversed batch; the targets weighted
    by the box's true area."""
    B, T, H, W, C = clips.shape
    cut = np.sqrt(np.float32(1.0) - np.float32(lam))  # fp32, as the JAX transform
    cut_h, cut_w = int(np.float32(H) * cut), int(np.float32(W) * cut)
    y0, y1 = min(max(cy - cut_h // 2, 0), H), min(max(cy + cut_h // 2, 0), H)
    x0, x1 = min(max(cx - cut_w // 2, 0), W), min(max(cx + cut_w // 2, 0), W)
    mixed = clips.clone()
    mixed[:, :, y0:y1, x0:x1] = clips.flip(0)[:, :, y0:y1, x0:x1]
    lam_adj = 1.0 - ((y1 - y0) * (x1 - x0)) / (H * W)
    return mixed, one_hot_smooth(labels, num_classes, smoothing, lam_adj, labels.flip(0))


def erasing_box(H: int, W: int, area: float, log_ratio: float) -> Tuple[int, int]:
    """The erased box's (h, w) for an area and a log aspect ratio, in
    [1, H - 1] x [1, W - 1] (fp32, as the JAX transform)."""
    area, ratio = np.float32(area), np.exp(np.float32(log_ratio))
    h = min(max(int(np.sqrt(area * ratio)), 1), H - 1)
    w = min(max(int(np.sqrt(area / ratio)), 1), W - 1)
    return h, w


def draw_erasing(generator: torch.Generator, clips: torch.Tensor, prob: float = 0.25,
                 min_area: float = 0.02, max_area: float = 1 / 3,
                 min_aspect: float = 0.3) -> Dict[str, object]:
    """Per-sample draws for `random_erasing`: whether to erase, the box
    (area uniform in [min_area, max_area] of the frame, log aspect uniform
    in [log min_aspect, -log min_aspect], position uniform) and the noise."""
    B, T, H, W, C = clips.shape
    u = torch.rand((B, 3), generator=generator, dtype=torch.float64).tolist()
    draws = {"apply": [], "area": [], "log_ratio": [], "y": [], "x": []}
    for b in range(B):
        area = H * W * (min_area + (max_area - min_area) * u[b][1])
        lo, hi = math.log(min_aspect), math.log(1 / min_aspect)
        log_ratio = lo + (hi - lo) * u[b][2]
        h, w = erasing_box(H, W, area, log_ratio)
        draws["apply"].append(u[b][0] < prob)
        draws["area"].append(area)
        draws["log_ratio"].append(log_ratio)
        draws["y"].append(int(torch.randint(H - h, (), generator=generator)))
        draws["x"].append(int(torch.randint(W - w, (), generator=generator)))
    draws["noise"] = torch.randn(clips.shape, generator=generator).to(clips.device, clips.dtype)
    return draws


def random_erasing(clips: torch.Tensor, draws: Dict[str, object]) -> torch.Tensor:
    """Random erasing in 'pixel' mode: each sample whose draw says so gets
    its box, in every frame, replaced by the drawn Gaussian noise."""
    B, T, H, W, C = clips.shape
    out = clips.clone()
    for b in range(B):
        if not draws["apply"][b]:
            continue
        h, w = erasing_box(H, W, draws["area"][b], draws["log_ratio"][b])
        y, x = draws["y"][b], draws["x"][b]
        out[b, :, y:y + h, x:x + w] = draws["noise"][b, :, y:y + h, x:x + w]
    return out
