"""Detection (AVA-style) head: ROI-align over video features and a
classifier. Counterpart of `mspi_tpu/models/roi_head.py` (reference
SlowFast/slowfast/models/head_helper.py ResNetRoIHead): temporal average of
the feature map, per-box ROI-align, spatial max-pool, dropout, linear
classifier with a sigmoid (multi-label AVA actions).

`roi_align` has the JAX function's semantics, not torchvision's: bilinear
samples at half-pixel bin centres, `sampling_ratio` x `sampling_ratio` per
bin, each coordinate clamped into the map before its weights, and a bin
max(x1 - x0, 1e-3) / output_size wide. Channels-last. Its backward is the
gather's scatter-add, which CUDA does not order: on the card two runs of a
step agree within rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mspi_tpu_torch.models.heads import dropout


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              batch_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """features: [H, W, C], or [B, H, W, C] with batch_idx [N] (the map
    each box crops); boxes: [N, 4] (x0, y0, x1, y1) in input coordinates.
    Returns [N, output_size, output_size, C]."""
    if features.dim() == 3:
        features = features[None]
        batch_idx = torch.zeros(boxes.shape[0], dtype=torch.long, device=boxes.device)
    _, H, W, _ = features.shape
    n, s = boxes.shape[0], sampling_ratio
    b = boxes * spatial_scale
    x0, y0, x1, y1 = b.unbind(-1)
    bw = torch.clamp_min(x1 - x0, 1e-3) / output_size
    bh = torch.clamp_min(y1 - y0, 1e-3) / output_size
    # sample offsets in bin units: bin i, sample j at i + (j + 0.5) / s
    off = (torch.arange(output_size, device=b.device, dtype=b.dtype)[:, None]
           + (torch.arange(s, device=b.device, dtype=b.dtype)[None, :] + 0.5) / s).reshape(-1)
    ys = (y0[:, None] + off * bh[:, None]).clamp(0.0, H - 1.0)  # [N, out*s]
    xs = (x0[:, None] + off * bw[:, None]).clamp(0.0, W - 1.0)
    ys0, xs0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - ys0)[:, :, None, None], (xs - xs0)[:, None, :, None]
    yi0, xi0 = ys0.long(), xs0.long()
    yi1, xi1 = torch.clamp_max(yi0 + 1, H - 1), torch.clamp_max(xi0 + 1, W - 1)
    bi = batch_idx.long()[:, None, None]

    def at(yi, xi):  # [N, out*s, out*s, C]
        return features[bi, yi[:, :, None], xi[:, None, :]]

    vals = ((1 - wy) * (1 - wx) * at(yi0, xi0) + (1 - wy) * wx * at(yi0, xi1)
            + wy * (1 - wx) * at(yi1, xi0) + wy * wx * at(yi1, xi1))
    return vals.reshape(n, output_size, s, output_size, s, -1).mean(dim=(2, 4))


class ResNetRoIHead(nn.Module):
    """Temporal-mean feature -> ROI-align -> spatial max -> dropout ->
    linear -> sigmoid (head_helper.py ResNetRoIHead, single pathway).
    Dropout (keep 1 - rate) only in training and only where the caller
    gives a CPU `torch.Generator` for its mask, as the JAX head drops only
    where it is given an rng."""

    def __init__(self, dim_in: int, num_classes: int, pool_size: int = 7,
                 spatial_scale: float = 1.0 / 16, dropout_rate: float = 0.5):
        super().__init__()
        self.pool_size = pool_size
        self.spatial_scale = spatial_scale
        self.dropout_rate = dropout_rate
        self.projection = nn.Linear(dim_in, num_classes)

    def forward(self, features: torch.Tensor, boxes: torch.Tensor,
                box_batch_idx: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """features: [B,T,H,W,C]; boxes: [N,4] input-resolution xyxy;
        box_batch_idx: [N], the batch element each box crops."""
        fmap = features.mean(dim=1)
        aligned = roi_align(fmap, boxes, self.pool_size, self.spatial_scale,
                            batch_idx=box_batch_idx)
        x = aligned.amax(dim=(1, 2))
        x = dropout(x, self.dropout_rate, self.training, generator)
        return torch.sigmoid(self.projection(x))
