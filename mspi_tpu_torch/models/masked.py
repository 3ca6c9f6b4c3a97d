"""Masked video pretraining (MaskFeat-style) on the MViT trunk.

Counterpart of `mspi_tpu/models/masked.py` (reference
SlowFast/slowfast/models/masked.py, MaskMViT): a fraction of the space-time
patches is replaced by a learnable mask token in input space, the trunk's
last features are upsampled to the patch grid, and a linear head regresses a
target at the masked patches, HOG features or normalised pixels.

The HOG target follows the TPU code's conventions (reference HOGLayerC,
SlowFast/operators.py:66-122): reflect padding, Sobel as cross-correlation,
the orientation atan2(gx, gy) / pi * nbins (gx first), its floor taken
modulo nbins (negative phases wrap), magnitude votes summed over each cell,
and per-cell L2 normalisation with eps 1e-12. It computes in fp32 with
autocast off, so that a bf16 step regresses the same target.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.models.mvit import MViTFeatures
from mspi_tpu_torch.ops.layers import resize_to, trunc_normal_


def random_patch_mask(generator: torch.Generator, batch: int, grid: Tuple[int, int, int],
                      mask_ratio: float = 0.4) -> torch.Tensor:
    """[B, t, h, w] boolean mask with ~mask_ratio True entries, drawn from
    `generator` on its device."""
    t, h, w = grid
    n = t * h * w
    scores = torch.rand((batch, n), generator=generator, device=generator.device)
    k = int(n * mask_ratio)
    thresh = torch.sort(scores, dim=1).values[:, k][:, None]
    return (scores < thresh).reshape(batch, t, h, w)


def hog_per_frame(frames: torch.Tensor, nbins: int = 9, cell: int = 8) -> torch.Tensor:
    """HOG descriptor per frame: [B, H, W, 3] -> [B, H/cell, W/cell, 3,
    nbins] (channels-last), in fp32."""
    with torch.autocast(frames.device.type, enabled=False):
        x = frames.float()
        B, H, W, C = x.shape
        x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        wx = torch.tensor([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype=torch.float32,
                          device=x.device)
        # out channel 2c + i = (gx, gy)[i] of channel c
        kern = torch.stack([wx, wx.T]).repeat(C, 1, 1)[:, None]
        g = F.conv2d(x, kern, groups=C).reshape(B, C, 2, H, W)
        gx, gy = g[:, :, 0], g[:, :, 1]  # [B, C, H, W]
        norm = torch.sqrt(gx * gx + gy * gy)
        phase = torch.atan2(gx, gy) / torch.pi * nbins
        bins = torch.remainder(torch.floor(phase).to(torch.int64), nbins)
        votes = F.one_hot(bins, nbins).to(norm.dtype) * norm[..., None]  # [B,C,H,W,nb]
        votes = votes.reshape(B, C, H // cell, cell, W // cell, cell, nbins)
        hist = votes.sum(dim=(3, 5)).permute(0, 2, 3, 1, 4)  # [B, h, w, C, nbins]
        denom = torch.linalg.vector_norm(hist, dim=-1, keepdim=True).clamp_min(1e-12)
        return hist / denom


def hog_targets(clips: torch.Tensor, temporal_stride: int = 2, spatial_stride: int = 16,
                nbins: int = 9, cell: int = 8) -> torch.Tensor:
    """Per-token HOG labels at the (temporal_stride, spatial_stride) token
    grid (the reference's _get_hog_label_3d, masked.py:267-291): per-frame
    HOG at the patch temporal sampling, then the u*u cells under each token
    concatenated channel-major (index (c*nbins + bin)*u*u + i*u + j).

    [B,T,H,W,3] -> [B, T/ts, H/ss, W/ss, 3*nbins*(ss/cell)**2]."""
    B, T, H, W, C = clips.shape
    frames = clips[:, ::temporal_stride].reshape(-1, H, W, C)
    hog = hog_per_frame(frames, nbins=nbins, cell=cell)
    u = spatial_stride // cell
    fh, fw = H // spatial_stride, W // spatial_stride
    hog = hog.reshape(B, T // temporal_stride, fh, u, fw, u, C * nbins)
    hog = hog.permute(0, 1, 2, 4, 6, 3, 5)  # [B, t, fh, fw, 27, u, u]
    return hog.reshape(B, T // temporal_stride, fh, fw, C * nbins * u * u)


class MaskedMViT(nn.Module):
    """Masked-prediction wrapper of `MViTFeatures`: forward(clips, mask) ->
    (prediction, target, mask). target="hog" predicts
    3*nbins*(hog_stride/hog_cell)^2 HOG features per (pt, hog_stride,
    hog_stride) token, the mask at the (T/pt, H/hog_stride, W/hog_stride)
    grid; "pixel" the pt*ph*pw*3 pixels of each patch_stride patch. The
    decoder reads the trunk's 768 channels, as the JAX module's. The mask
    token is drawn as the JAX initialiser draws it (truncated normal, std
    0.02, here from a generator seeded 0)."""

    def __init__(self, cfg: MViTConfig, patch_stride: Tuple[int, int, int] = (2, 4, 4),
                 mask_ratio: float = 0.4, target: str = "pixel", hog_stride: int = 16,
                 hog_cell: int = 8, nbins: int = 9):
        super().__init__()
        if target not in ("hog", "pixel"):
            raise ValueError(f"target {target!r} is neither 'hog' nor 'pixel'")
        self.patch_stride, self.mask_ratio, self.target = tuple(patch_stride), mask_ratio, target
        self.hog_stride, self.hog_cell, self.nbins = hog_stride, hog_cell, nbins
        self.backbone = MViTFeatures(cfg)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, 1, 3))
        trunc_normal_(self.mask_token, 0.02, torch.Generator().manual_seed(0))
        pt, ph, pw = self.patch_stride
        self.pred_norm = nn.LayerNorm(768, eps=1e-5)
        if target == "hog":
            u = hog_stride // hog_cell
            self.decoder_pred = nn.Linear(768, 3 * nbins * u * u)
        else:
            self.decoder_pred = nn.Linear(768, pt * ph * pw * 3)

    def forward(self, clips: torch.Tensor, mask: torch.Tensor):
        B, T, H, W, C = clips.shape
        pt, ph, pw = self.patch_stride
        if self.target == "hog":
            grid = (T // pt, H // self.hog_stride, W // self.hog_stride)
            reps = (pt, self.hog_stride, self.hog_stride)
        else:
            grid = (T // pt, H // ph, W // pw)
            reps = (pt, ph, pw)
        # the masked patches take the mask token in input space
        up_mask = mask
        for axis, r in enumerate(reps, start=1):
            up_mask = up_mask.repeat_interleave(r, dim=axis)
        masked_clips = torch.where(up_mask[..., None], self.mask_token.to(clips.dtype), clips)

        x = self.backbone(masked_clips)[-1]  # [B, T/2, H/32, W/32, 768]
        x = resize_to(x, grid, (1, 2, 3))
        pred = self.decoder_pred(self.pred_norm(x))

        if self.target == "hog":
            target = hog_targets(clips, pt, self.hog_stride, nbins=self.nbins,
                                 cell=self.hog_cell)
        else:
            target = clips.reshape(B, grid[0], pt, grid[1], ph, grid[2], pw, C)
            target = target.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, *grid, pt * ph * pw * C)
        return pred, target, mask


def masked_prediction_loss(pred, target, mask, normalize_target: bool = True):
    """MSE on the masked patches only, in fp32. Pixel targets are per-patch
    normalised (MASK.NORM_PRED_PIXEL); HOG targets are already cell-normalised
    and take plain MSE (normalize_target=False)."""
    pred, target, mask = pred.float(), target.float(), mask.float()
    if normalize_target:
        mu = target.mean(dim=-1, keepdim=True)
        sd = target.std(dim=-1, keepdim=True, unbiased=False) + 1e-6
        target = (target - mu) / sd
    err = torch.mean((pred - target) ** 2, dim=-1)
    return torch.sum(err * mask) / torch.sum(mask).clamp_min(1.0)
