"""Backbone factory: counterpart of `mspi_tpu/models/registry.py`.

Each backbone maps a clip [B,16,H,W,3] to the pyramid [v1, v2, v3, v4],
channels-last at strides 4/8/16/32. MViTv2-S and VideoSwin-S are ported.
"""

from __future__ import annotations

from torch import nn

from mspi_tpu_torch.config import MSPIConfig


def build_backbone(cfg: MSPIConfig) -> nn.Module:
    name = cfg.model.motion_encoder
    if name == "mvitv2s":
        from mspi_tpu_torch.models.mvit import MViTFeatures

        return MViTFeatures(cfg.model.mvit)
    if name == "videoswins":
        from mspi_tpu_torch.models.videoswin import VideoSwinFeatures

        return VideoSwinFeatures(cfg.model.videoswin)
    raise NotImplementedError(f"motion encoder {name!r} not yet ported")
