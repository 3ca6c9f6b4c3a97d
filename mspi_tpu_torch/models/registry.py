"""Backbone factory: counterpart of `mspi_tpu/models/registry.py`.

Each backbone maps a clip [B,16,H,W,3] to the pyramid [v1, v2, v3, v4],
channels-last at strides 4/8/16/32. All seven of the JAX registry's are
ported: MViTv2-S, VideoSwin-S, UniFormer-B, S3D, X3D-L, SlowFast 4x16 R50
and MorphMLP-S. `ModelConfig.remat` reaches MViT and VideoSwin; the other
backbones ignore it, as in the JAX registry.
"""

from __future__ import annotations

from torch import nn

from mspi_tpu_torch.config import MSPIConfig


def build_backbone(cfg: MSPIConfig) -> nn.Module:
    name = cfg.model.motion_encoder
    if name == "mvitv2s":
        from mspi_tpu_torch.models.mvit import MViTFeatures

        mc = cfg.model
        return MViTFeatures(mc.mvit, mc.quant, mc.attn_relk, mc.attn_packed, mc.dwconv,
                            mc.remat)
    if name == "uniformerb":
        from mspi_tpu_torch.models.uniformer import UniFormerFeatures

        return UniFormerFeatures(cfg.model.uniformer, cfg.model.quant)
    if name == "s3d":
        from mspi_tpu_torch.models.s3d import S3DFeatures

        return S3DFeatures(pool=cfg.model.s3d.pool_stride)
    if name == "x3dl":
        from mspi_tpu_torch.models.x3d import X3DFeatures

        return X3DFeatures(cfg.model.x3d)
    if name == "slowfast4x16":
        from mspi_tpu_torch.models.slowfast import SlowFastFeatures

        return SlowFastFeatures(cfg.model.slowfast)
    if name == "morphmlps":
        from mspi_tpu_torch.models.morphmlp import MorphMLPFeatures

        return MorphMLPFeatures(cfg.model.morph)
    if name == "videoswins":
        from mspi_tpu_torch.models.videoswin import VideoSwinFeatures

        return VideoSwinFeatures(cfg.model.videoswin, cfg.model.quant, cfg.model.remat)
    raise NotImplementedError(f"motion encoder {name!r} not yet ported")
