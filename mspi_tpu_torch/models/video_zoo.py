"""The video-classification model zoo: counterpart of
`mspi_tpu/models/video_zoo.py` (reference SlowFast
video_model_builder.py:173-810 and ptv_model_builder.py).

Each classifier is one of the port's feature trunks plus a head
(`models/heads.py`), channels-last, on normalised clips [B,T,H,W,3]; in
training it returns logits, in eval mode the class softmax. `forward`'s
`generator` draws the heads' dropout masks (none: no dropout); the trunks'
drop-path layers take the trainer's generator (`train/classification.py`).
The trunks run the port's kernels as the saliency models do: MViTv2-S K1
and K2 (rows 5 and 9 in training), UniFormer-B K4 and K2, VideoSwin-S rows
15-17 and K2; the ResNets, SlowFast and X3D are plain PyTorch, as the JAX
package runs them outside Pallas.

Module names are the JAX classifiers' (backbone, head, norm; s1..s5 and
their pathway blocks), so `state_dict_from_jax` moves every variable across.
`build_classifier` takes the JAX package's 12 names.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.config import (MViTConfig, SlowFastConfig, UniFormerConfig,
                                   VideoSwinConfig, X3DConfig)
from mspi_tpu_torch.models.heads import ResNetBasicHead, TransformerBasicHead, X3DHead
from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d, max_pool

CLASSIFIERS = ("slowfast4x16", "x3dl", "mvitv2s", "uniformerb", "videoswins", "csn",
               "r2plus1d", "c2d", "i3d", "slow", "c2d_nln", "i3d_nln", "slow_nln")


class SlowFastClassifier(nn.Module):
    """SlowFast 4x16 R50 (video_model_builder.py:173-445): the head takes
    the last pyramid level, the slow pathway's res5 (w * 32 channels; the
    JAX module declares the fused width, and flax sizes its projection by
    the input it gets)."""

    def __init__(self, cfg: SlowFastConfig, num_classes: int = 400, dropout_rate: float = 0.5):
        super().__init__()
        from mspi_tpu_torch.models.slowfast import SlowFastFeatures

        self.backbone = SlowFastFeatures(cfg)
        self.head = ResNetBasicHead([cfg.width_per_group * 32], num_classes, dropout_rate)

    def forward(self, clips, generator=None):
        return self.head([self.backbone(clips)[-1]], generator)


class X3DClassifier(nn.Module):
    """X3D-L with X3DHead (video_model_builder.py:664-808). The head's inner
    width is the JAX module's, bottleneck_factor x round_width(192,
    width_factor); its input is res5's round_width(96, width_factor)
    channels (flax sizes conv_5 by the input it gets)."""

    def __init__(self, cfg: X3DConfig, num_classes: int = 400, dropout_rate: float = 0.5):
        super().__init__()
        from mspi_tpu_torch.models.resnet3d import round_width
        from mspi_tpu_torch.models.x3d import X3DFeatures

        self.backbone = X3DFeatures(cfg)
        dim_inner = int(cfg.bottleneck_factor * round_width(96 * 2, cfg.width_factor))
        self.head = X3DHead(round_width(96, cfg.width_factor), dim_inner, cfg.dim_c5,
                            num_classes, dropout_rate)

    def forward(self, clips, generator=None):
        return self.head([self.backbone(clips)[-1]], generator)


class MViTClassifier(nn.Module):
    """MViTv2-S with TransformerBasicHead over its last level's tokens."""

    def __init__(self, cfg: MViTConfig, num_classes: int = 400, dropout_rate: float = 0.5):
        super().__init__()
        from mspi_tpu_torch.models.mvit import MViTFeatures

        self.backbone = MViTFeatures(cfg)
        self.head = TransformerBasicHead(768, num_classes, dropout_rate)

    def forward(self, clips, generator=None):
        return self.head(self.backbone(clips)[-1], generator)


class UniFormerClassifier(nn.Module):
    """UniFormer-B: stages, BatchNorm, mean over the tokens, linear
    (reference backbones/uniformer.py:280-381)."""

    def __init__(self, cfg: UniFormerConfig, num_classes: int = 400,
                 dropout_rate: float = 0.5):
        super().__init__()
        from mspi_tpu_torch.models.uniformer import UniFormerFeatures

        self.backbone = UniFormerFeatures(cfg)
        self.norm = BatchNorm(cfg.embed_dim[-1])
        self.head = TransformerBasicHead(cfg.embed_dim[-1], num_classes, dropout_rate)

    def forward(self, clips, generator=None):
        return self.head(self.norm(self.backbone(clips)[-1]), generator)


class VideoSwinClassifier(nn.Module):
    """Video Swin-S (the mmaction2 recipe): trunk, LayerNorm, mean over the
    tokens, dropout, linear."""

    def __init__(self, cfg: VideoSwinConfig, num_classes: int = 400,
                 dropout_rate: float = 0.5):
        super().__init__()
        from mspi_tpu_torch.models.videoswin import VideoSwinFeatures

        self.backbone = VideoSwinFeatures(cfg)
        dim = int(cfg.embed_dim * 2 ** (len(cfg.depths) - 1))
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.head = TransformerBasicHead(dim, num_classes, dropout_rate)

    def forward(self, clips, generator=None):
        return self.head(self.norm(self.backbone(clips)[-1]), generator)


# single-pathway ResNet-50s (video_model_builder.py:447-663): each stage's
# temporal kernels (_TEMPORAL_KERNEL_BASIS :41-99), the pool after res2
# (_POOL1 :100-109), and the NLN configs' non-local blocks after blocks
# (1, 3) of res3 and (1, 3, 5) of res4
RESNET_TEMP_KERNELS = {
    "c2d": ([1], [1], [1], [1], [1]),
    "i3d": ([5], [3], [3, 1], [3, 1], [1, 3]),
    "slow": ([1], [1], [1], [3], [3]),
}
RESNET_POOL1 = {"c2d": (2, 1, 1), "i3d": (2, 1, 1), "slow": (1, 1, 1)}
NLN_LOCATIONS = ((), (1, 3), (1, 3, 5), ())
RESNET_BLOCKS = (3, 4, 6, 3)


class ResNetVideoClassifier(nn.Module):
    """ResNet-50 c2d / i3d / slow, optionally with non-local blocks."""

    def __init__(self, arch: str = "slow", num_classes: int = 400, width_per_group: int = 64,
                 num_groups: int = 1, dropout_rate: float = 0.5, use_nonlocal: bool = False,
                 nonlocal_group: int = 1, nonlocal_pool=(1, 2, 2)):
        super().__init__()
        from mspi_tpu_torch.models.resnet3d import ResStage, VideoModelStem

        if arch not in RESNET_TEMP_KERNELS:
            raise ValueError(f"ResNet arch {arch!r}: expected one of {tuple(RESNET_TEMP_KERNELS)}")
        self.arch = arch
        tk, w = RESNET_TEMP_KERNELS[arch], width_per_group
        self.s1 = VideoModelStem([3], [w], [(tk[0][0], 7, 7)], [(1, 2, 2)],
                                 [(tk[0][0] // 2, 3, 3)])
        dims = [(w, w * 4), (w * 4, w * 8), (w * 8, w * 16), (w * 16, w * 32)]
        for s, ((din, dout), nb) in enumerate(zip(dims, RESNET_BLOCKS), start=2):
            self.add_module(f"s{s}", ResStage(
                [din], [dout], [1 if s == 2 else 2], [tk[s - 1]], [nb],
                [num_groups * w * 2 ** (s - 2)], [num_groups], [nb],
                nonlocal_inds=(NLN_LOCATIONS[s - 2],) if use_nonlocal else (),
                nonlocal_group=(nonlocal_group,) if use_nonlocal else (),
                nonlocal_pool=(nonlocal_pool,) if use_nonlocal else ()))
        self.head = ResNetBasicHead([w * 32], num_classes, dropout_rate)

    def features(self, clips) -> List[torch.Tensor]:
        xs = self.s2(self.s1([clips]))
        p = RESNET_POOL1[self.arch]
        if any(s > 1 for s in p):
            xs = [max_pool(x, p, p, 0) for x in xs]
        feas = [xs[0]]
        for s in (self.s3, self.s4, self.s5):
            xs = s(xs)
            feas.append(xs[0])
        return feas

    def forward(self, clips, generator=None):
        return self.head([self.features(clips)[-1]], generator)


class ConvStem(nn.Module):
    """conv-BN-ReLU without a pool (pytorchvideo's stems of CSN (3,7,7) and
    R(2+1)D (1,7,7))."""

    def __init__(self, dim_out: int, kernel, stride=(1, 2, 2)):
        super().__init__()
        self.conv = Conv3d(3, dim_out, tuple(kernel), tuple(stride),
                           tuple(k // 2 for k in kernel), bias=False)
        self.bn = BatchNorm(dim_out)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class PTVStyleResNet(nn.Module):
    """Single-pathway ResNet-50 with a transform by name (the reference's
    pytorchvideo adapters: PTVCSN, PTVR2plus1D); T halves by a (2,1,1)
    average pool before each stage in temporal_pool_stages."""

    def __init__(self, trans_func: str, stem_kernel, num_classes: int = 400,
                 temp_kernel: int = 3, temporal_pool_stages=(), dropout_rate: float = 0.5):
        super().__init__()
        from mspi_tpu_torch.models.resnet3d import ResStage

        w = 64
        self.temporal_pool_stages = tuple(temporal_pool_stages)
        self.s1 = ConvStem(w, stem_kernel)
        dims = [(w, w * 4), (w * 4, w * 8), (w * 8, w * 16), (w * 16, w * 32)]
        for s, ((din, dout), nb) in enumerate(zip(dims, RESNET_BLOCKS), start=2):
            self.add_module(f"s{s}", ResStage(
                [din], [dout], [1 if s == 2 else 2], [[temp_kernel]], [nb], [w * 2 ** (s - 2)],
                [1], [nb], trans_func_name=trans_func))
        self.head = ResNetBasicHead([w * 32], num_classes, dropout_rate)

    def forward(self, clips, generator=None):
        xs = [self.s1(clips)]
        for s in (2, 3, 4, 5):
            if s in self.temporal_pool_stages and xs[0].shape[1] > 1:
                x = xs[0].permute(0, 4, 1, 2, 3)
                xs = [F.avg_pool3d(x, (2, 1, 1), (2, 1, 1)).permute(0, 2, 3, 4, 1)]
            xs = getattr(self, f"s{s}")(xs)
        return self.head(xs, generator)


def build_classifier(name: str, num_classes: int = 400) -> nn.Module:
    """The classifier of a zoo name (the JAX package's `build_classifier`)."""
    if name == "slowfast4x16":
        return SlowFastClassifier(SlowFastConfig(), num_classes)
    if name == "x3dl":
        return X3DClassifier(X3DConfig(), num_classes)
    if name == "mvitv2s":
        return MViTClassifier(MViTConfig(), num_classes)
    if name == "uniformerb":
        return UniFormerClassifier(UniFormerConfig(), num_classes)
    if name == "videoswins":
        return VideoSwinClassifier(VideoSwinConfig(), num_classes)
    if name == "csn":
        return PTVStyleResNet("csn_transform", (3, 7, 7), num_classes)
    if name == "r2plus1d":
        return PTVStyleResNet("r2plus1d_transform", (1, 7, 7), num_classes,
                              temporal_pool_stages=(4, 5))
    if name in ("c2d", "i3d", "slow"):
        return ResNetVideoClassifier(name, num_classes)
    if name.endswith("_nln") and name[:-4] in ("c2d", "i3d", "slow"):
        return ResNetVideoClassifier(name[:-4], num_classes, use_nonlocal=True)
    raise ValueError(f"unknown classifier {name!r} (have {CLASSIFIERS})")
