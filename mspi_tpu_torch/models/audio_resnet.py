"""Audio encoder: ResNet18 with a 1-channel stem and no pool/fc head.

Counterpart of `mspi_tpu/models/audio_resnet.py` (reference
backbones/resnet.py, trained on VGGSound). A [B, 257, 111, 1] channels-last
log-spectrogram gives [B, 9, 4, 512]: the 36 audio tokens of SyncBlock.
Module names follow torchvision's ResNet (conv1, bn1, layer{1..4}.{0,1}.
{conv1,bn1,conv2,bn2,downsample.{0,1}}).
"""

from __future__ import annotations

import torch
from torch import nn

from mspi_tpu_torch.ops.layers import BatchNorm, Conv2d, max_pool


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = None
        if stride != 1 or in_features != features:
            self.downsample = nn.Sequential(
                Conv2d(in_features, features, 1, stride, bias=False),
                BatchNorm(features))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class AudioResNet18(nn.Module):
    """forward: [B, F, Tw, 1] channels-last spectrogram -> [B, 9, 4, 512]."""

    def __init__(self, layers_per_stage=(2, 2, 2, 2)):
        super().__init__()
        self.conv1 = Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        in_f = 64
        for i, (w, n) in enumerate(zip((64, 128, 256, 512), layers_per_stage)):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(in_f, w, 2 if (i > 0 and j == 0) else 1))
                in_f = w
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
