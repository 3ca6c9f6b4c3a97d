"""S3D video backbone (separable 3-D Inception), channels-last, and its conv
units, which the fusion model's Inception and SA blocks use too.

Counterpart of `mspi_tpu/models/s3d.py` (reference backbones/s3d.py,
`S3D_features_only`, kylemin/S3D as TASED-Net uses it): bias-free conv +
BatchNorm(eps 1e-3, momentum 0.001) + ReLU units, the Inception `Mixed`
blocks of Mixed_3b..Mixed_5c, and `S3DFeatures`, which emits the pyramid
[base1, base2, base3, base4] at strides 4/8/16/32 with channels (192, 480,
832, 1024) and temporal lengths (8, 8, 4, 4) for a 16-frame clip. Every
conv, pool and norm is plain PyTorch (cuDNN), as the JAX package runs them
under XLA: the backbone has no Pallas kernel. Module names are the
reference's, so `S3D_kinetics400_rm_fc.pt` loads unchanged.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d, MaxPool

BN_EPS = 1e-3
BN_MOMENTUM = 0.001


class BasicConv3d(nn.Module):
    def __init__(self, in_features, features, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = Conv3d(in_features, features, kernel_size, stride, padding, bias=False)
        self.bn = BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SepConv3d(nn.Module):
    """Spatial (1,k,k) conv+BN+ReLU, then temporal (k,1,1) conv+BN+ReLU."""

    def __init__(self, in_features, features, kernel_size, stride=1, padding=0):
        super().__init__()
        k, s, p = kernel_size, stride, padding
        self.conv_s = Conv3d(in_features, features, (1, k, k), (1, s, s), (0, p, p),
                             bias=False)
        self.bn_s = BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv_t = Conv3d(features, features, (k, 1, 1), (s, 1, 1), (p, 0, 0),
                             bias=False)
        self.bn_t = BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        x = torch.relu(self.bn_s(self.conv_s(x)))
        return torch.relu(self.bn_t(self.conv_t(x)))


class Mixed(nn.Module):
    """Inception mix block: 1x1 / 1x1 + sep3 / 1x1 + sep3 / pool + 1x1
    branches concatenated on channels (s3d.py:118-376)."""

    def __init__(self, in_features: int, b0: int, b1: Tuple[int, int], b2: Tuple[int, int],
                 b3: int):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv3d(in_features, b0, 1, 1))
        self.branch1 = nn.Sequential(BasicConv3d(in_features, b1[0], 1, 1),
                                     SepConv3d(b1[0], b1[1], 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(in_features, b2[0], 1, 1),
                                     SepConv3d(b2[0], b2[1], 3, 1, 1))
        self.branch3 = nn.Sequential(MaxPool((3, 3, 3), 1, 1),
                                     BasicConv3d(in_features, b3, 1, 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)],
                         dim=-1)


# (in, b0, (b1a, b1b), (b2a, b2b), b3) for Mixed_3b..Mixed_5c
MIXED_SPECS = {
    "3b": (192, 64, (96, 128), (16, 32), 32),     # -> 256
    "3c": (256, 128, (128, 192), (32, 96), 64),   # -> 480
    "4b": (480, 192, (96, 208), (16, 48), 64),    # -> 512
    "4c": (512, 160, (112, 224), (24, 64), 64),   # -> 512
    "4d": (512, 128, (128, 256), (24, 64), 64),   # -> 512
    "4e": (512, 112, (144, 288), (32, 64), 64),   # -> 528
    "4f": (528, 256, (160, 320), (32, 128), 128),  # -> 832
    "5b": (832, 256, (160, 320), (32, 128), 128),  # -> 832
    "5c": (832, 384, (192, 384), (48, 128), 128),  # -> 1024
}


def _mixed(name: str) -> Mixed:
    return Mixed(*MIXED_SPECS[name])


class S3DFeatures(nn.Module):
    """S3D_features_only (s3d.py:379-418): [B, 16, H, W, 3] -> [v1 [B,8,H/4,
    W/4,192], v2 [B,8,H/8,W/8,480], v3 [B,4,H/16,W/16,832], v4 [B,4,H/32,
    W/32,1024]]."""

    def __init__(self, pool: int = 1):
        super().__init__()
        self.base1 = nn.Sequential(SepConv3d(3, 64, 7, 2, 3),
                                   MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                                   BasicConv3d(64, 64, 1, 1),
                                   SepConv3d(64, 192, 3, 1, 1))
        self.maxpooling2 = MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.base2 = nn.Sequential(_mixed("3b"), _mixed("3c"))
        self.maxpooling3 = MaxPool((3, 3, 3), (2, 2, 2), (1, 1, 1))
        self.base3 = nn.Sequential(*(_mixed(n) for n in ("4b", "4c", "4d", "4e", "4f")))
        self.maxpooling4 = MaxPool((pool, 2, 2), (pool, 2, 2), 0)
        self.base4 = nn.Sequential(_mixed("5b"), _mixed("5c"))

    def forward(self, x) -> List[torch.Tensor]:
        base1 = self.base1(x)
        base2 = self.base2(self.maxpooling2(base1))
        base3 = self.base3(self.maxpooling3(base2))
        base4 = self.base4(self.maxpooling4(base3))
        return [base1, base2, base3, base4]
