"""S3D conv units used by the fusion model's Inception and SA blocks.

Counterpart of `BasicConv3d` and `SepConv3d` in `mspi_tpu/models/s3d.py`
(reference backbones/s3d.py:41-116): bias-free conv + BatchNorm(eps 1e-3,
momentum 0.001) + ReLU on channels-last [B,T,H,W,C]. The S3D backbone itself
is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d

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
