"""Classification heads of the video classifier zoo: counterpart of
`mspi_tpu/models/heads.py` (reference SlowFast head_helper.py:21-690).

Channels-last. In training the heads return logits, with dropout (keep
1 - rate, kept values scaled by 1 / keep) where the caller gives a CPU
`torch.Generator` for its masks, as the JAX heads drop only where they are
given an rng; in eval mode they return the class softmax (`ResNetBasicHead`
and `X3DHead` average it over their pooled 1x1x1 grid, as the reference
does).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d, adaptive_avg_pool


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout on a mask drawn from `generator` (none: no
    dropout)."""
    if rate <= 0.0 or not training or generator is None:
        return x
    keep = 1.0 - rate
    mask = (torch.rand(x.shape, generator=generator) < keep).to(x.device, non_blocking=True)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ResNetBasicHead(nn.Module):
    """Pool each pathway, concatenate, project (head_helper.py:21-130)."""

    def __init__(self, dim_in: Sequence[int], num_classes: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.projection = nn.Linear(sum(dim_in), num_classes)

    def forward(self, inputs: Sequence[torch.Tensor], generator=None) -> torch.Tensor:
        x = torch.cat([adaptive_avg_pool(x, 3) for x in inputs], dim=-1)  # [B,1,1,1,C]
        x = self.projection(dropout(x, self.dropout_rate, self.training, generator))
        if not self.training:
            x = torch.softmax(x, dim=-1)
        return x.mean(dim=(1, 2, 3))


class X3DHead(nn.Module):
    """conv_5 -> BN -> ReLU -> pool -> lin_5 (-> BN) -> ReLU -> dropout ->
    projection (head_helper.py X3DHead)."""

    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, num_classes: int,
                 dropout_rate: float = 0.5, bn_lin5_on: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv_5 = Conv3d(dim_in, dim_inner, 1, bias=False)
        self.conv_5_bn = BatchNorm(dim_inner)
        self.lin_5 = Conv3d(dim_inner, dim_out, 1, bias=False)
        if bn_lin5_on:
            self.lin_5_bn = BatchNorm(dim_out)
        self.projection = nn.Linear(dim_out, num_classes)

    def forward(self, inputs: Sequence[torch.Tensor], generator=None) -> torch.Tensor:
        x = torch.relu(self.conv_5_bn(self.conv_5(inputs[0])))
        x = self.lin_5(adaptive_avg_pool(x, 3))
        if hasattr(self, "lin_5_bn"):
            x = self.lin_5_bn(x)
        x = dropout(torch.relu(x), self.dropout_rate, self.training, generator)
        x = self.projection(x)
        if not self.training:
            x = torch.softmax(x, dim=-1)
        return x.mean(dim=(1, 2, 3))


class TransformerBasicHead(nn.Module):
    """Mean over the tokens, dropout, projection (head_helper.py
    TransformerBasicHead); [B,T,H,W,C] is taken as its T*H*W tokens."""

    def __init__(self, dim_in: int, num_classes: int, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.projection = nn.Linear(dim_in, num_classes)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if x.dim() > 3:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
        x = dropout(x.mean(dim=1), self.dropout_rate, self.training, generator)
        x = self.projection(x)
        return torch.softmax(x, dim=-1) if not self.training else x
