"""Non-local block, channels-last.

Counterpart of `mspi_tpu/models/nonlocal_block.py` (reference
SlowFast/nonlocal_helper.py:10-144): theta / phi / g 1x1x1 convs, the
affinity of every position with every (optionally max-pooled) position,
normalised by a softmax or by the count, the aggregated g through conv_out
and BatchNorm, added to the input. `ResStage` inserts it after the blocks
in its `nonlocal_inds`; the MSPI configs enable none. Both products are
plain `torch.einsum`, as the JAX package computes them outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d, max_pool


class Nonlocal(nn.Module):
    def __init__(self, dim: int, dim_inner: int,
                 pool_size: Optional[Tuple[int, int, int]] = None,
                 instantiation: str = "softmax"):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(instantiation)
        self.dim_inner, self.instantiation = dim_inner, instantiation
        self.pool_size = (tuple(pool_size) if pool_size is not None
                          and any(s > 1 for s in pool_size) else None)
        self.conv_theta = Conv3d(dim, dim_inner, 1)
        self.conv_phi = Conv3d(dim, dim_inner, 1)
        self.conv_g = Conv3d(dim, dim_inner, 1)
        self.conv_out = Conv3d(dim_inner, dim, 1)
        self.bn = BatchNorm(dim)

    def forward(self, x):
        B, T, H, W, _ = x.shape
        theta = self.conv_theta(x).reshape(B, -1, self.dim_inner)
        pooled = x if self.pool_size is None else max_pool(x, self.pool_size, self.pool_size)
        phi = self.conv_phi(pooled).reshape(B, -1, self.dim_inner)
        g = self.conv_g(pooled).reshape(B, -1, self.dim_inner)
        affinity = torch.einsum("btc,bpc->btp", theta, phi)
        if self.instantiation == "softmax":
            affinity = torch.softmax(affinity * self.dim_inner ** -0.5, dim=2)
        else:
            affinity = affinity / affinity.shape[2]
        out = torch.einsum("btg,bgc->btc", affinity, g).reshape(B, T, H, W, self.dim_inner)
        return x + self.bn(self.conv_out(out))
