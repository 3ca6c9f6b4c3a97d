"""ConvNeXt-T feature extractor: the frozen image-saliency prior.

Counterpart of `mspi_tpu/models/convnext.py` (timm convnext_tiny,
features_only): depths (3,3,9,3), dims (96,192,384,768), LayerNorm eps 1e-6,
layer scale `gamma`. Module names follow timm's FeatureListNet flattening
(stem.{0,1}, stages_i.downsample.{0,1}, stages_i.blocks.N.{conv_dw, norm,
mlp.fc1, mlp.fc2, gamma}).

Each block's LN + MLP runs through `ln_mlp_prior`, the K2 kernel at the call
site of the JAX package's transposed-layout kernel `fused_ln_mlp_t` (K3), on
the channels-last [frames*H*W, C] tokens. Two serving options, off by
default, take the JAX package's prior switches:
- `fold_res` (MSPI_PRIOR_FOLD_RES=1): each block returns
  `ln_mlp_prior_res`, the residual shortcut + gamma * mlp(LN(x)) from one
  kernel (TPU row 10);
- `ln_t` (MSPI_PRIOR_LN_T=1): `stem.1` and each `stages_i.downsample.0`
  run the LayerNorm kernel `layernorm_tokens` (TPU row 11).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mspi_tpu_torch.ops.kernels.layernorm import layernorm_tokens
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp_prior, ln_mlp_prior_res
from mspi_tpu_torch.ops.layers import Conv2d


class Mlp2d(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class PriorLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of channels-last tokens; with `kernel` set
    it runs `layernorm_tokens` (the prior's stem and downsample norms)."""

    def __init__(self, dim: int, eps: float = 1e-6, kernel: bool = False):
        super().__init__(dim, eps=eps)
        self.kernel = kernel

    def forward(self, x):
        if self.kernel:
            return layernorm_tokens(x, self.weight, self.bias, self.eps)
        return super().forward(x)


class ConvNeXtBlock2d(nn.Module):
    """7x7 depthwise conv -> LN -> MLP(4x, GELU) -> gamma, plus residual;
    with `fold_res` the residual sum is taken inside the kernel."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, fold_res: bool = False):
        super().__init__()
        self.fold_res = fold_res
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp2d(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        y = self.conv_dw(x).contiguous()
        weights = (self.norm.weight, self.norm.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                   self.mlp.fc2.weight, self.mlp.fc2.bias, self.norm.eps)
        if self.fold_res:
            return ln_mlp_prior_res(y, x.contiguous(), self.gamma, *weights)
        return x + self.gamma * ln_mlp_prior(y, *weights)


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, has_downsample: bool,
                 fold_res: bool = False, ln_t: bool = False):
        super().__init__()
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(PriorLayerNorm(in_dim, kernel=ln_t),
                                            Conv2d(in_dim, dim, 2, stride=2))
        self.blocks = nn.Sequential(*[ConvNeXtBlock2d(dim, fold_res=fold_res)
                                      for _ in range(depth)])

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class ConvNeXtTinyFeatures(nn.Module):
    """[N,H,W,3] normalised frames -> 4 maps at strides 4/8/16/32."""

    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), fold_res: bool = False,
                 ln_t: bool = False):
        super().__init__()
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4),
                                  PriorLayerNorm(dims[0], kernel=ln_t))
        in_dim = dims[0]
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            setattr(self, f"stages_{i}",
                    ConvNeXtStage(in_dim, dim, depth, i > 0, fold_res, ln_t))
            in_dim = dim

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        o0 = self.stages_0(self.stem(x))
        o1 = self.stages_1(o0)
        o2 = self.stages_2(o1)
        o3 = self.stages_3(o2)
        return o0, o1, o2, o3
