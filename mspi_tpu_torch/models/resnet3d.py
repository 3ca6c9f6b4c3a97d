"""3-D ResNet building blocks, channels-last: what X3D, SlowFast and the
classifier zoo's ResNets need.

Counterpart of the X3D and SlowFast parts of `mspi_tpu/models/resnet3d.py`
(reference SlowFast stem_helper.py and resnet_helper.py): X3D's channel
rounding, Swish, Squeeze-Excitation, the ResNet stem (a Tx7x7 conv,
BatchNorm, ReLU and a 1x3x3 max-pool) and the X3D stem (a 1xkxk conv, then
a channelwise kx1x1 conv, BatchNorm and ReLU), the per-pathway
`VideoModelStem` with its stem chosen by name, the ResNet bottleneck
`BottleneckTransform` (Tx1x1, 1x3x3, 1x1x1), the X3D bottleneck
`X3DTransform` (1x1x1, channelwise Tx3x3 with SE every other block and
Swish, 1x1x1), `BasicTransform` (Tx3x3, 1x3x3), the ir-CSN `CSNTransform`
and the (2+1)D `R2Plus1DTransform`, chosen by name (`TRANS_FUNCS`), `ResBlock` with its
projection shortcut, and `ResStage` with its optional non-local blocks
(`models/nonlocal_block.py`, which no MSPI config enables).

Module names are the reference's (s1.pathway0_stem.conv_xy,
s2.pathway0_res0.branch2.a, ...), so the released checkpoints and the
converters map every key. Every conv, norm and pool is plain PyTorch, as the
JAX package runs them on XLA: the channelwise convs are grouped `F.conv3d`
(groups = channels), not the depthwise conv kernel. BatchNorm is eps 1e-5,
momentum 0.1 (torch's defaults), in train mode flax's batch statistics
(`ops.layers.BatchNorm`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from mspi_tpu_torch.models.nonlocal_block import Nonlocal
from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d, adaptive_avg_pool, max_pool

Triple = Tuple[int, int, int]


def round_width(width, multiplier, min_width=1, divisor=1):
    """X3D channel rounding (X3D.py:100-109)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class SE(nn.Module):
    """Squeeze-Excitation with a ReLU inside (resnet_helper.py:27-73)."""

    def __init__(self, dim_in: int, ratio: float = 0.0625):
        super().__init__()
        dim_fc = round_width(dim_in, ratio, min_width=8, divisor=8)
        self.fc1 = Conv3d(dim_in, dim_fc, 1, bias=True)
        self.fc2 = Conv3d(dim_fc, dim_in, 1, bias=True)

    def forward(self, x):
        s = torch.relu(self.fc1(adaptive_avg_pool(x, 3)))
        return x * torch.sigmoid(self.fc2(s))


class ResNetBasicStem(nn.Module):
    """Tx7x7 conv, BN, ReLU, then a 1x3x3 / s(1,2,2) max-pool with -inf
    padding (stem_helper.py:160-205)."""

    def __init__(self, dim_in: int, dim_out: int, kernel: Triple, stride: Triple,
                 padding: Triple):
        super().__init__()
        self.conv = Conv3d(dim_in, dim_out, kernel, stride, padding, bias=False)
        self.bn = BatchNorm(dim_out)

    def forward(self, x):
        return max_pool(torch.relu(self.bn(self.conv(x))), (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """1xkxk conv, then a channelwise kx1x1 conv, BN, ReLU
    (stem_helper.py:207-288)."""

    def __init__(self, dim_in: int, dim_out: int, kernel: Triple, stride: Triple,
                 padding: Triple):
        super().__init__()
        k, s, p = kernel, stride, padding
        self.conv_xy = Conv3d(dim_in, dim_out, (1, k[1], k[2]), (1, s[1], s[2]),
                              (0, p[1], p[2]), bias=False)
        self.conv = Conv3d(dim_out, dim_out, (k[0], 1, 1), (s[0], 1, 1), (p[0], 0, 0),
                           groups=dim_out, bias=False)
        self.bn = BatchNorm(dim_out)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(self.conv_xy(x))))


STEM_FUNCS = {"basic_stem": ResNetBasicStem, "x3d_stem": X3DStem}


class VideoModelStem(nn.Module):
    """One stem per pathway, named pathway{p}_stem (stem_helper.py:21-157)."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int],
                 kernel: Sequence[Triple], stride: Sequence[Triple],
                 padding: Sequence[Triple], stem_func_name: str = "basic_stem"):
        super().__init__()
        cls = STEM_FUNCS[stem_func_name]
        for p in range(len(dim_in)):
            self.add_module(f"pathway{p}_stem", cls(
                dim_in[p], dim_out[p], tuple(kernel[p]), tuple(stride[p]), tuple(padding[p])))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"pathway{p}_stem")(x) for p, x in enumerate(xs)]


class BasicTransform(nn.Module):
    """Tx3x3 (strided) -> 1x3x3, BN after each, ReLU between
    (resnet_helper.py:122-208)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int, stride: int,
                 dim_inner: int = None, num_groups: int = 1, block_idx: int = 0):
        super().__init__()
        t = temp_kernel_size
        self.a = Conv3d(dim_in, dim_out, (t, 3, 3), (1, stride, stride), (t // 2, 1, 1),
                        bias=False)
        self.a_bn = BatchNorm(dim_out)
        self.b = Conv3d(dim_out, dim_out, (1, 3, 3), 1, (0, 1, 1), bias=False)
        self.b_bn = BatchNorm(dim_out)

    def forward(self, x):
        return self.b_bn(self.b(torch.relu(self.a_bn(self.a(x)))))


class BottleneckTransform(nn.Module):
    """Tx1x1 -> 1x3x3 (grouped, strided) -> 1x1x1, each with BN, ReLU after
    the first two (resnet_helper.py:355-487)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int, stride: int,
                 dim_inner: int, num_groups: int = 1, block_idx: int = 0):
        super().__init__()
        t = temp_kernel_size
        self.a = Conv3d(dim_in, dim_inner, (t, 1, 1), 1, (t // 2, 0, 0), bias=False)
        self.a_bn = BatchNorm(dim_inner)
        self.b = Conv3d(dim_inner, dim_inner, (1, 3, 3), (1, stride, stride), (0, 1, 1),
                        groups=num_groups, bias=False)
        self.b_bn = BatchNorm(dim_inner)
        self.c = Conv3d(dim_inner, dim_out, 1, bias=False)
        self.c_bn = BatchNorm(dim_out)

    def forward(self, x):
        x = torch.relu(self.a_bn(self.a(x)))
        x = torch.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class X3DTransform(nn.Module):
    """1x1x1 -> Tx3x3 grouped (SE on even blocks, then Swish) -> 1x1x1
    (resnet_helper.py:213-351)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int, stride: int,
                 dim_inner: int, num_groups: int = 1, block_idx: int = 0,
                 se_ratio: float = 0.0625):
        super().__init__()
        t = temp_kernel_size
        self.a = Conv3d(dim_in, dim_inner, 1, bias=False)
        self.a_bn = BatchNorm(dim_inner)
        self.b = Conv3d(dim_inner, dim_inner, (t, 3, 3), (1, stride, stride), (t // 2, 1, 1),
                        groups=num_groups, bias=False)
        self.b_bn = BatchNorm(dim_inner)
        if se_ratio > 0.0 and (block_idx + 1) % 2 == 1:
            self.se = SE(dim_inner, se_ratio)
        self.c = Conv3d(dim_inner, dim_out, 1, bias=False)
        self.c_bn = BatchNorm(dim_out)

    def forward(self, x):
        x = torch.relu(self.a_bn(self.a(x)))
        x = self.b_bn(self.b(x))
        if hasattr(self, "se"):
            x = self.se(x)
        return self.c_bn(self.c(swish(x)))


class CSNTransform(nn.Module):
    """ir-CSN bottleneck: 1x1x1 -> channel-separated Tx3x3 (groups =
    dim_inner, strided) -> 1x1x1, BN after each, ReLU after the first two
    (pytorchvideo's create_csn bottleneck, ptv_model_builder.py:14);
    num_groups is unread."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int, stride: int,
                 dim_inner: int, num_groups: int = 1, block_idx: int = 0):
        super().__init__()
        t = temp_kernel_size
        self.a = Conv3d(dim_in, dim_inner, 1, bias=False)
        self.a_bn = BatchNorm(dim_inner)
        self.b = Conv3d(dim_inner, dim_inner, (t, 3, 3), (1, stride, stride), (t // 2, 1, 1),
                        groups=dim_inner, bias=False)
        self.b_bn = BatchNorm(dim_inner)
        self.c = Conv3d(dim_inner, dim_out, 1, bias=False)
        self.c_bn = BatchNorm(dim_out)

    def forward(self, x):
        x = torch.relu(self.a_bn(self.a(x)))
        x = torch.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class R2Plus1DTransform(nn.Module):
    """(2+1)D bottleneck: 1x1x1 -> 1x3x3 spatial (strided) -> Tx1x1 temporal
    -> 1x1x1, BN after each, ReLU after all but the last (pytorchvideo's
    create_2plus1d_bottleneck_block, ptv_model_builder.py:20). The spatial
    conv's width is the R(2+1)D paper's floor(t 9 Ci Co / (9 Ci + t Co)),
    Ci = Co = dim_inner: the 3-D conv's parameter count."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int, stride: int,
                 dim_inner: int, num_groups: int = 1, block_idx: int = 0):
        super().__init__()
        t, ci = temp_kernel_size, dim_inner
        mid = (t * 9 * ci * ci) // (9 * ci + t * ci)
        self.a = Conv3d(dim_in, dim_inner, 1, bias=False)
        self.a_bn = BatchNorm(dim_inner)
        self.b_xy = Conv3d(dim_inner, mid, (1, 3, 3), (1, stride, stride), (0, 1, 1), bias=False)
        self.b_xy_bn = BatchNorm(mid)
        self.b_t = Conv3d(mid, dim_inner, (t, 1, 1), 1, (t // 2, 0, 0), bias=False)
        self.b_bn = BatchNorm(dim_inner)
        self.c = Conv3d(dim_inner, dim_out, 1, bias=False)
        self.c_bn = BatchNorm(dim_out)

    def forward(self, x):
        x = torch.relu(self.a_bn(self.a(x)))
        x = torch.relu(self.b_xy_bn(self.b_xy(x)))
        x = torch.relu(self.b_bn(self.b_t(x)))
        return self.c_bn(self.c(x))


TRANS_FUNCS = {"basic_transform": BasicTransform, "bottleneck_transform": BottleneckTransform,
               "x3d_transform": X3DTransform, "csn_transform": CSNTransform,
               "r2plus1d_transform": R2Plus1DTransform}


class ResBlock(nn.Module):
    """Residual block around the transform `trans_func_name`, with a 1x1x1
    projection shortcut where the width or the stride changes
    (resnet_helper.py:490-617)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int, stride: int,
                 trans_func_name: str, dim_inner: int, num_groups: int = 1,
                 block_idx: int = 0):
        super().__init__()
        if dim_in != dim_out or stride != 1:
            self.branch1 = Conv3d(dim_in, dim_out, 1, (1, stride, stride), 0, bias=False)
            self.branch1_bn = BatchNorm(dim_out)
        self.branch2 = TRANS_FUNCS[trans_func_name](
            dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups, block_idx=block_idx)

    def forward(self, x):
        f_x = self.branch2(x)
        if hasattr(self, "branch1"):
            x = self.branch1_bn(self.branch1(x))
        return torch.relu(x + f_x)


class ResStage(nn.Module):
    """Residual stage over pathways, blocks named pathway{p}_res{i}
    (resnet_helper.py:620-825): the first block of a pathway takes its
    stride, the first num_block_temp_kernel blocks cycle its temporal
    kernels, the rest take 1. A non-local block, pathway{p}_nonlocal{i},
    follows each block i in nonlocal_inds[p]; with nonlocal_group[p] > 1 it
    attends within each of that many chunks of T, folded into the batch."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int], stride: Sequence[int],
                 temp_kernel_sizes: Sequence[Sequence[int]], num_blocks: Sequence[int],
                 dim_inner: Sequence[int], num_groups: Sequence[int],
                 num_block_temp_kernel: Sequence[int],
                 trans_func_name: str = "bottleneck_transform",
                 nonlocal_inds: Sequence[Sequence[int]] = (),
                 nonlocal_group: Sequence[int] = (),
                 nonlocal_pool: Sequence[Sequence[int]] = (),
                 nonlocal_instantiation: str = "softmax"):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.nonlocal_inds = [set(nonlocal_inds[p]) if nonlocal_inds else set()
                              for p in range(len(self.num_blocks))]
        self.nonlocal_group = [nonlocal_group[p] if nonlocal_group else 1
                               for p in range(len(self.num_blocks))]
        for p, n in enumerate(self.num_blocks):
            tks = ((list(temp_kernel_sizes[p]) * n)[:num_block_temp_kernel[p]]
                   + [1] * (n - num_block_temp_kernel[p]))
            for i in range(n):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], tks[i],
                    stride[p] if i == 0 else 1, trans_func_name, dim_inner[p], num_groups[p],
                    block_idx=i))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2,
                        tuple(nonlocal_pool[p]) if nonlocal_pool else None,
                        nonlocal_instantiation))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for p, x in enumerate(xs):
            group = self.nonlocal_group[p]
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x)
                if i in self.nonlocal_inds[p]:
                    B, T, H, W, C = x.shape
                    x = getattr(self, f"pathway{p}_nonlocal{i}")(
                        x.reshape(B * group, T // group, H, W, C)).reshape(B, T, H, W, C)
            out.append(x)
        return out
