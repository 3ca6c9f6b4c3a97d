"""X3D-L video backbone, channels-last.

Counterpart of `mspi_tpu/models/x3d.py` (reference backbones/X3D.py with
configs/X3D_L.yaml: width 2.0, depth 5.0, bottleneck 2.25, dim_c1 12,
channelwise 3x3x3 convs, SE every other block, Swish). The stages s2..s5
give the pyramid (24, 48, 96, 192) at strides 4/8/16/32 and keep T = 16
throughout. No Pallas kernel runs in the JAX backbone, and no kernel of the
port runs here: every conv (the channelwise ones as grouped `F.conv3d`),
norm and pool is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from mspi_tpu_torch.config import X3DConfig
from mspi_tpu_torch.models.resnet3d import ResStage, VideoModelStem, round_width


class X3DFeatures(nn.Module):
    """[B,16,H,W,3] normalised clip -> [s2, s3, s4, s5] channels-last: widths
    round_width(dim, width_factor) of (12, 24, 48, 96), ceil(depth_factor *
    (1, 2, 5, 3)) blocks (5, 10, 25, 15 for X3D-L)."""

    def __init__(self, cfg: X3DConfig):
        super().__init__()
        c = cfg
        dim_res2 = c.dim_c1  # SCALE_RES2=False: res2 keeps dim_c1
        dim_res3 = round_width(dim_res2, 2.0, divisor=8)
        dim_res4 = round_width(dim_res3, 2.0, divisor=8)
        dim_res5 = round_width(dim_res4, 2.0, divisor=8)
        block_basis = ((1, dim_res2, 2), (2, dim_res3, 2), (5, dim_res4, 2), (3, dim_res5, 2))
        dim_res1 = round_width(c.dim_c1, c.width_factor)
        self.s1 = VideoModelStem([3], [dim_res1], [(5, 3, 3)], [(1, 2, 2)], [(2, 1, 1)],
                                 stem_func_name="x3d_stem")
        dim_in = dim_res1
        for s, (blocks, dim, stride) in enumerate(block_basis, start=2):
            dim_out = round_width(dim, c.width_factor)
            dim_inner = int(c.bottleneck_factor * dim_out)
            n_rep = int(math.ceil(c.depth_factor * blocks))
            self.add_module(f"s{s}", ResStage(
                [dim_in], [dim_out], [stride], [[3]], [n_rep], [dim_inner],
                num_groups=[dim_inner], num_block_temp_kernel=[n_rep],
                trans_func_name="x3d_transform"))
            dim_in = dim_out

    def forward(self, x) -> List[torch.Tensor]:
        xs = self.s1([x])
        feas = []
        for stage in (self.s2, self.s3, self.s4, self.s5):
            xs = stage(xs)
            feas.append(xs[0])
        return feas
