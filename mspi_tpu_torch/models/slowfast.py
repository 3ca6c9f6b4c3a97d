"""SlowFast 4x16 R50 video backbone, channels-last.

Counterpart of `mspi_tpu/models/slowfast.py` (reference backbones/sf.py with
configs/SLOWFAST_4x16_R50.yaml: alpha 4, beta_inv 8, fusion channel ratio
2, fusion kernel 5, R50 bottleneck stages). The slow pathway takes the 4
frames {0, 4, 12, -1} of the 16-frame clip (model_utils.py:521-524; the
last index is the reference's non-uniform one), the fast pathway all 16;
after the stem and stages s2-s4 a strided temporal conv fuses the fast
pathway into the slow one's channels. The pyramid is the slow pathway after
each stage's fuse (and s5): channels (320, 640, 1280, 2048) at strides
4/8/16/32, T = 4 throughout. Stage s5's fast pathway feeds nothing; it runs
all the same, as on the JAX package's plain path, so its BatchNorm running
statistics move in train mode, and its parameters get zero gradients.

No Pallas kernel runs in the JAX backbone, and no kernel of the port runs
here: every conv, norm and pool is plain PyTorch (cuDNN on the card). The
JAX package's TPU lowerings of the same function (the space-to-depth stems
and the T-folded fast pathway, `fold_t_enabled`) have no counterpart.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from mspi_tpu_torch.config import SlowFastConfig
from mspi_tpu_torch.models.resnet3d import ResStage, VideoModelStem
from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d

_STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
# the "slowfast" temporal kernel basis, per stage and pathway (sf.py:74-80)
_TEMP_KERNEL = [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]]
# the slow pathway's frames of a 16-frame clip; -1 is the last
SLOW_FRAMES = (0, 4, 12, -1)


class FuseFastToSlow(nn.Module):
    """(k,1,1) / s(alpha,1,1) conv of the fast pathway, BN, ReLU,
    concatenated onto the slow pathway's channels (sf.py:101-159)."""

    def __init__(self, dim_in: int, fusion_conv_channel_ratio: int, fusion_kernel: int,
                 alpha: int):
        super().__init__()
        self.conv_f2s = Conv3d(dim_in, dim_in * fusion_conv_channel_ratio,
                               (fusion_kernel, 1, 1), (alpha, 1, 1),
                               (fusion_kernel // 2, 0, 0), bias=False)
        self.bn = BatchNorm(dim_in * fusion_conv_channel_ratio)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        x_s, x_f = xs
        fuse = torch.relu(self.bn(self.conv_f2s(x_f)))
        return [torch.cat([x_s, fuse], dim=-1), x_f]


class SlowFastFeatures(nn.Module):
    """[B,16,H,W,3] normalised clip -> [s2, s3, s4, s5] of the slow pathway,
    channels-last."""

    def __init__(self, cfg: SlowFastConfig):
        super().__init__()
        c = cfg
        d2, d3, d4, d5 = _STAGE_DEPTH[c.depth]
        w = c.width_per_group
        dim_inner = c.num_groups * w
        beta = c.beta_inv
        ratio = c.fusion_conv_channel_ratio
        out_dim_ratio = beta // ratio
        tk = _TEMP_KERNEL

        self.s1 = VideoModelStem(
            [3, 3], [w, w // beta],
            [tuple(tk[0][0]) + (7, 7), tuple(tk[0][1]) + (7, 7)], [(1, 2, 2)] * 2,
            [(tk[0][0][0] // 2, 3, 3), (tk[0][1][0] // 2, 3, 3)], stem_func_name="basic_stem")
        self.s1_fuse = FuseFastToSlow(w // beta, ratio, c.fusion_kernel_sz, c.alpha)

        def stage(i, din_s, din_f, dout_s, dout_f, dinner, depth, stride):
            return ResStage(
                [din_s, din_f], [dout_s, dout_f], [stride, stride], tk[i], [depth] * 2,
                [dinner, dinner // beta], [c.num_groups] * 2,
                list(c.num_block_temp_kernel[i - 1]), trans_func_name="bottleneck_transform")

        self.s2 = stage(1, w + w // out_dim_ratio, w // beta, w * 4, w * 4 // beta,
                        dim_inner, d2, c.spatial_strides[0][0])
        self.s2_fuse = FuseFastToSlow(w * 4 // beta, ratio, c.fusion_kernel_sz, c.alpha)
        self.s3 = stage(2, w * 4 + w * 4 // out_dim_ratio, w * 4 // beta, w * 8, w * 8 // beta,
                        dim_inner * 2, d3, c.spatial_strides[1][0])
        self.s3_fuse = FuseFastToSlow(w * 8 // beta, ratio, c.fusion_kernel_sz, c.alpha)
        self.s4 = stage(3, w * 8 + w * 8 // out_dim_ratio, w * 8 // beta, w * 16,
                        w * 16 // beta, dim_inner * 4, d4, c.spatial_strides[2][0])
        self.s4_fuse = FuseFastToSlow(w * 16 // beta, ratio, c.fusion_kernel_sz, c.alpha)
        self.s5 = stage(4, w * 16 + w * 16 // out_dim_ratio, w * 16 // beta, w * 32,
                        w * 32 // beta, dim_inner * 8, d5, c.spatial_strides[3][0])

    def forward(self, clips) -> List[torch.Tensor]:
        slow = clips[:, [i % clips.shape[1] for i in SLOW_FRAMES]]
        x = self.s1_fuse(self.s1([slow, clips]))
        feas = []
        for stage, fuse in ((self.s2, self.s2_fuse), (self.s3, self.s3_fuse),
                            (self.s4, self.s4_fuse)):
            x = fuse(stage(x))
            feas.append(x[0])
        feas.append(self.s5(x)[0])
        return feas
