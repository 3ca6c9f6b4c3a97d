"""MorphMLP-S video backbone: chunked-FC token mixing, no attention.

Counterpart of `mspi_tpu/models/morphmlp.py` (reference
backbones/MorphMLP.py, `MorphMLP_32_features_only` with
configs/K400_MLP_S16x4.yaml: layers (3, 4, 9, 3), dims (112, 224, 392, 784),
segment dims (14, 28, 28, 49), mlp_ratio 3). A 16-frame clip gives the
pyramid at strides 4/8/16/32 with T = 8.

Token mixing (MorphMLP.py:38-159): the channels are split into
`segment_dim` segments, and along W (or H, on the swapped tensor) each
chunk of `segment_dim` positions is exchanged with the segment axis, so one
Linear mixes (chunk x segment) jointly; along T the channels fall in 8
segments mixed with the 8 frames. A per-channel softmax gate (the
`reweight` MLP) blends the h / w / c branches (h / c in stage 4). The mixes
keep the reference's reshape, transpose and `nn.Linear` (the JAX package's
plain branch); the block MLP is a plain `Mlp`, not the LN+MLP kernel, as in
the JAX package. No kernel of the port runs here.

Each stage's H*W must be a multiple of its segment_dim, (H/32)(W/32) of 49
in stage 4: 224x224 runs, the default 224x384 does not (84 tokens in stage
4), as in the JAX package and the reference; the forward raises a
ValueError naming the condition.

Module names are the reference's (`patch_embed1`, `blocks1.0.t_fc.mlp_t`,
`blocks1.0.fc.mlp_h`, `blocks1.0.fc.reweight.fc1`, ...).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.config import MorphMLPConfig
from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d, DropPath


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int = 0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class MorphFC_T(nn.Module):
    """Temporal mixing (MorphMLP.py:129-159): the channels in 8 segments,
    (T x C/8) mixed jointly. Needs T == 8 (a 16-frame clip after the
    stride-2 patch embed)."""

    def __init__(self, dim: int):
        super().__init__()
        self.mlp_t = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, T, H, W, C = x.shape
        seg, S = 8, C // 8
        t = x.reshape(B, T, H, W, seg, S).permute(0, 4, 2, 3, 1, 5).reshape(B, seg, H, W, T * S)
        t = self.mlp_t(t).reshape(B, seg, H, W, T, S).permute(0, 4, 2, 3, 1, 5)
        return self.proj(t.reshape(B, T, H, W, C))


def _chunk_mix(x: torch.Tensor, mlp: nn.Linear, seg: int) -> torch.Tensor:
    """W-style chunk mixing of [B,T,H,W,C]: each chunk of seg consecutive
    (H, W) positions is swapped with the seg channel segments, mixed by
    `mlp`, and swapped back (the JAX package's plain branch)."""
    B, T, H, W, C = x.shape
    S = C // seg
    y = x.reshape(B, T, H * W // seg, seg, seg, S).transpose(3, 4)
    y = mlp(y.reshape(B, T, H * W // seg, seg, seg * S))
    y = y.reshape(B, T, H * W // seg, seg, seg, S).transpose(3, 4)
    return y.reshape(B, T, H, W, C)


def _gate(branches: List[torch.Tensor], reweight: Mlp) -> torch.Tensor:
    """Softmax over the branches of a per-channel weight drawn from their
    mean over (T, H, W), then the weighted sum (MorphMLP.py:107-123)."""
    B, C = branches[0].shape[0], branches[0].shape[-1]
    total = branches[0]
    for b in branches[1:]:
        total = total + b
    a = reweight(total.mean(dim=(1, 2, 3))).reshape(B, C, len(branches)).permute(2, 0, 1)
    a = torch.softmax(a, dim=0)[:, :, None, None, None, :]
    out = branches[0] * a[0]
    for i, b in enumerate(branches[1:], start=1):
        out = out + b * a[i]
    return out


class MorphFC_S(nn.Module):
    """Spatial mixing along H and W and a channel branch, blended by a
    3-way gate (MorphMLP.py:77-126)."""

    def __init__(self, dim: int, segment_dim: int):
        super().__init__()
        self.segment_dim = segment_dim
        self.mlp_h = nn.Linear(dim, dim)
        self.mlp_w = nn.Linear(dim, dim)
        self.mlp_c = nn.Linear(dim, dim)
        self.reweight = Mlp(dim, dim // 4, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        seg = self.segment_dim
        # the H branch mixes the W-swapped tensor (MorphMLP.py:98-106)
        h = _chunk_mix(x.transpose(2, 3), self.mlp_h, seg).transpose(2, 3)
        w = _chunk_mix(x, self.mlp_w, seg)
        c = self.mlp_c(x)
        return self.proj(_gate([h, w, c], self.reweight))


class MorphFC_S2(nn.Module):
    """Stage 4: one chunked branch over the flattened (H, W), whose chunk
    index runs over seg strided positions, and a channel branch, blended by
    a 2-way gate (MorphMLP.py:38-74)."""

    def __init__(self, dim: int, segment_dim: int):
        super().__init__()
        self.segment_dim = segment_dim
        self.mlp_c = nn.Linear(dim, dim)
        self.mlp_h = nn.Linear(dim, dim)
        self.reweight = Mlp(dim, dim // 4, dim * 2)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, T, H, W, C = x.shape
        seg = self.segment_dim
        S = C // seg
        h = x.reshape(B, T, seg, H * W // seg, seg, S).permute(0, 1, 4, 3, 2, 5)
        h = self.mlp_h(h.reshape(B, T, seg, H * W // seg, seg * S))
        h = h.reshape(B, T, seg, H * W // seg, seg, S).permute(0, 1, 4, 3, 2, 5)
        h = h.reshape(B, T, H, W, C)
        c = self.mlp_c(x)
        return self.proj(_gate([h, c], self.reweight))


class PermutatorBlock(nn.Module):
    """t_fc, spatial fc and MLP, each pre-normed; the spatial fc's residual
    is on the x before t_fc (MorphMLP.py:180-184)."""

    def __init__(self, dim: int, segment_dim: int, mlp_ratio: float = 3.0,
                 drop_path: float = 0.0, stage4: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.t_norm1 = nn.LayerNorm(dim)
        self.t_fc = MorphFC_T(dim)
        self.fc = (MorphFC_S2 if stage4 else MorphFC_S)(dim, segment_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.dp = DropPath(drop_path)

    def forward(self, x):
        xt = x + self.t_fc(self.t_norm1(x))
        x = x + self.dp(self.fc(self.norm1(xt)))
        return x + self.dp(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """Stem (MorphMLP.py:187-205): (3,3,3) / s(2,2,2) conv, BN, GELU,
    (1,3,3) / s(1,2,2) conv, BN: T/2, H/4, W/4."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj1 = Conv3d(3, embed_dim // 2, 3, 2, 1)
        self.norm1 = BatchNorm(embed_dim // 2)
        self.proj2 = Conv3d(embed_dim // 2, embed_dim, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.norm2 = BatchNorm(embed_dim)

    def forward(self, x):
        return self.norm2(self.proj2(F.gelu(self.norm1(self.proj1(x)))))


class Downsample(nn.Module):
    """(1,3,3) / s(1,2,2) conv, LayerNorm (MorphMLP.py:208-222)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.proj = Conv3d(in_dim, out_dim, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.norm = nn.LayerNorm(out_dim)

    def forward(self, x):
        return self.norm(self.proj(x))


def _halve(n: int) -> int:
    """A spatial size after a k3 / s2 / p1 conv."""
    return (n - 1) // 2 + 1


class MorphMLPFeatures(nn.Module):
    """[B,16,H,W,3] normalised clip -> [(B,8,H/4,W/4,112), (B,8,H/8,W/8,224),
    (B,8,H/16,W/16,392), (B,8,H/32,W/32,784)] (MorphMLP.py:371-508);
    drop-path rates 0.1 * i / (sum(layers) - 1) over the blocks."""

    def __init__(self, cfg: MorphMLPConfig):
        super().__init__()
        c = cfg
        dims, segs, layers = c.embed_dims, c.segment_dim, c.layers
        self.segment_dim = tuple(segs)
        dpr = [0.1 * i / (sum(layers) - 1) for i in range(sum(layers))]
        self.patch_embed1 = PatchEmbed(dims[0])
        offset = 0
        for si in range(4):
            self.add_module(f"blocks{si + 1}", nn.Sequential(*[
                PermutatorBlock(dims[si], segs[si], c.mlp_ratios[si], drop_path=dpr[offset + i],
                                stage4=(si == 3))
                for i in range(layers[si])]))
            offset += layers[si]
        for si in (1, 2, 3):
            self.add_module(f"patch_embed{si + 1}", Downsample(dims[si - 1], dims[si]))

    def check_resolution(self, H: int, W: int) -> None:
        """Raise where a stage's H*W is not a multiple of its segment_dim."""
        h, w = _halve(_halve(H)), _halve(_halve(W))
        for si, seg in enumerate(self.segment_dim):
            if si:
                h, w = _halve(h), _halve(w)
            if (h * w) % seg:
                raise ValueError(
                    f"MorphMLP needs (H/{4 << si})(W/{4 << si}) to be a multiple of stage "
                    f"{si + 1}'s segment_dim {seg}: the resolution {H}x{W} gives {h}x{w} = "
                    f"{h * w} tokens there (224x224 runs; 224x384 does not)")

    def forward(self, x) -> List[torch.Tensor]:
        self.check_resolution(x.shape[2], x.shape[3])
        x = self.patch_embed1(x)
        feas = []
        for si in range(1, 5):
            if si > 1:
                x = getattr(self, f"patch_embed{si}")(x)
            x = getattr(self, f"blocks{si}")(x)
            feas.append(x)
        return feas
