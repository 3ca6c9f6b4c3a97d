"""UniFormer-B video backbone: conv-attention hybrid.

Counterpart of `mspi_tpu/models/uniformer.py` (reference
backbones/uniformer.py, uniformer_b16x4_k400.yaml: dims (64, 128, 320, 512),
depths (5, 8, 20, 7), head dim 64, joint space-time SABlocks, SPLIT=False,
STD=False). Stages 1-2 are CBlocks (depthwise-conv "attention": 1x1x1 ->
5x5x5 depthwise -> 1x1x1 with BatchNorm3d norms), stages 3-4 SABlocks
(depthwise pos-embed conv + global joint multi-head self-attention over the
T*H*W tokens with LayerNorm(1e-6)). Pyramid at strides 4/8/16/32, T = 8 for a
16-frame clip.

Kernels on the path (activations channels-last [B,T,H,W,C]):
- every `Attention` runs K4 (`self_attention`, TPU
  `pooled_attention.py::fused_self_attention`) on the packed q / kv that the
  split qkv linear emits: head dim 64, N = 8 * 14 * 24 = 2688 tokens at
  stage 3 (C 320, 5 heads) and 672 at stage 4 (C 512, 8 heads) at 224x384.
  The JAX package takes its kernel only up to N = 4096 (its VMEM gate) and
  the plain einsum above; the port takes K4 at every N on the card;
- every `SABlock`'s norm2 + MLP runs K2 (`ln_mlp`, through `ln_mlp_block`)
  at C = 320 and 512; at inference with quant="int8" row 12 (`ln_mlp_int8`)
  instead, at both widths, as the JAX block's `maybe_fused_ln_mlp` routes it
  under MSPI_QUANT=int8;
- the CBlocks' 3x3x3 and 5x5x5 depthwise convs, the 1x1x1 convs, the patch
  embeds and the BatchNorms are plain PyTorch (cuDNN), as the JAX package
  runs them outside Pallas. `SplitSABlock` (cfg.split) runs its MLP plain,
  as the JAX block does.

Module names are the reference's, so its checkpoints and the JAX package's
converted variables load unchanged (the split qkv is one `qkv` linear).
"""

from __future__ import annotations

import functools
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.config import UniFormerConfig
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp_block
from mspi_tpu_torch.ops.kernels.pooled_attention import self_attention
from mspi_tpu_torch.ops.layers import BatchNorm, Conv3d, DropPath


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CMlp(nn.Module):
    """1x1x1-conv MLP (uniformer.py:99-115)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Conv3d(dim, hidden, 1)
        self.fc2 = Conv3d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Joint space-time multi-head self-attention (uniformer.py:71-96) on x
    [B, N, C] through K4. temporal_init: SplitSABlock's t_attn, whose qkv
    starts at 0 and proj weight at 1 (uniformer.py:384-394); the fusion
    model's initialiser reads the flag."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 temporal_init: bool = False):
        super().__init__()
        self.num_heads, self.temporal_init = num_heads, temporal_init
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        C = x.shape[-1]
        # q and kv straight out of the split weight: packed [B,N,C] and
        # [B,N,2C], the layout K4 reads
        w, b = self.qkv.weight, self.qkv.bias
        q = F.linear(x, w[:C], None if b is None else b[:C])
        kv = F.linear(x, w[C:], None if b is None else b[C:])
        return self.proj(self_attention(q, kv, self.num_heads))


class CBlock(nn.Module):
    """Conv block (uniformer.py:118-137): depthwise pos conv + BN-normed
    depthwise 5x5x5 'attention' + CMlp."""

    def __init__(self, dim: int, drop_path: float = 0.0):
        super().__init__()
        self.pos_embed = Conv3d(dim, dim, 3, 1, 1, groups=dim)
        self.norm1 = BatchNorm(dim)
        self.conv1 = Conv3d(dim, dim, 1)
        self.conv2 = Conv3d(dim, dim, 1)
        self.attn = Conv3d(dim, dim, 5, 1, 2, groups=dim)
        self.norm2 = BatchNorm(dim)
        self.mlp = CMlp(dim, 4 * dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.drop_path(self.conv2(self.attn(self.conv1(self.norm1(x)))))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class SABlock(nn.Module):
    """Global joint space-time attention block (uniformer.py:140-163)."""

    def __init__(self, dim: int, num_heads: int, drop_path: float = 0.0, quant: str = ""):
        super().__init__()
        self.quant = quant
        self.pos_embed = Conv3d(dim, dim, 3, 1, 1, groups=dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.pos_embed(x)
        B, T, H, W, C = x.shape
        t = x.reshape(B, T * H * W, C)
        t = (t + self.drop_path(self.attn(self.norm1(t)))).contiguous()
        int8 = self.quant == "int8" and not self.training
        t = t + self.drop_path(ln_mlp_block(self.norm2, self.mlp, t, int8))
        return t.reshape(B, T, H, W, C)


class SplitSABlock(nn.Module):
    """Divided space-time attention block (uniformer.py:166-201, SPLIT=True):
    temporal attention over T per spatial location feeds, through norm1 only
    (the residual stream restarts from x, as the reference's forward does),
    a spatial attention per frame, then the joint MLP."""

    def __init__(self, dim: int, num_heads: int, drop_path: float = 0.0):
        super().__init__()
        self.pos_embed = Conv3d(dim, dim, 3, 1, 1, groups=dim)
        self.t_norm = nn.LayerNorm(dim, eps=1e-6)
        self.t_attn = Attention(dim, num_heads, temporal_init=True)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        x = x + self.pos_embed(x)
        B, T, H, W, C = x.shape
        # temporal attention: tokens [B*H*W, T, C]
        t = x.permute(0, 2, 3, 1, 4).reshape(B * H * W, T, C)
        t = t + self.drop_path(self.t_attn(self.t_norm(t)))
        # spatial attention: [B*T, H*W, C]; the residual restarts from x
        s = t.reshape(B, H * W, T, C).transpose(1, 2).reshape(B * T, H * W, C)
        s = x.reshape(B * T, H * W, C) + self.drop_path(self.attn(self.norm1(s)))
        out = s.reshape(B, T * H * W, C)
        out = out + self.drop_path(self.mlp(self.norm2(out)))
        return out.reshape(B, T, H, W, C)


class SpecialPatchEmbed(nn.Module):
    """Stem (uniformer.py:204-229, sic 'SpeicalPatchEmbed'): (3,4,4)/s(2,4,4)
    p(1,0,0) conv, then LayerNorm over channels."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim)
        self.proj = Conv3d(in_dim, embed_dim, (3, 4, 4), (2, 4, 4), (1, 0, 0))

    def forward(self, x):
        return self.norm(self.proj(x))


class PatchEmbed(nn.Module):
    """Stage transition (uniformer.py:232-260, STD=False): (1,2,2)/s(1,2,2)
    conv + LayerNorm."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim)
        self.proj = Conv3d(in_dim, embed_dim, (1, 2, 2), (1, 2, 2), 0)

    def forward(self, x):
        return self.norm(self.proj(x))


class UniFormerFeatures(nn.Module):
    """[B,16,H,W,3] normalised clip -> 4-level pyramid (64, 128, 320, 512),
    T = 8. Drop-path rates rise linearly from 0 to 0.1 over the blocks.
    quant="int8" reaches the SABlocks (SplitSABlock's MLP stays plain, as
    in the JAX block)."""

    def __init__(self, cfg: UniFormerConfig, quant: str = ""):
        super().__init__()
        dims, depths = cfg.embed_dim, cfg.depth
        heads = [d // cfg.head_dim for d in dims]
        total = sum(depths)
        dpr = [0.1 * i / (total - 1) for i in range(total)]
        self.patch_embed1 = SpecialPatchEmbed(3, dims[0])
        self.patch_embed2 = PatchEmbed(dims[0], dims[1])
        self.patch_embed3 = PatchEmbed(dims[1], dims[2])
        self.patch_embed4 = PatchEmbed(dims[2], dims[3])
        sa = SplitSABlock if cfg.split else functools.partial(SABlock, quant=quant)
        off = [sum(depths[:i]) for i in range(4)]
        self.blocks1 = nn.Sequential(*(CBlock(dims[0], dpr[off[0] + i])
                                       for i in range(depths[0])))
        self.blocks2 = nn.Sequential(*(CBlock(dims[1], dpr[off[1] + i])
                                       for i in range(depths[1])))
        self.blocks3 = nn.Sequential(*(sa(dims[2], heads[2], dpr[off[2] + i])
                                       for i in range(depths[2])))
        self.blocks4 = nn.Sequential(*(sa(dims[3], heads[3], dpr[off[3] + i])
                                       for i in range(depths[3])))

    def forward(self, x) -> List[torch.Tensor]:
        feas = []
        for i in range(1, 5):
            x = getattr(self, f"blocks{i}")(getattr(self, f"patch_embed{i}")(x))
            feas.append(x)
        return feas
