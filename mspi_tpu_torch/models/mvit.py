"""MViTv2-S video backbone: pooled attention with decomposed relative
positions.

Counterpart of `mspi_tpu/models/mvit.py` (reference backbones/MViT.py with
configs/MVITv2_S_16x4.yaml): 16 blocks, embed 96 -> 768 (x2 at blocks
1/3/14, dim_mul_in_att), heads 1 -> 8, depthwise 3x3x3 conv pooling of q/k/v
(q stride (1,2,2) at the transition blocks, adaptive kv stride from
(1,8,8)), decomposed spatial + temporal rel-pos bias, residual pooling, no
cls token, no absolute positions. The pyramid is tapped after blocks
{0,2,13,15}.

Tokens are [B, N, C] with a tracked (T,H,W). Attention runs through the K1
kernel (`attention_rel`), each block's LN + MLP through K2 (`ln_mlp`), or at
inference with quant="int8" and C >= 256 through the int8 kernel
(`ln_mlp_int8`, blocks 3-15), as the JAX package routes MSPI_QUANT=int8. K1
and K2 are differentiable through their backward kernels, and autograd through
`rel_projections` stays plain PyTorch. In train mode both residual adds of
block i pass through drop-path at rate 0.2 * i / (depth - 1), as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp_block
from mspi_tpu_torch.ops.kernels.pooled_attention import attention_rel
from mspi_tpu_torch.ops.layers import Conv3d, DropPath, max_pool


def round_width(width, multiplier, min_width=1, divisor=1):
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def get_rel_pos(rel_pos: torch.Tensor, d: int) -> torch.Tensor:
    """Half-pixel linear interpolation of a rel-pos table to length d."""
    if rel_pos.shape[0] == d:
        return rel_pos
    y = F.interpolate(rel_pos.T[None], size=d, mode="linear", align_corners=False)
    return y[0].T


def _axis_table(rel_pos: torch.Tensor, q_n: int, k_n: int, dtype) -> torch.Tensor:
    """One decomposed rel-pos table gathered to the runtime geometry:
    [q_n, k_n, dim], interpolated in fp32 and cast to `dtype`."""
    d = int(2 * max(q_n, k_n) - 1)
    q_ratio = max(k_n / q_n, 1.0)
    k_ratio = max(q_n / k_n, 1.0)
    dist = (np.arange(q_n)[:, None] * q_ratio
            - np.arange(k_n)[None, :] * k_ratio + (k_n - 1) * k_ratio)
    idx = torch.from_numpy(dist.astype(np.int64)).to(rel_pos.device)
    return get_rel_pos(rel_pos.float(), d)[idx].to(dtype)


def rel_projections(q: torch.Tensor, q_shape, k_shape, rel_pos_t, rel_pos_h,
                    rel_pos_w) -> torch.Tensor:
    """Per-query rel-pos projections of the pooled, normed q [B,H,Nq,D]:
    [B, H, Nq, R] with columns t | h | w (R = k_t + k_h + k_w)."""
    B, n_head, q_n, dim = q.shape
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    r_q = q.reshape(B, n_head, q_t, q_h, q_w, dim)
    Rt = _axis_table(rel_pos_t, q_t, k_t, q.dtype)
    Rh = _axis_table(rel_pos_h, q_h, k_h, q.dtype)
    Rw = _axis_table(rel_pos_w, q_w, k_w, q.dtype)
    cols = [torch.einsum("bythwc,tkc->bythwk", r_q, Rt),
            torch.einsum("bythwc,hkc->bythwk", r_q, Rh),
            torch.einsum("bythwc,wkc->bythwk", r_q, Rw)]
    return torch.cat(cols, dim=-1).reshape(B, n_head, q_n, -1)


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention, conv mode, fused qkv, residual pooling."""

    def __init__(self, dim: int, dim_out: int, input_size: Sequence[int], num_heads: int,
                 qkv_bias: bool, kernel_q, kernel_kv, stride_q, stride_kv):
        super().__init__()
        self.dim_out, self.num_heads = dim_out, num_heads
        head_dim = dim_out // num_heads
        self.kernel_q, self.kernel_kv = tuple(kernel_q), tuple(kernel_kv)
        self.stride_q, self.stride_kv = tuple(stride_q), tuple(stride_kv)
        self.qkv = nn.Linear(dim, dim_out * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim_out, dim_out)

        def pool(kernel, stride):
            return nn.Conv3d(head_dim, head_dim, kernel, stride,
                             tuple(k // 2 for k in kernel), groups=head_dim, bias=False)

        self.pool_q = pool(self.kernel_q, self.stride_q)
        self.norm_q = nn.LayerNorm(head_dim, eps=1e-6)
        self.pool_k = pool(self.kernel_kv, self.stride_kv)
        self.norm_k = nn.LayerNorm(head_dim, eps=1e-6)
        self.pool_v = pool(self.kernel_kv, self.stride_kv)
        self.norm_v = nn.LayerNorm(head_dim, eps=1e-6)

        size = input_size[1]
        rel_sp_dim = 2 * max(size // stride_q[1], size // stride_kv[1]) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * 8 - 1, head_dim))

    def _pool(self, x, thw, conv, norm):
        """[B, N, H*D] -> depthwise conv per head -> LN -> [B, H, N', D]."""
        B, H = x.shape[0], self.num_heads
        D = self.dim_out // H
        grid = x.reshape(B, *thw, H, D).permute(0, 4, 5, 1, 2, 3).reshape(B * H, D, *thw)
        y = conv(grid.contiguous())  # NCDHW: see ops.layers.Conv3d
        out_thw = tuple(y.shape[2:])
        y = y.reshape(B, H, D, -1).transpose(2, 3)
        return norm(y).contiguous(), out_thw

    def forward(self, x: torch.Tensor, thw: Tuple[int, int, int]):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q, q_shape = self._pool(q, thw, self.pool_q, self.norm_q)
        k, k_shape = self._pool(k, thw, self.pool_k, self.norm_k)
        v, _ = self._pool(v, thw, self.pool_v, self.norm_v)
        rel = rel_projections(q, q_shape, k_shape, self.rel_pos_t, self.rel_pos_h,
                              self.rel_pos_w).contiguous()
        head = self.dim_out // self.num_heads
        out = attention_rel(q, k, v, rel, k_shape, head ** -0.5)
        out = out + q  # residual pooling
        B = x.shape[0]
        return self.proj(out.transpose(1, 2).reshape(B, -1, self.dim_out)), q_shape


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)


class MultiScaleBlock(nn.Module):
    """DIM_MUL_IN_ATT block: attention projects to dim_out; the skip path is
    proj(norm1(x)) max-pooled by the q stride."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, input_size, mlp_ratio: float,
                 qkv_bias: bool, kernel_q, kernel_kv, stride_q, stride_kv,
                 drop_path: float = 0.0, quant: str = ""):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.quant = quant
        self.drop_path = DropPath(drop_path)
        self.stride_q = tuple(stride_q)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, input_size, num_heads, qkv_bias,
                                        kernel_q, kernel_kv, stride_q, stride_kv)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio), dim_out)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def _pool_skip(self, x, thw):
        if math.prod(self.stride_q) == 1:
            return x
        kernel = tuple(s + 1 if s > 1 else s for s in self.stride_q)
        B, _, C = x.shape
        y = max_pool(x.reshape(B, *thw, C), kernel, self.stride_q,
                     tuple(k // 2 for k in kernel))
        return y.reshape(B, -1, C)

    def forward(self, x, thw):
        x_norm = self.norm1(x)
        x_block, thw_new = self.attn(x_norm, thw)
        if self.dim != self.dim_out:
            x = self.proj(x_norm)
        x = (self._pool_skip(x, thw) + self.drop_path(x_block)).contiguous()
        y = ln_mlp_block(self.norm2, self.mlp, x, self.quant == "int8" and not self.training)
        return x + self.drop_path(y), thw_new


class PatchEmbedMViT(nn.Module):
    """(3,7,7)/s(2,4,4)/p(1,3,3) patchify conv -> tokens + (T,H,W)."""

    def __init__(self, kernel, stride, padding, embed_dim: int):
        super().__init__()
        self.proj = Conv3d(3, embed_dim, kernel, stride, padding)

    def forward(self, x):
        y = self.proj(x)
        B, T, H, W, C = y.shape
        return y.reshape(B, T * H * W, C), (T, H, W)


class MViTFeatures(nn.Module):
    """[B,16,H,W,3] normalised clip -> pyramid (96,192,384,768) at strides
    4/8/16/32, T=8, tapped at blocks {0,2,13,15}."""

    def __init__(self, cfg: MViTConfig, quant: str = ""):
        super().__init__()
        c = cfg
        depth = c.depth
        dim_mul = np.ones(depth + 1)
        head_mul = np.ones(depth + 1)
        for idx, mul in c.dim_mul:
            dim_mul[idx] = mul
        for idx, mul in c.head_mul:
            head_mul[idx] = mul
        stride_q = [list(s[1:]) for s in sorted(c.pool_q_stride)]
        kernel = list(c.pool_kvq_kernel)
        stride_kv = []
        skv = list(c.pool_kv_stride_adaptive)
        for i in range(depth):
            skv = [max(skv[d] // stride_q[i][d], 1) for d in range(3)]
            stride_kv.append(list(skv))
        # rel-pos tables are sized for the 224x224 training crop
        input_size = [16 // c.patch_stride[0], 224 // c.patch_stride[1],
                      224 // c.patch_stride[2]]
        embed_dim, num_heads = c.embed_dim, c.num_heads
        dpr = [0.2 * i / (depth - 1) for i in range(depth)]
        blocks = []
        for i in range(depth):
            num_heads = round_width(num_heads, head_mul[i])
            dim_out = round_width(embed_dim, dim_mul[i],
                                  divisor=round_width(num_heads, head_mul[i]))
            blocks.append(MultiScaleBlock(
                embed_dim, dim_out, num_heads, tuple(input_size), c.mlp_ratio,
                c.qkv_bias, kernel, kernel, stride_q[i], stride_kv[i], dpr[i], quant))
            if math.prod(stride_q[i]) > 1:
                input_size = [s // st for s, st in zip(input_size, stride_q[i])]
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)
        self.taps = tuple(c.out_indices)
        self.patch_embed = PatchEmbedMViT(c.patch_kernel, c.patch_stride,
                                          c.patch_padding, c.embed_dim)

    def forward(self, x) -> List[torch.Tensor]:
        x, thw = self.patch_embed(x)
        feas = []
        for i, blk in enumerate(self.blocks):
            x, thw = blk(x, thw)
            if i in self.taps:
                feas.append(x.reshape(x.shape[0], *thw, -1))
        return feas
