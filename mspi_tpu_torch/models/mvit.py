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

The layout options of `ModelConfig` (the JAX package's switches) reroute
`MultiScaleAttention`:
- attn_relk=False (MSPI_ATTN_RELK=0): the rel-pos bias and the scale go into
  augmented lanes, q_aug = [q*scale | rel] and k_aug = [k | E], formed in q's
  dtype, and the bias-free kernel `attention` (row 6) runs on them;
- attn_packed=True (MSPI_POOL_FAT=1 + MSPI_ATTN_PACKED=1), at inference in
  the blocks with more than one head and at most 4096 pooled keys: the pools
  run on all heads' lanes of the token-major [B, N, H*D] stream with the
  kernel tiled over the heads, the norms on its [B, N', H, D] view, the rel
  projections packed, and `attention_rel_packed` (row 8) adds the residual
  pooled q itself; proj reads its output. attn_relk=False wins over it;
- dwconv=True (MSPI_DWCONV=1): every stride-1 pool runs `dwconv3d` (row 18)
  on channels-last tokens, [B*H, T, H, W, D] per head or [B, T, H, W, H*D]
  packed.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels.dwconv import dwconv3d
from mspi_tpu_torch.ops.kernels.dwconv import supported as dwconv_supported
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp_block
from mspi_tpu_torch.ops.kernels.pooled_attention import (attention, attention_rel,
                                                         attention_rel_packed, key_expansion)
from mspi_tpu_torch.ops.layers import Conv3d, DropPath, checkpoint_block, max_pool, trunc_normal_

PACKED_MAX_KEYS = 4096  # the JAX package's bound on the packed path's pooled keys


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


def _tables(q, q_shape, k_shape, rel_pos_t, rel_pos_h, rel_pos_w):
    return [_axis_table(table, qn, kn, q.dtype)
            for table, qn, kn in zip((rel_pos_t, rel_pos_h, rel_pos_w), q_shape, k_shape)]


def rel_projections(q: torch.Tensor, q_shape, k_shape, rel_pos_t, rel_pos_h,
                    rel_pos_w) -> torch.Tensor:
    """Per-query rel-pos projections of the pooled, normed q [B,H,Nq,D]:
    [B, H, Nq, R] with columns t | h | w (R = k_t + k_h + k_w)."""
    B, n_head, q_n, dim = q.shape
    r_q = q.reshape(B, n_head, *q_shape, dim)
    Rt, Rh, Rw = _tables(q, q_shape, k_shape, rel_pos_t, rel_pos_h, rel_pos_w)
    cols = [torch.einsum("bythwc,tkc->bythwk", r_q, Rt),
            torch.einsum("bythwc,hkc->bythwk", r_q, Rh),
            torch.einsum("bythwc,wkc->bythwk", r_q, Rw)]
    return torch.cat(cols, dim=-1).reshape(B, n_head, q_n, -1)


def rel_projections_packed(q4: torch.Tensor, q_shape, k_shape, rel_pos_t, rel_pos_h,
                           rel_pos_w) -> torch.Tensor:
    """`rel_projections` of the packed normed q [B, Nq, H, D]: [B, Nq, H*R],
    head h's columns t | h | w at lanes [h*R, (h+1)*R) (the JAX package's
    `rel_proj_packed`)."""
    B, q_n, n_head, dim = q4.shape
    r6 = q4.reshape(B, *q_shape, n_head, dim)
    Rt, Rh, Rw = _tables(q4, q_shape, k_shape, rel_pos_t, rel_pos_h, rel_pos_w)
    cols = [torch.einsum("btyxhd,tkd->btyxhk", r6, Rt),
            torch.einsum("btyxhd,ykd->btyxhk", r6, Rh),
            torch.einsum("btyxhd,xkd->btyxhk", r6, Rw)]
    return torch.cat(cols, dim=-1).reshape(B, q_n, -1)


def augment_for_attention(q, k, q_shape, k_shape, scale, rel_pos_t, rel_pos_h, rel_pos_w):
    """The augmented operands of row 6 (the JAX package's
    `augment_for_fused_attn`): q_aug = [q*scale | rel_t | rel_h | rel_w] and
    k_aug = [k | E], both in q's dtype (under autocast the compute dtype, so
    in bf16 q*scale is rounded before the kernel, as in the JAX package);
    q [B,H,Nq,D], k [B,H,Nk,D] -> [B,H,Nq,D+R], [B,H,Nk,D+R]."""
    q, k = kernels.cast_for_autocast(q, k)
    rel = rel_projections(q, q_shape, k_shape, rel_pos_t, rel_pos_h, rel_pos_w).to(q.dtype)
    q_aug = torch.cat([q * scale, rel], dim=-1)
    E = torch.from_numpy(key_expansion(k_shape)).to(k.device, k.dtype)
    k_aug = torch.cat([k, E.expand(*k.shape[:2], *E.shape)], dim=-1)
    return q_aug, k_aug


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention, conv mode, fused qkv, residual pooling;
    `attn_relk`, `attn_packed` and `dwconv` are the layout options of
    `ModelConfig` (module docstring)."""

    def __init__(self, dim: int, dim_out: int, input_size: Sequence[int], num_heads: int,
                 qkv_bias: bool, kernel_q, kernel_kv, stride_q, stride_kv,
                 attn_relk: bool = True, attn_packed: bool = False, dwconv: bool = False):
        super().__init__()
        self.dim_out, self.num_heads = dim_out, num_heads
        self.attn_relk, self.attn_packed, self.dwconv = attn_relk, attn_packed, dwconv
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

    def _runs_dwconv(self, conv) -> bool:
        return self.dwconv and dwconv_supported(conv.kernel_size, conv.stride)

    def _pool(self, x, thw, conv, norm):
        """[B, N, H*D] -> depthwise conv per head -> LN -> [B, H, N', D]."""
        B, H = x.shape[0], self.num_heads
        D = self.dim_out // H
        if self._runs_dwconv(conv):  # row 18 on channels-last [B*H, T, H, W, D]
            grid = x.reshape(B, *thw, H, D).permute(0, 4, 1, 2, 3, 5).reshape(B * H, *thw, D)
            y = dwconv3d(grid, conv.weight).reshape(B, H, -1, D)
            return norm(y).contiguous(), tuple(thw)
        grid = x.reshape(B, *thw, H, D).permute(0, 4, 5, 1, 2, 3).reshape(B * H, D, *thw)
        y = conv(grid.contiguous())  # NCDHW: see ops.layers.Conv3d
        out_thw = tuple(y.shape[2:])
        y = y.reshape(B, H, D, -1).transpose(2, 3)
        return norm(y).contiguous(), out_thw

    def _pool_packed(self, x, thw, conv, norm):
        """[B, N, H*D] -> one depthwise conv over all H*D lanes, the head's
        kernel tiled over the heads -> LN of each head -> [B, N', H, D]."""
        B, C, H = x.shape[0], self.dim_out, self.num_heads
        w = conv.weight.repeat(H, 1, 1, 1, 1)  # lane h*D + d takes kernel d
        if self._runs_dwconv(conv):
            y, out_thw = dwconv3d(x.reshape(B, *thw, C), w), tuple(thw)
        else:
            grid = x.reshape(B, *thw, C).permute(0, 4, 1, 2, 3).contiguous()
            y = F.conv3d(grid, w, None, conv.stride, conv.padding, groups=C)
            out_thw = tuple(y.shape[2:])
            y = y.permute(0, 2, 3, 4, 1)
        return norm(y.reshape(B, -1, H, C // H)), out_thw

    def _packed_route(self, thw) -> bool:
        """The JAX package's `fully_packed` condition (rel-pos and both pools
        are always on in MViTv2-S): inference, more than one head, at most
        PACKED_MAX_KEYS pooled keys, and the rel-pos kernel on."""
        nk = math.prod((s + 2 * (k // 2) - k) // st + 1
                       for s, k, st in zip(thw, self.pool_k.kernel_size, self.pool_k.stride))
        return (self.attn_packed and self.attn_relk and not self.training
                and self.num_heads > 1 and nk <= PACKED_MAX_KEYS)

    def _forward_packed(self, q, k, v, thw):
        """Token-major from the pools to proj: no head-major copy anywhere."""
        B, C, H = q.shape[0], self.dim_out, self.num_heads
        q4, q_shape = self._pool_packed(q, thw, self.pool_q, self.norm_q)
        kp, k_shape = self._pool_packed(k, thw, self.pool_k, self.norm_k)
        vp, _ = self._pool_packed(v, thw, self.pool_v, self.norm_v)
        rel = rel_projections_packed(q4, q_shape, k_shape, self.rel_pos_t, self.rel_pos_h,
                                     self.rel_pos_w)
        out = attention_rel_packed(q4.reshape(B, -1, C).contiguous(),
                                   kp.reshape(B, -1, C).contiguous(),
                                   vp.reshape(B, -1, C).contiguous(), rel.contiguous(),
                                   k_shape, H, (C // H) ** -0.5, residual=True)
        return self.proj(out), q_shape

    def forward(self, x: torch.Tensor, thw: Tuple[int, int, int]):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if self._packed_route(thw):
            return self._forward_packed(q, k, v, thw)
        q, q_shape = self._pool(q, thw, self.pool_q, self.norm_q)
        k, k_shape = self._pool(k, thw, self.pool_k, self.norm_k)
        v, _ = self._pool(v, thw, self.pool_v, self.norm_v)
        head = self.dim_out // self.num_heads
        tables = (self.rel_pos_t, self.rel_pos_h, self.rel_pos_w)
        if self.attn_relk:
            rel = rel_projections(q, q_shape, k_shape, *tables).contiguous()
            out = attention_rel(q, k, v, rel, k_shape, head ** -0.5)
        else:
            q_aug, k_aug = augment_for_attention(q, k, q_shape, k_shape, head ** -0.5, *tables)
            out = attention(q_aug, k_aug, v)
        out = out + q  # residual pooling
        B = x.shape[0]
        return self.proj(out.transpose(1, 2).reshape(B, -1, self.dim_out)), q_shape


def init_rel_pos_(model: nn.Module) -> None:
    """Draw the rel-pos tables of every MultiScaleAttention in `model` as the
    JAX package initialises them (truncated normal, std 0.02), in module
    order off a generator seeded 0. The encoders call it last in __init__."""
    gen = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, MultiScaleAttention):
            for t in (m.rel_pos_h, m.rel_pos_w, m.rel_pos_t):
                trunc_normal_(t, 0.02, gen)


class Mlp(nn.Module):
    """fc1 -> erf GELU -> fc2. The blocks run it with its LayerNorm through
    K2 (`ln_mlp_block`); called alone it is the plain chain, as the JAX
    package's `Mlp` is (reversible MViT's `MLPSubblock`)."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class MultiScaleBlock(nn.Module):
    """DIM_MUL_IN_ATT block: attention projects to dim_out; the skip path is
    proj(norm1(x)) max-pooled by the q stride."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, input_size, mlp_ratio: float,
                 qkv_bias: bool, kernel_q, kernel_kv, stride_q, stride_kv,
                 drop_path: float = 0.0, quant: str = "", attn_relk: bool = True,
                 attn_packed: bool = False, dwconv: bool = False):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.quant = quant
        self.drop_path = DropPath(drop_path)
        self.stride_q = tuple(stride_q)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, input_size, num_heads, qkv_bias,
                                        kernel_q, kernel_kv, stride_q, stride_kv,
                                        attn_relk, attn_packed, dwconv)
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
    4/8/16/32, T=8, tapped at blocks {0,2,13,15}. `quant`, the layout
    options and `remat` (each block recomputed in the backward pass when
    training) are `ModelConfig`'s."""

    def __init__(self, cfg: MViTConfig, quant: str = "", attn_relk: bool = True,
                 attn_packed: bool = False, dwconv: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
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
                c.qkv_bias, kernel, kernel, stride_q[i], stride_kv[i], dpr[i], quant,
                attn_relk, attn_packed, dwconv))
            if math.prod(stride_q[i]) > 1:
                input_size = [s // st for s, st in zip(input_size, stride_q[i])]
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)
        self.taps = tuple(c.out_indices)
        self.patch_embed = PatchEmbedMViT(c.patch_kernel, c.patch_stride,
                                          c.patch_padding, c.embed_dim)
        init_rel_pos_(self)

    def forward(self, x) -> List[torch.Tensor]:
        x, thw = self.patch_embed(x)
        feas = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            x, thw = checkpoint_block(blk, x, thw) if remat else blk(x, thw)
            if i in self.taps:
                feas.append(x.reshape(x.shape[0], *thw, -1))
        return feas
