"""Reversible MViT encoder (Reversible Vision Transformers, CVPR 2022).

Counterpart of `mspi_tpu/models/reversible_mvit.py` (reference
backbones/MViT.py:223-900): two-stream `ReversibleBlock`s (Y1 = X1 + F(X2),
Y2 = X2 + G(Y1), F pooled attention, G an MLP), `StageTransitionBlock`s at
the Q-pooling and width boundaries (the streams fused by their average, a
pooled residual), and `reversible_sequence`, whose backward rebuilds each
block's inputs from its outputs instead of storing activations (RevBackProp,
MViT.py:394-489).

F runs MViT's `MultiScaleAttention`, so K1 (`attention_rel`) in the forward
and row 5 in the backward; G is MViT's `Mlp` after a LayerNorm of its own,
plain PyTorch as in the JAX package. Module names are the flax scopes
(`blocks.{i}.F.attn.*`, `blocks.{i}.G.mlp.*`).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.models.mvit import (Mlp, MultiScaleAttention, PatchEmbedMViT, init_rel_pos_,
                                        round_width)


class MLPSubblock(nn.Module):
    """G: pre-LN MLP (MViT.py:823-847)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x):
        return self.mlp(self.norm(x))


class AttentionSubBlock(nn.Module):
    """F: pre-LN pooled attention (MViT.py:850-902)."""

    def __init__(self, dim: int, dim_out: int, input_size, num_heads: int, qkv_bias: bool,
                 kernel_q, kernel_kv, stride_q, stride_kv):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, input_size, num_heads, qkv_bias,
                                        kernel_q, kernel_kv, stride_q, stride_kv)

    def forward(self, x, thw):
        return self.attn(self.norm(x), thw)


class ReversibleBlock(nn.Module):
    """Y1 = X1 + F(X2); Y2 = X2 + G(Y1) (MViT.py:642-756). Shapes are
    preserved: no q pooling or width change inside a reversible block."""

    def __init__(self, dim: int, input_size, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 kernel_q, kernel_kv, stride_kv):
        super().__init__()
        self.F = AttentionSubBlock(dim, dim, input_size, num_heads, qkv_bias, kernel_q,
                                   kernel_kv, (1, 1, 1), stride_kv)
        self.G = MLPSubblock(dim, mlp_ratio)

    def forward(self, x1, x2, thw):
        y1 = x1 + self.f_part(x2, thw)
        y2 = x2 + self.g_part(y1)
        return y1, y2

    def f_part(self, x, thw):
        return self.F(x, thw)[0]

    def g_part(self, x):
        return self.G(x)


class StageTransitionBlock(nn.Module):
    """Irreversible Q-pooling transition (MViT.py:491-640): the two streams
    fused by their average, a residual projected (when the width changes)
    and pooled by F's q-pooling conv and its norm, F then G with plain
    residuals; the output is both streams."""

    def __init__(self, dim: int, dim_out: int, input_size, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, kernel_q, kernel_kv, stride_q, stride_kv):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.F = AttentionSubBlock(dim, dim_out, input_size, num_heads, qkv_bias, kernel_q,
                                   kernel_kv, stride_q, stride_kv)
        self.G = MLPSubblock(dim_out, mlp_ratio)
        if dim != dim_out:
            self.res_proj = nn.Linear(dim, dim_out)

    def forward(self, x1, x2, thw):
        x = (x1 + x2) * 0.5  # TwoStreamFusion 'avg' (MViT.py:86-127)
        x_res = self.res_proj(x) if self.dim != self.dim_out else x
        # the conv res path (REV.RES_PATH 'conv'): F's q-pooling conv per
        # head, with its post-pool norm
        attn = self.F.attn
        xr, _ = attn._pool(x_res, thw, attn.pool_q, attn.norm_q)  # [B, H, N', D]
        x_res = xr.transpose(1, 2).reshape(x.shape[0], -1, self.dim_out)
        f_x, new_thw = self.F(x, thw)
        y = x_res + f_x
        y = y + self.G(y)
        return y, y, new_thw  # streams re-split as equal copies


class _ReversibleSequence(torch.autograd.Function):
    """The span's forward without a graph, keeping only its outputs; the
    backward inverts the blocks in reverse, x2 = y2 - G(y1), x1 = y1 -
    F(x2), recomputing each sub-block with grad on and taking its input and
    parameter gradients with `torch.autograd.grad`. The forward's autocast
    state is restored around the recompute."""

    @staticmethod
    def forward(ctx, x1, x2, thw, blocks, *params):
        ctx.thw, ctx.blocks = thw, blocks
        ctx.autocast = (x1.device.type, torch.is_autocast_enabled(x1.device.type),
                        torch.get_autocast_dtype(x1.device.type))
        with torch.no_grad():
            for blk in blocks:
                x1 = x1 + blk.f_part(x2, thw)
                x2 = x2 + blk.g_part(x1)
        ctx.save_for_backward(x1, x2)
        return x1, x2

    @staticmethod
    def backward(ctx, dy1, dy2):
        y1, y2 = ctx.saved_tensors
        device, enabled, dtype = ctx.autocast
        grads = []
        for blk in reversed(ctx.blocks):
            f_params = [p for p in blk.F.parameters() if p.requires_grad]
            g_params = [p for p in blk.G.parameters() if p.requires_grad]
            with torch.enable_grad(), torch.autocast(device, dtype=dtype, enabled=enabled):
                y1_in = y1.detach().requires_grad_(True)
                g_y1 = blk.g_part(y1_in)
            dg = torch.autograd.grad(g_y1, [y1_in] + g_params, dy2.to(g_y1.dtype),
                                     allow_unused=True)
            x2 = (y2 - g_y1).detach()
            dy1 = dy1 + dg[0]
            with torch.enable_grad(), torch.autocast(device, dtype=dtype, enabled=enabled):
                x2_in = x2.detach().requires_grad_(True)
                f_x2 = blk.f_part(x2_in, ctx.thw)
            df = torch.autograd.grad(f_x2, [x2_in] + f_params, dy1.to(f_x2.dtype),
                                     allow_unused=True)
            x1 = (y1 - f_x2).detach()
            dy2 = dy2 + df[0]
            named = dict(zip(map(id, f_params + g_params), list(df[1:]) + list(dg[1:])))
            grads.append([named.get(id(p)) for p in blk.parameters()])
            y1, y2 = x1, x2
        flat = [g for block_grads in reversed(grads) for g in block_grads]
        return (dy1, dy2, None, None, *flat)


def reversible_sequence(blocks: Sequence[ReversibleBlock], x1: torch.Tensor, x2: torch.Tensor,
                        thw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a span of same-shape ReversibleBlocks with the O(1)-activation
    backward of `_ReversibleSequence` (RevBackProp, MViT.py:394-489): the
    gradients of x1, x2 and of every block parameter, as plain autograd
    through the blocks would give them."""
    blocks = list(blocks)
    params = [p for blk in blocks for p in blk.parameters()]
    return _ReversibleSequence.apply(x1, x2, tuple(thw), blocks, *params)


class ReversibleMViTFeatures(nn.Module):
    """Reversible MViTv2-S encoder: the MViTFeatures schedule with
    ReversibleBlocks between the transitions; [B,T,H,W,3] -> the fused
    streams' mean token, normed, [B, 2 * C] (the reference classifier path,
    MViT.py:1993-2006). Its forward is plain autograd; `reversible_sequence`
    over a span of its `blocks` is the O(1)-activation backward. The rel-pos
    tables are drawn as MViTFeatures draws them (`init_rel_pos_`)."""

    def __init__(self, cfg: MViTConfig):
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
        kernel = tuple(c.pool_kvq_kernel)
        stride_kv = []
        skv = list(c.pool_kv_stride_adaptive)
        for i in range(depth):
            skv = [max(skv[d] // stride_q[i][d], 1) for d in range(3)]
            stride_kv.append(tuple(skv))
        # The attention's input_size (which sizes the rel-pos tables) is
        # 16x224x224 whatever the clip's size: the reference's behaviour.
        input_size = [16 // c.patch_stride[0], 224 // c.patch_stride[1],
                      224 // c.patch_stride[2]]
        embed_dim, num_heads = c.embed_dim, c.num_heads
        blocks, kinds = [], []
        for i in range(depth):
            num_heads = round_width(num_heads, head_mul[i])
            dim_out = round_width(embed_dim, dim_mul[i],
                                  divisor=round_width(num_heads, head_mul[i]))
            if dim_out != embed_dim or math.prod(stride_q[i]) > 1:
                blocks.append(StageTransitionBlock(
                    embed_dim, dim_out, tuple(input_size), num_heads, c.mlp_ratio, c.qkv_bias,
                    kernel, kernel, tuple(stride_q[i]), stride_kv[i]))
                kinds.append("transition")
            else:
                blocks.append(ReversibleBlock(
                    embed_dim, tuple(input_size), num_heads, c.mlp_ratio, c.qkv_bias, kernel,
                    kernel, stride_kv[i]))
                kinds.append("rev")
            if math.prod(stride_q[i]) > 1:
                input_size = [s // st for s, st in zip(input_size, stride_q[i])]
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)
        self.kinds = tuple(kinds)
        self.patch_embed = PatchEmbedMViT(c.patch_kernel, c.patch_stride, c.patch_padding,
                                          c.embed_dim)
        self.norm = nn.LayerNorm(2 * embed_dim, eps=1e-6)
        init_rel_pos_(self)

    def forward(self, clips):
        x, thw = self.patch_embed(clips)
        x1 = x2 = x  # stream duplication
        for blk, kind in zip(self.blocks, self.kinds):
            if kind == "transition":
                x1, x2, thw = blk(x1, x2, thw)
            else:
                x1, x2 = blk(x1, x2, thw)
        # RESPATH_FUSE 'concat' + mean-pool + norm (MViT.py:1993-2006)
        return self.norm(torch.cat([x1, x2], dim=-1).mean(dim=1))
