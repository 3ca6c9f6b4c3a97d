"""VideoSwin-S video backbone: 3-D shifted-window attention.

Counterpart of `mspi_tpu/models/videoswin.py` (reference
backbones/video_swin_transformer.py, `SwinTransformer3D` as the reference
factory builds it): patch (2,4,4), embed 96, depths (2,2,18,2), heads
(3,6,12,24), window (8,7,7), qkv bias, no patch norm, no drop-path. The
pyramid is each stage's pre-downsample output: (96,192,384,768) at strides
4/8/16/32, T = 8.

Activations are channels-last [B,D,H,W,C]. Every block's window attention
runs through the window kernel (`window_attention`, TPU row 15; its
backward serves rows 16 and 17), and its norm2 + MLP through K2 (`ln_mlp`).
The relative-position bias is gathered from the table in plain PyTorch, so
its gradient is autograd's scatter-add. The shift mask and the
relative-position index are static for a feature shape: they are built in
numpy, as in the JAX package, and kept on the device (the index as a
buffer, each stage's mask in a per-stage cache keyed by shape, device and
dtype).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.config import VideoSwinConfig
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp
from mspi_tpu_torch.ops.kernels.window_attention import window_attention
from mspi_tpu_torch.ops.layers import Conv3d

Triple = Tuple[int, int, int]


@lru_cache(maxsize=64)
def _rel_pos_index(wd: int, wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position index into the bias table
    (video_swin_transformer.py:134-149)."""
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij"))  # [3, wd, wh, ww]
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@lru_cache(maxsize=64)
def _attn_mask(Dp: int, Hp: int, Wp: int, window_size: Triple,
               shift_size: Triple) -> np.ndarray:
    """Shifted-window attention mask (compute_mask,
    video_swin_transformer.py:333-346): [nW, N, N] of {0, -100}."""
    img = np.zeros((Dp, Hp, Wp))
    cnt = 0
    # exact torch slicing incl. the shift == 0 case, where slice(-0, None)
    # covers the whole axis (so the axis collapses to one region)
    for d in (slice(None, -window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(None, -window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(None, -window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img[d, h, w] = cnt
                cnt += 1
    win = _window_partition_np(img[None, ..., None], window_size)[..., 0]  # [nW, N]
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _window_partition_np(x, window_size):
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """[B,D,H,W,C] -> [B*nW, wd*wh*ww, C]."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window_size, B, D, H, W) -> torch.Tensor:
    wd, wh, ww = window_size
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def get_window_size(x_size, window_size, shift_size=None):
    """Clamp the window to the input size, zeroing shifts on clamped axes
    (video_swin_transformer.py:92-105)."""
    use_w = list(window_size)
    use_s = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_w[i] = x_size[i]
            if use_s is not None:
                use_s[i] = 0
    if use_s is None:
        return tuple(use_w)
    return tuple(use_w), tuple(use_s)


class WindowAttention3D(nn.Module):
    """W-MSA with a 3-D relative position bias
    (video_swin_transformer.py:108-190)."""

    def __init__(self, dim: int, window_size: Triple, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.window_size, self.num_heads = tuple(window_size), num_heads
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        idx = torch.from_numpy(_rel_pos_index(wd, wh, ww).astype(np.int64))
        self.register_buffer("rel_index", idx, persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        N = x.shape[1]
        qkv = self.qkv(x)  # [B_, N, 3C], lane order (3, head, D)
        # Bug-compatible with the reference (and the JAX package): the index
        # grid is always the configured window's, sliced [:N, :N], which
        # mis-addresses the table when the window is clamped on small inputs;
        # at 224x384 windows never clamp (only shifts zero out).
        idx = self.rel_index[:N, :N].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(N, N, -1).permute(2, 0, 1)
        bias = bias.to(qkv.dtype).contiguous()
        nw = 1 if mask is None else mask.shape[0]
        mask = None if mask is None else mask.to(qkv.dtype)
        return self.proj(window_attention(qkv, bias, mask, self.num_heads, nw))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinTransformerBlock3D(nn.Module):
    """(Shifted-)window attention block (video_swin_transformer.py:193-293);
    LayerNorm eps 1e-5."""

    def __init__(self, dim: int, num_heads: int, window_size: Triple = (2, 7, 7),
                 shift_size: Triple = (0, 0, 0), mlp_ratio: float = 4.0, qkv_bias: bool = True):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention3D(dim, self.window_size, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _attention_part(self, x, mask):
        B, D, H, W, C = x.shape
        window_size, shift_size = get_window_size((D, H, W), self.window_size, self.shift_size)
        x = self.norm1(x)
        pad_d = (window_size[0] - D % window_size[0]) % window_size[0]
        pad_b = (window_size[1] - H % window_size[1]) % window_size[1]
        pad_r = (window_size[2] - W % window_size[2]) % window_size[2]
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d))
        _, Dp, Hp, Wp, _ = x.shape
        shifted = any(s > 0 for s in shift_size)
        if shifted:
            x = torch.roll(x, tuple(-s for s in shift_size), dims=(1, 2, 3))
        windows = window_partition(x, window_size)
        attn_windows = self.attn(windows, mask if shifted else None)
        x = window_reverse(attn_windows, window_size, B, Dp, Hp, Wp)
        if shifted:
            x = torch.roll(x, shift_size, dims=(1, 2, 3))
        if pad_d or pad_b or pad_r:
            x = x[:, :D, :H, :W]
        return x

    def forward(self, x, mask):
        x = x + self._attention_part(x, mask)
        C = x.shape[-1]
        y = ln_mlp(x.reshape(-1, C).contiguous(), self.norm2.weight, self.norm2.bias,
                   self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight,
                   self.mlp.fc2.bias, self.norm2.eps)
        return x + y.reshape(x.shape)


class PatchMerging(nn.Module):
    """2x2 spatial merge: concat 4 neighbours -> LN -> Linear 4C -> 2C
    (video_swin_transformer.py:296-329)."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)

    def forward(self, x):
        H, W = x.shape[2:4]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One Swin stage (video_swin_transformer.py:349-431); returns
    (downsampled, pre-downsample). Odd blocks shift by half a window."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Triple,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, has_downsample: bool = True):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift = tuple(w // 2 for w in self.window_size)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock3D(dim, num_heads, self.window_size,
                                   (0, 0, 0) if i % 2 == 0 else self.shift, mlp_ratio, qkv_bias)
            for i in range(depth)])
        if has_downsample:
            self.downsample = PatchMerging(dim)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, x: torch.Tensor) -> torch.Tensor:
        """The stage's static shift mask [nW, N, N] on x's device and dtype."""
        D, H, W = x.shape[1:4]
        window_size, shift_size = get_window_size((D, H, W), self.window_size, self.shift)
        Dp, Hp, Wp = (-(-s // w) * w for s, w in zip((D, H, W), window_size))
        key = (Dp, Hp, Wp, window_size, shift_size, x.device, x.dtype)
        if key not in self._masks:
            mask = _attn_mask(Dp, Hp, Wp, window_size, shift_size)
            self._masks[key] = torch.from_numpy(mask).to(x.device, x.dtype)
        return self._masks[key]

    def forward(self, x):
        mask = self._mask(x)
        for blk in self.blocks:
            x = blk(x, mask)
        if hasattr(self, "downsample"):
            return self.downsample(x), x
        return x, x


class PatchEmbed3D(nn.Module):
    """(2,4,4) patchify conv, no norm (video_swin_transformer.py:434-473)."""

    def __init__(self, patch_size: Triple, embed_dim: int):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = Conv3d(3, embed_dim, self.patch_size, self.patch_size, 0)

    def forward(self, x):
        pads = [(p - s % p) % p for s, p in zip(x.shape[1:4], self.patch_size)]
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        return self.proj(x)


class VideoSwinFeatures(nn.Module):
    """[B,16,H,W,3] normalised clip -> pre-downsample pyramid
    (96,192,384,768), T = 8."""

    def __init__(self, cfg: VideoSwinConfig):
        super().__init__()
        c = cfg
        self.patch_embed = PatchEmbed3D(c.patch_size, c.embed_dim)
        self.layers = nn.ModuleList([
            BasicLayer(dim=int(c.embed_dim * 2 ** i), depth=c.depths[i],
                       num_heads=c.num_heads[i], window_size=c.window_size,
                       mlp_ratio=c.mlp_ratio, qkv_bias=c.qkv_bias,
                       has_downsample=i < len(c.depths) - 1)
            for i in range(len(c.depths))])

    def forward(self, x) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        features = []
        for layer in self.layers:
            x, pre = layer(x)
            features.append(pre)
        return features
