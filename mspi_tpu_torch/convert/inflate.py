"""Weight inflation and interpolation on the port's state dicts.
Counterpart of `mspi_tpu/convert/inflate.py` (reference: 2D->3D conv
inflation, uniformer.py:421-431 inflate_weight,
video_swin_transformer.py:608-657 inflate_weights, SlowFast
checkpoint.py:152-190; positional-embedding interpolation for a resolution
transfer, utils/optim.py:64-80 interpolate_embeddings, MViT.py:207-220
get_rel_pos).

Torch layouts: conv weights [O, I, kh, kw] and [O, I, kt, kh, kw], position
embeddings [1, N, C], rel-pos tables [L, C]. The resizes are linear with
half-pixel centres and no antialiasing (`F.interpolate(...,
align_corners=False)`), which is what the JAX functions' `jax.image.resize(
..., "linear", antialias=False)` computes, up- and downsampling alike.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def inflate_conv2d_to_3d(weight_2d: torch.Tensor, time_dim: int,
                         center: bool = False) -> torch.Tensor:
    """[O, I, kh, kw] -> [O, I, kt, kh, kw]. center=False: repeated over
    time and divided by kt (I3D's mean-preserving inflation, the UniFormer
    default); center=True: the 2D kernel at the middle temporal tap, zeros
    elsewhere."""
    o, i, kh, kw = weight_2d.shape
    if center:
        out = weight_2d.new_zeros((o, i, time_dim, kh, kw))
        out[:, :, time_dim // 2] = weight_2d
        return out
    return weight_2d[:, :, None].expand(o, i, time_dim, kh, kw) / time_dim


def interpolate_pos_embed(pos_embed: torch.Tensor, new_len: int,
                          num_prefix_tokens: int = 1) -> torch.Tensor:
    """[1, P + prefix, C] -> [1, new_len + prefix, C]: the prefix tokens
    kept, the sqrt(P) x sqrt(P) grid resized bilinearly to sqrt(new_len)
    per side (utils/optim.py:64-80)."""
    prefix = pos_embed[:, :num_prefix_tokens]
    grid = pos_embed[:, num_prefix_tokens:]
    p = grid.shape[1]
    old_side, new_side = int(math.sqrt(p)), int(math.sqrt(new_len))
    if old_side * old_side != p or new_side * new_side != new_len:
        raise ValueError(f"{p} -> {new_len} tokens: both must be square grids")
    grid = grid.reshape(1, old_side, old_side, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid.float(), size=(new_side, new_side), mode="bilinear",
                         align_corners=False, antialias=False).to(pos_embed.dtype)
    return torch.cat([prefix, grid.permute(0, 2, 3, 1).reshape(1, new_len, -1)], dim=1)


def interpolate_rel_pos(rel_pos: torch.Tensor, new_len: int) -> torch.Tensor:
    """[L, C] -> [new_len, C] by linear interpolation (MViT get_rel_pos);
    the same tensor when L is new_len already."""
    if rel_pos.shape[0] == new_len:
        return rel_pos
    out = F.interpolate(rel_pos.T[None].float(), size=new_len, mode="linear",
                        align_corners=False)
    return out[0].T.to(rel_pos.dtype)


def inflate_swin2d(state_dict: Dict[str, torch.Tensor], patch_t: int,
                   window_t: int) -> Dict[str, torch.Tensor]:
    """Swin-2D -> Video Swin on a state dict (video_swin_transformer.py:
    608-657): every 4-D weight of a module named `proj` (the patch
    embedding's conv) repeated over time and divided by patch_t, every
    relative-position bias table tiled (2 window_t - 1) times over its
    rows. Returns a new dict."""
    out = dict(state_dict)
    for key, value in state_dict.items():
        if key.split(".")[-2:] == ["proj", "weight"] and value.dim() == 4:
            out[key] = inflate_conv2d_to_3d(value, patch_t)
        elif key.endswith("relative_position_bias_table"):
            out[key] = value.repeat(2 * window_t - 1, 1)
    return out
