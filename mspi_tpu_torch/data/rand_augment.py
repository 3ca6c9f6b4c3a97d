"""RandAugment, colour jitter and PCA lighting for video clips. Counterpart
of `mspi_tpu/data/rand_augment.py` (reference SlowFast/slowfast/datasets/
rand_augment.py, the timm-derived op set with magnitude noise, and
cv2_transform.py color_jitter/lighting_list).

Every op takes a float clip [T, H, W, 3] in [0, 1] on any device and keeps
it in [0, 1]. The random draws come from an explicit CPU `torch.Generator`
(the JAX functions take a key), so they differ from JAX's; at fixed
arguments each op computes what the JAX op computes, quirks included:
- the geometric ops sample bilinearly and fill with 0.5 outside the frame;
- `equalize` truncates clip * 255 toward zero and builds 256 bins per
  channel over the whole clip;
- `sharpness` blurs with a zero-padded 3x3 convolution, so the border is
  not left as PIL leaves it;
- saturation and sharpness take their sign from the same draw.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

_FILL = 0.5  # PIL fillcolor (128, 128, 128) / 255


# ------------------------------------------------------------- geometric ops

def _affine_sample(clip: torch.Tensor, mat) -> torch.Tensor:
    """Apply the inverse affine map `mat` [2, 3] to every frame, about the
    frame's centre, with bilinear sampling."""
    T, H, W, C = clip.shape
    mat = torch.as_tensor(mat, dtype=torch.float32, device=clip.device)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=clip.device),
                            torch.arange(W, dtype=torch.float32, device=clip.device),
                            indexing="ij")
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    sx = mat[0, 0] * (xs - cx) + mat[0, 1] * (ys - cy) + mat[0, 2] + cx
    sy = mat[1, 0] * (xs - cx) + mat[1, 1] * (ys - cy) + mat[1, 2] + cy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        vals = clip[:, yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return torch.where(inside[None, :, :, None], vals, torch.full_like(vals, _FILL))

    w00 = ((1 - wy) * (1 - wx))[None, :, :, None]
    w01 = ((1 - wy) * wx)[None, :, :, None]
    w10 = (wy * (1 - wx))[None, :, :, None]
    w11 = (wy * wx)[None, :, :, None]
    return (gather(y0, x0) * w00 + gather(y0, x0 + 1) * w01 + gather(y0 + 1, x0) * w10
            + gather(y0 + 1, x0 + 1) * w11)


def _identity():
    return [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]


def rotate(clip, degrees):
    rad = torch.tensor(-float(degrees) * math.pi / 180.0, dtype=torch.float32)  # inverse map
    c, s = torch.cos(rad).item(), torch.sin(rad).item()
    return _affine_sample(clip, [[c, -s, 0.0], [s, c, 0.0]])


def shear_x(clip, factor):
    mat = _identity()
    mat[0][1] = float(factor)
    return _affine_sample(clip, mat)


def shear_y(clip, factor):
    mat = _identity()
    mat[1][0] = float(factor)
    return _affine_sample(clip, mat)


def translate_x(clip, frac):
    mat = _identity()
    mat[0][2] = float(frac) * clip.shape[2]
    return _affine_sample(clip, mat)


def translate_y(clip, frac):
    mat = _identity()
    mat[1][2] = float(frac) * clip.shape[1]
    return _affine_sample(clip, mat)


# ----------------------------------------------------------------- pixel ops

def _blend(a, b, factor):
    return torch.clamp(b + factor * (a - b), 0.0, 1.0)


def _grayscale(clip):
    w = torch.tensor([0.299, 0.587, 0.114], dtype=clip.dtype, device=clip.device)
    return torch.sum(clip * w, dim=-1, keepdim=True)


def brightness(clip, factor):
    return _blend(clip, torch.zeros_like(clip), factor)


def contrast(clip, factor):
    mean = torch.mean(_grayscale(clip), dim=(1, 2, 3), keepdim=True)
    return _blend(clip, mean.expand(clip.shape), factor)


def saturation(clip, factor):  # "color" in timm
    return _blend(clip, _grayscale(clip).expand(clip.shape), factor)


def posterize(clip, bits):
    levels = 2.0 ** float(bits)
    q = torch.floor(clip * 255.0 / 256.0 * levels) / levels * 256.0 / 255.0
    return torch.clamp(q, 0.0, 1.0)


def solarize(clip, thresh):
    return torch.where(clip >= thresh, 1.0 - clip, clip)


def solarize_add(clip, add, thresh: float = 128.0 / 255.0):
    return torch.where(clip < thresh, torch.clamp(clip + add, 0.0, 1.0), clip)


def invert(clip, _=None):
    return 1.0 - clip


def autocontrast(clip, _=None):
    lo = clip.amin(dim=(0, 1, 2), keepdim=True)
    hi = clip.amax(dim=(0, 1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / torch.clamp_min(hi - lo, 1e-6), torch.ones_like(hi))
    return torch.clamp((clip - lo) * scale, 0.0, 1.0)


def equalize(clip, _=None):
    """Per-channel histogram equalisation over the whole clip (256 bins)."""
    def eq_channel(ch):
        vals = torch.clamp(ch * 255.0, 0, 255).to(torch.int64)  # truncates toward 0
        hist = torch.bincount(vals.reshape(-1), minlength=256).to(torch.float32)
        cdf = torch.cumsum(hist, 0)
        cdf_min = cdf[torch.argmax((hist > 0).to(torch.int32))]
        denom = torch.clamp_min(cdf[-1] - cdf_min, 1.0)
        lut = torch.clamp((cdf - cdf_min) / denom, 0.0, 1.0)
        return lut[vals]

    return torch.stack([eq_channel(clip[..., c]) for c in range(clip.shape[-1])], dim=-1)


def sharpness(clip, factor):
    k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32,
                     device=clip.device) / 13.0
    T, H, W, C = clip.shape
    x = clip.permute(0, 3, 1, 2).reshape(T * C, 1, H, W)
    blurred = F.conv2d(x, k[None, None].to(clip.dtype), padding=1)
    blurred = blurred.reshape(T, C, H, W).permute(0, 2, 3, 1)
    return _blend(clip, blurred, 1.0 - (1.0 - factor))  # factor blends toward sharp


# -------------------------------------------------------------- rand augment

def _ops(signs: Sequence[bool], m: float):
    """(name, fn, arg) per op at magnitude m in [0, 10] (rand_augment.py's
    _LEVEL_TO_ARG); signs[i] keeps the i-th signed argument's sign, and
    saturation and sharpness share signs[7]."""
    def neg(i, v):
        return v if signs[i] else -v

    return [
        ("rotate", rotate, neg(0, m / 10.0 * 30.0)),
        ("shear_x", shear_x, neg(1, m / 10.0 * 0.3)),
        ("shear_y", shear_y, neg(2, m / 10.0 * 0.3)),
        ("translate_x", translate_x, neg(3, m / 10.0 * 0.45)),
        ("translate_y", translate_y, neg(4, m / 10.0 * 0.45)),
        ("brightness", brightness, 1.0 + neg(5, m / 10.0 * 0.9)),
        ("contrast", contrast, 1.0 + neg(6, m / 10.0 * 0.9)),
        ("saturation", saturation, 1.0 + neg(7, m / 10.0 * 0.9)),
        ("sharpness", sharpness, 1.0 + neg(7, m / 10.0 * 0.9)),
        ("posterize", posterize, 8.0 - m / 10.0 * 4.0),
        ("solarize", solarize, 1.0 - m / 10.0),
        ("autocontrast", autocontrast, 0.0),
        ("equalize", equalize, 0.0),
        ("invert", invert, 0.0),
    ]


def rand_augment_clip(gen: torch.Generator, clip: torch.Tensor, num_layers: int = 2,
                      magnitude: int = 9, mag_std: float = 0.5) -> torch.Tensor:
    """rand-m{magnitude}-n{num_layers}-mstd{mag_std} on one [T,H,W,3] clip
    in [0,1]: the magnitude drawn once with its noise and clipped to
    [0, 10], the eight signs, then `num_layers` ops chosen uniformly."""
    m = min(max(magnitude + mag_std * torch.randn((), generator=gen).item(), 0.0), 10.0)
    ops = _ops((torch.rand(8, generator=gen) < 0.5).tolist(), m)
    for _ in range(num_layers):
        _, fn, arg = ops[int(torch.randint(len(ops), (), generator=gen))]
        clip = fn(clip, arg)
    return clip


def rand_augment_batch(gen: torch.Generator, clips: torch.Tensor, num_layers: int = 2,
                       magnitude: int = 9, mag_std: float = 0.5) -> torch.Tensor:
    """`rand_augment_clip` on each clip of [B,T,H,W,3], each with its own
    draws."""
    return torch.stack([rand_augment_clip(gen, c, num_layers, magnitude, mag_std)
                        for c in clips])


def color_jitter_batch(gen: torch.Generator, clips: torch.Tensor,
                       img_brightness: float = 0.4, img_contrast: float = 0.4,
                       img_saturation: float = 0.4) -> torch.Tensor:
    """cv2_transform.py color_jitter_list: per clip, the three jitters in
    random order with uniform factors in [1 - x, 1 + x]."""
    out = []
    for clip in clips:
        u = torch.rand(3, generator=gen).tolist()
        factors = [1 - x + 2 * x * ui for x, ui in
                   zip((img_brightness, img_contrast, img_saturation), u)]
        fns = (brightness, contrast, saturation)
        for i in torch.randperm(3, generator=gen).tolist():
            clip = fns[i](clip, factors[i])
        out.append(clip)
    return torch.stack(out)


def lighting_batch(gen: torch.Generator, clips: torch.Tensor, eigval, eigvec,
                   alphastd: float = 0.1) -> torch.Tensor:
    """cv2_transform.py lighting_list: PCA lighting noise per clip."""
    B = clips.shape[0]
    alpha = (alphastd * torch.randn((B, 3), generator=gen)).to(clips.device)
    eigval = torch.as_tensor(eigval, dtype=torch.float32, device=clips.device)
    eigvec = torch.as_tensor(eigvec, dtype=torch.float32, device=clips.device)
    delta = (eigvec[None] * (alpha * eigval[None])[:, None, :]).sum(-1)  # [B, 3]
    return torch.clamp(clips + delta[:, None, None, None, :], 0.0, 1.0)
