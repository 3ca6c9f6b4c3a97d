"""Channels-last layers with the JAX package's numerics.

Counterpart of `mspi_tpu/ops/layers.py`. Activations stay channels-last as
in the JAX package ([B,T,H,W,C] video, [B,H,W,C] images); the conv, norm and
pool modules here subclass or wrap the torch modules of the reference, so
parameter and buffer names are the reference's and its state dicts load
unchanged. A conv runs on the permuted view of a channels-last tensor, which
is torch's channels_last(_3d) memory format, so no layout copy is made.

Numerics (as in the JAX package): erf GELU (`F.gelu`); LayerNorm eps 1e-5
unless a module says 1e-6; BatchNorm with running statistics in eval mode and
flax's batch statistics in train mode (see `BatchNorm`); max pooling pads
with -inf; linear resizes are half-pixel (`align_corners=False`) without
antialias. `DropPath` draws its per-sample masks from an explicit
`torch.Generator`, and `checkpoint_block` recomputes a block in the
backward pass with the masks of its forward.

Initialisers take an explicit `torch.Generator` and mirror the JAX
package's: torch's kaiming-uniform default for convs and linears,
truncated normal where the JAX module asks for it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mspi_tpu_torch.data.video import IMAGENET_MEAN, IMAGENET_STD

IntOrTuple = Union[int, Sequence[int]]


def _to_ncl(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _to_cl(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


class Conv3d(nn.Conv3d):
    """nn.Conv3d on channels-last [B,T,H,W,C] tensors. A grouped conv gets
    NCDHW-contiguous input: cuDNN runs channels-last grouped 3-D convs as
    one launch per group."""

    def forward(self, x):
        x = _to_ncl(x)
        if self.groups > 1:
            x = x.contiguous()
        return _to_cl(super().forward(x))


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last [B,H,W,C] tensors."""

    def forward(self, x):
        return _to_cl(super().forward(_to_ncl(x)))


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the trailing channel axis (torch BatchNorm{1,2,3}d
    state-dict names). Eval mode normalises with the running statistics.
    Train mode follows the JAX package's flax BatchNorm rather than torch:
    fp32 batch statistics with the fast biased variance E[x^2] - mean^2
    (clipped at 0), used both to normalise and to update the running
    variance (torch would update it with the unbiased one), and
    running = (1 - momentum) * running + momentum * batch with the module's
    own torch-convention momentum."""

    def forward(self, x):
        if not self.training:
            return _to_cl(F.batch_norm(_to_ncl(x), self.running_mean, self.running_var,
                                       self.weight, self.bias, False, 0.0, self.eps))
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dims)
        var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach().to(self.running_mean.dtype),
                                                 alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach().to(self.running_var.dtype),
                                                alpha=m)
            self.num_batches_tracked.add_(1)
        y = (xf - mean) * (self.weight.float() * torch.rsqrt(var + self.eps)) + self.bias.float()
        return y.to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample (`mspi_tpu.ops.layers.DropPath`): in
    train mode with rate > 0, each sample of the batch is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed. The
    masks come from `generator`, a CPU `torch.Generator` that the trainer
    sets (so a run is reproducible on any device)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in train mode needs a generator "
                               "(mspi_tpu_torch.train.engine sets it)")
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],), generator=self.generator) < keep
        mask = mask.to(x.device, non_blocking=True).view(-1, *([1] * (x.dim() - 1)))
        return torch.where(mask, x / keep, torch.zeros_like(x))


def checkpoint_block(block: nn.Module, *args):
    """block(*args) with its forward recomputed in the backward pass
    (`torch.utils.checkpoint`, non-reentrant, as the JAX package's nn.remat
    per block). The recompute runs the whole block (no early stop), so each
    of its kernels launches exactly twice a step. The checkpoint restores
    only the default generators, so the block's DropPath generators are
    restored here: the recompute draws the forward's masks from the states
    they had at the forward, and leaves each generator where the forward
    had left it."""
    gens = []
    for m in block.modules():
        if isinstance(m, DropPath) and m.generator is not None and \
                not any(g is m.generator for g in gens):
            gens.append(m.generator)
    at_forward = []

    @contextlib.contextmanager
    def forward_context():
        at_forward[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_context():
        after = [g.get_state() for g in gens]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, after):
                g.set_state(state)

    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            block, *args, use_reentrant=False,
            context_fn=lambda: (forward_context(), recompute_context()))


def max_pool(x: torch.Tensor, kernel_size: IntOrTuple, stride: IntOrTuple = None,
             padding: IntOrTuple = 0) -> torch.Tensor:
    """torch MaxPool2d/3d (-inf padding, floor sizing) on channels-last x."""
    pool = F.max_pool3d if x.dim() == 5 else F.max_pool2d
    return _to_cl(pool(_to_ncl(x), kernel_size, stride, padding))


class MaxPool(nn.Module):
    def __init__(self, kernel_size: IntOrTuple, stride: IntOrTuple = None,
                 padding: IntOrTuple = 0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x):
        return max_pool(x, self.kernel_size, self.stride, self.padding)


def resize_scale(x: torch.Tensor, scale: Sequence[float]) -> torch.Tensor:
    """Half-pixel linear resize of the leading spatial axes of a
    channels-last tensor by per-axis factors (torch nn.Upsample,
    align_corners=False)."""
    if all(s == 1 for s in scale):
        return x
    if len(scale) == 3 and scale[0] == 1:
        # (1, s, s) on video: 2-D bilinear over [B*T, H, W, C] (the time
        # axis maps onto itself exactly), which has an NHWC kernel
        B, T = x.shape[:2]
        y = resize_scale(x.reshape(B * T, *x.shape[2:]), scale[1:])
        return y.reshape(B, T, *y.shape[1:])
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(scale)]
    y = F.interpolate(_to_ncl(x), scale_factor=tuple(float(s) for s in scale),
                      mode=mode, align_corners=False)
    return _to_cl(y)


def resize_to(x: torch.Tensor, sizes: Sequence[int], axes: Sequence[int]) -> torch.Tensor:
    """Linear resize of a channels-last tensor's spatial axes `axes` (1, 2,
    ... in order) to `sizes`: `jax.image.resize(..., "linear",
    antialias=False)`, which is half-pixel linear interpolation, as
    `F.interpolate(..., align_corners=False)` computes it."""
    if tuple(axes) != tuple(range(1, 1 + len(axes))):
        raise ValueError(f"resize_to takes the leading spatial axes, not {tuple(axes)}")
    if tuple(x.shape[1:1 + len(axes)]) == tuple(sizes):
        return x
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(axes)]
    ncl = _to_ncl(x.reshape(*x.shape[:1 + len(axes)], -1))
    y = F.interpolate(ncl, size=tuple(int(s) for s in sizes), mode=mode, align_corners=False)
    return _to_cl(y).reshape(x.shape[0], *sizes, *x.shape[1 + len(axes):])


class Upsample(nn.Module):
    """nn.Upsample(scale, trilinear/bilinear, align_corners=False) on
    channels-last tensors; `scale` is per leading spatial axis."""

    def __init__(self, scale: Sequence[float]):
        super().__init__()
        self.scale = tuple(scale)

    def forward(self, x):
        return resize_scale(x, self.scale)


def adaptive_avg_pool(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """AdaptiveAvgPool to (1,...,1) on channels-last x, keeping dims."""
    return x.mean(dim=tuple(range(1, 1 + ndim)), keepdim=True)


def normalize_frames(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 RGB -> ImageNet-normalised `dtype` on x's device; float input is
    taken as already normalised (the JAX stems fold the same affine into
    their weights for uint8 input and pass float input through)."""
    if x.dtype == torch.uint8:
        mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
        std = torch.from_numpy(IMAGENET_STD).to(x.device)
        x = (x.float() / 255.0 - mean) / std
    return x.to(dtype)


# ---------------------------------------------------------------- init


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=gen))


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Normal(0, std) truncated to +-2 std (timm trunc_normal_), by
    inverse-CDF sampling."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.empty(t.shape, dtype=torch.float64).uniform_(lo, hi, generator=gen)
    with torch.no_grad():
        t.copy_(torch.special.ndtri(u) * std)


def xavier_uniform_(t: torch.Tensor, gen: torch.Generator) -> None:
    fan_out, fan_in = t.shape[0], t.shape[1]
    uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def torch_default_init_(m: nn.Module, gen: torch.Generator) -> None:
    """torch's Conv/Linear default: U(+-1/sqrt(fan_in)) for weight and bias."""
    w = m.weight
    fan_in = w[0].numel()
    bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.0
    uniform_(w, bound, gen)
    if getattr(m, "bias", None) is not None:
        uniform_(m.bias, bound, gen)


def init_default(model: nn.Module, gen: torch.Generator) -> None:
    """Draw every Conv/Linear of `model` with torch's default scheme from
    `gen`, in module order. Norm layers keep their constructor values
    (weight 1, bias 0, running mean 0, var 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            torch_default_init_(m, gen)

