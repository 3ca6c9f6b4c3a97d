"""Sub-BatchNorm and synchronised BatchNorm. Counterpart of
`mspi_tpu/ops/subbn.py` (reference SlowFast/slowfast/models/
batchnorm_helper.py: SubBatchNorm3d and NaiveSyncBatchNorm).

Layout: channels-last, as the JAX modules and the port's `BatchNorm`: the
statistics are per channel of the last axis, over every other axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from mspi_tpu_torch.ops.layers import BatchNorm


class SubBatchNorm(nn.Module):
    """In training, each of `num_splits` sub-batches is normalised with its
    own statistics, and each split keeps running statistics of its own
    (the unbiased batch variance, as torch tracks it); in eval one BN with
    the splits' aggregate: mean m = mean of the running means, variance
    mean(var + mean^2) - m^2. `weight` and `bias` are shared; the running
    statistics are [num_splits, C]. The output has the input's dtype."""

    def __init__(self, num_features: int, num_splits: int = 1, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.num_splits = num_splits
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_splits, num_features))
        self.register_buffer("running_var", torch.ones(num_splits, num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            m = self.running_mean.mean(dim=0)
            v = (self.running_var + self.running_mean ** 2).mean(dim=0) - m ** 2
            y = (xf - m) * torch.rsqrt(v + self.eps)
            return (y * self.weight + self.bias).to(x.dtype)
        B, splits = x.shape[0], self.num_splits
        if B % splits:
            raise ValueError(f"batch {B} does not split into {splits} sub-batches")
        xs = xf.reshape(splits, B // splits, *x.shape[1:])
        dims = tuple(range(1, xs.dim() - 1))
        m = xs.mean(dim=dims)  # [splits, C]
        v = xs.var(dim=dims, unbiased=False)
        bshape = (splits,) + (1,) * (xs.dim() - 2) + (x.shape[-1],)
        y = (xs - m.reshape(bshape)) * torch.rsqrt(v.reshape(bshape) + self.eps)
        y = (y.reshape(x.shape) * self.weight + self.bias).to(x.dtype)
        with torch.no_grad():
            n = xs[0, ..., 0].numel()
            mom = self.momentum
            self.running_mean.mul_(1 - mom).add_(m, alpha=mom)
            self.running_var.mul_(1 - mom).add_(v * n / max(n - 1, 1), alpha=mom)
            self.num_batches_tracked.add_(1)
        return y


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, differentiable: every rank's loss sees the sum,
    so the gradient of each rank's input is the group's summed gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class SyncBatchNorm(BatchNorm):
    """The port's `BatchNorm` with its training statistics taken over the
    process group (the reference's NaiveSyncBatchNorm): one all-reduce of
    each rank's per-channel sums, sums of squares and count, then the
    global mean and biased variance E[x^2] - mean^2 normalise every rank's
    shard and update the running statistics with the port's momentum
    convention, running = (1 - momentum) running + momentum batch. Works on
    gloo and NCCL (`torch.nn.SyncBatchNorm` refuses CPU tensors). Outside
    an initialised group of more than one process, or in eval mode, it is
    the port's `BatchNorm`."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 group=None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.group = group

    def forward(self, x):
        if not (self.training and dist.is_available() and dist.is_initialized()
                and dist.get_world_size(self.group) > 1):
            return super().forward(x)
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        count = torch.full((1,), xf[..., 0].numel(), dtype=torch.float32, device=x.device)
        stats = _AllReduceSum.apply(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]),
                                    self.group)
        C = x.shape[-1]
        n = stats[2 * C]
        mean = stats[:C] / n
        var = (stats[C:2 * C] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach().to(self.running_mean.dtype),
                                                 alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach().to(self.running_var.dtype),
                                                alpha=m)
            self.num_batches_tracked.add_(1)
        y = (xf - mean) * (self.weight.float() * torch.rsqrt(var + self.eps)) + self.bias.float()
        return y.to(x.dtype)


def sync_batchnorm(num_features: int, momentum: float = 0.1, epsilon: float = 1e-5,
                   group=None) -> SyncBatchNorm:
    """Cross-process synchronised BatchNorm over `group` (default: the
    world), the JAX factory's counterpart (there flax's BatchNorm with an
    `axis_name`, one psum over the mesh axis). torch-convention momentum."""
    return SyncBatchNorm(num_features, momentum=momentum, eps=epsilon, group=group)
