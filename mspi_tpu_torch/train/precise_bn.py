"""Precise BatchNorm statistics: counterpart of
`mspi_tpu/train/precise_bn.py` (reference SlowFast train_net.py:442-464,
fvcore's update_bn_stats).

Before evaluation the running statistics are replaced by the average of
the true batch statistics over N batches, recovered as the JAX package
recovers them, by its two-pass momentum calibration rather than by torch's
cumulative-average mode: a train-mode forward from running statistics 0
gives nA = mom * batch, one from 1 gives nB = (1 - mom) + mom * batch, so
m = nB - nA is each element's EMA factor (the flax convention, 1 - the
torch momentum) and batch = nA / (1 - m). The forwards run without
gradients, BatchNorm in train mode and drop-path off (as evaluated); the
BatchNorms' batch counters are left as they were.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch
from torch import nn

from mspi_tpu_torch.ops.layers import BatchNorm, DropPath


def _bns(model: nn.Module) -> List[BatchNorm]:
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


@torch.no_grad()
def _run(model: nn.Module, args, fill: float) -> List[torch.Tensor]:
    """Each BatchNorm's (running_mean, running_var) after one train-mode
    forward from statistics all `fill`."""
    bns = _bns(model)
    for bn in bns:
        bn.running_mean.fill_(fill)
        bn.running_var.fill_(fill)
    model(*args)
    return [t.clone() for bn in bns for t in (bn.running_mean, bn.running_var)]


@torch.no_grad()
def update_precise_bn(model: nn.Module, batches: Iterable, make_args: Callable,
                      num_batches: int = 200) -> nn.Module:
    """Set every BatchNorm's running statistics to the mean of the true
    batch statistics over the first num_batches of `batches` (NUM_BATCHES_
    PRECISE); make_args(batch) -> the model's positional args. In place."""
    bns = _bns(model)
    if not bns:
        return model
    was_training = model.training
    counters = [bn.num_batches_tracked.clone() for bn in bns]
    model.train()
    for m in model.modules():
        if isinstance(m, DropPath):
            m.eval()
    momentum, sums, count = None, None, 0
    for i, batch in enumerate(batches):
        if i >= num_batches:
            break
        args = make_args(batch)
        n_a = _run(model, args, 0.0)
        if momentum is None:  # the calibration, once: m per element
            momentum = [(b - a).clamp(0.0, 1.0 - 1e-6)
                        for a, b in zip(n_a, _run(model, args, 1.0))]
        stats = [a / (1.0 - m) for a, m in zip(n_a, momentum)]
        sums = stats if sums is None else [s + t for s, t in zip(sums, stats)]
        count += 1
    if count:
        it = iter(sums)
        for bn in bns:
            bn.running_mean.copy_(next(it) / count)
            bn.running_var.copy_(next(it) / count)
    for bn, c in zip(bns, counters):
        bn.num_batches_tracked.copy_(c)
    model.train(was_training)
    return model
