"""Optimizer construction and LR policies of the classification surface.

Counterpart of `mspi_tpu/train/optim.py` (reference SlowFast
models/optimizer.py:11-149 and utils/lr_policy.py:9-88, the MSPI core's
utils/optim.py:19-37): the cosine and steps-with-relative-LRs policies with
linear warmup, the per-iteration `cosine_scheduler`, and
`construct_optimizer` for sgd, adam, adamw, lars and mt_adamw with the JAX
package's optax semantics:

- the weight-decay mask (`wd_mask`, ZERO_WD_1D_PARAM) becomes two parameter
  groups, weight decay 0 for every parameter of at most one dimension;
- sgd and adam decay coupled, the decayed weights added to the gradient
  before the update (optax's `add_decayed_weights` ahead of `sgd` / `adam`),
  which is what torch's `SGD` and `Adam` do with `weight_decay`; sgd keeps
  optax's trace form (trace = g + momentum * trace; nesterov: g + momentum
  * trace), torch's SGD without dampening;
- adamw (and mt_adamw, the same math) decays decoupled over the mask:
  torch's `AdamW` (p -= lr * wd * p beside the Adam step);
- lars is `optax.lars` written on tensors (torch has none): coupled decay
  over the mask, each tensor's update scaled by the trust ratio
  trust_coefficient * |p| / |u| (1 where either norm is 0), then by the
  learning rate, then a trace with the momentum.

The learning rate is set at every step (`set_lr`), as the JAX package's
`inject_hyperparams` sets it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Sequence, Tuple, Union

import numpy as np
import torch

OPTIMIZERS = ("sgd", "adam", "adamw", "lars", "mt_adamw")
ADAM_EPS = 1e-8  # optax.adam's eps (eps_root 0)


def lr_cosine(base_lr: float, end_lr: float, max_epoch: float,
              warmup_epochs: float = 0.0, warmup_start_lr: float = 0.0,
              cosine_after_warmup: bool = False) -> Callable[[float], float]:
    """lr_policy.py cosine: an optional linear warmup, then a half cosine."""

    def cosine(epoch: float) -> float:
        offset = warmup_epochs if cosine_after_warmup else 0.0
        return (end_lr + (base_lr - end_lr)
                * (math.cos(math.pi * (epoch - offset) / (max_epoch - offset)) + 1.0) * 0.5)

    def policy(epoch: float) -> float:
        if warmup_epochs > 0 and epoch < warmup_epochs:
            alpha = (cosine(warmup_epochs) - warmup_start_lr) / warmup_epochs
            return warmup_start_lr + epoch * alpha
        return cosine(epoch)

    return policy


def lr_steps_with_relative_lrs(base_lr: float, lrs: Sequence[float], steps: Sequence[float],
                               max_epoch: float, warmup_epochs: float = 0.0,
                               warmup_start_lr: float = 0.0) -> Callable[[float], float]:
    """lr_policy.py steps_with_relative_lrs."""
    steps = list(steps) + [max_epoch]

    def policy(epoch: float) -> float:
        if warmup_epochs > 0 and epoch < warmup_epochs:
            ind = next(i for i, step in enumerate(steps) if warmup_epochs < step) - 1
            alpha = (lrs[ind] * base_lr - warmup_start_lr) / warmup_epochs
            return warmup_start_lr + epoch * alpha
        ind = next(i for i, step in enumerate(steps) if epoch < step) - 1
        return lrs[ind] * base_lr

    return policy


def cosine_scheduler(base_value, final_value, epochs, niter_per_ep, warmup_epochs=0,
                     start_warmup_value=0) -> np.ndarray:
    """The per-iteration cosine schedule (utils/optim.py:19-37)."""
    warmup_iters = int(warmup_epochs * niter_per_ep)
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters)))
    schedule = np.concatenate((warmup, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


Params = Iterable[Union[torch.Tensor, Tuple[str, torch.Tensor]]]


def wd_mask(params: Params) -> List[bool]:
    """True where weight decay applies: every parameter of more than one
    dimension (BatchNorm and LayerNorm scales, biases and any 1-D tensor
    take none)."""
    return [p.dim() > 1 for p in _tensors(params)]


def _tensors(params: Params) -> List[torch.Tensor]:
    return [p[1] if isinstance(p, tuple) else p for p in params]


def _groups(params: Params, weight_decay: float, zero_wd_1d_param: bool) -> List[dict]:
    tensors = _tensors(params)
    if not zero_wd_1d_param:
        return [{"params": tensors, "weight_decay": weight_decay}]
    mask = wd_mask(tensors)
    return [{"params": [p for p, m in zip(tensors, mask) if m], "weight_decay": weight_decay},
            {"params": [p for p, m in zip(tensors, mask) if not m], "weight_decay": 0.0}]


class Lars(torch.optim.Optimizer):
    """optax.lars on tensors: u = g + wd * p (wd 0 off the mask); u *=
    trust_coefficient * |p| / (|u| + eps) where both norms are nonzero; u
    *= -lr; trace = u + momentum * trace; p += trace (nesterov: p += u +
    momentum * trace)."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False, trust_coefficient: float = 0.001, eps: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      nesterov=nesterov, trust_coefficient=trust_coefficient,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad.add(p, alpha=group["weight_decay"])
                p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = group["trust_coefficient"] * p_norm / (u_norm + group["eps"])
                u.mul_(torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio))
                u.mul_(-group["lr"])
                state = self.state[p]
                trace = state.get("trace")
                trace = u.clone() if trace is None else trace.mul_(group["momentum"]).add_(u)
                state["trace"] = trace
                p.add_(u.add(trace, alpha=group["momentum"]) if group["nesterov"] else trace)


def construct_optimizer(params: Params, optimizing_method: str = "sgd", base_lr: float = 0.1,
                        momentum: float = 0.9, weight_decay: float = 1e-4,
                        dampening: float = 0.0, nesterov: bool = True,
                        zero_wd_1d_param: bool = True,
                        betas: Tuple[float, float] = (0.9, 0.999)) -> torch.optim.Optimizer:
    """SGD / Adam / AdamW / LARS over `params` (tensors or (name, tensor)
    pairs) with the JAX package's weight-decay partition. The LR starts at
    base_lr; `set_lr` sets it per step."""
    if optimizing_method not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {optimizing_method!r} not supported")
    groups = _groups(params, weight_decay, zero_wd_1d_param)
    if optimizing_method == "sgd":
        # optax's trace has no dampening: `dampening` is taken and unread, as
        # the JAX package's construct_optimizer leaves it
        return torch.optim.SGD(groups, lr=base_lr, momentum=momentum,
                               nesterov=nesterov and momentum > 0)
    if optimizing_method == "adam":
        return torch.optim.Adam(groups, lr=base_lr, betas=betas, eps=ADAM_EPS)
    if optimizing_method == "lars":
        return Lars(groups, lr=base_lr, momentum=momentum, nesterov=nesterov)
    return torch.optim.AdamW(groups, lr=base_lr, betas=betas, eps=ADAM_EPS)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
