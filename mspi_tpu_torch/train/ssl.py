"""Self-supervised contrastive training (MoCo / SimCLR / BYOL / SwAV) with a
momentum trunk, a negative queue and a kNN monitor.

Counterpart of `mspi_tpu/train/ssl.py` (reference
SlowFast/slowfast/models/contrastive.py:32-1166: ContrastiveModel's
momentum encoder and queue, the per-task forwards at :373-805, the kNN
memory at :132-242, the momentum annealing at :252-262).

The state holds the online net (parameters and BatchNorm statistics), a
copy of it as the momentum net, the optimizer, the queue and its pointer,
and the generator of the steps' drop-path draws. One step follows the JAX
step's order:

- moco: q = the online net's predictor output on view 1 (train mode), k =
  the momentum net's projection of view 2 (eval mode), InfoNCE against the
  queue;
- byol: both views through the online net in train mode, one after the
  other (so BatchNorm statistics update twice), both through the momentum
  net in eval mode, the symmetric cosine loss;
- simclr / swav: both views through the online net in train mode, NT-Xent
  or the swapped prediction against the prototypes;
- then the optimizer's step at the step's learning rate (`optim.set_lr`,
  where JAX sets `opt_state.hyperparams`); every trainable tensor takes
  part, with a zero gradient where the loss does not reach it, as JAX's;
- moco and byol: the momentum net's parameters (the predictor's too) move
  by the EMA toward the updated online ones, and its BatchNorm statistics
  become a copy of the online net's;
- moco: the L2-normalised keys enter the queue at the pointer, which
  advances modulo its length; swav: the prototypes are renormalised.

The JAX step passes no drop-path key to its trunk, so a trunk that draws
drop-path in train mode (MViT) raises there; the port draws it from a seed
off the state's generator, as its other steps do. bf16: autocast, the
parameters fp32, the losses fp32.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from mspi_tpu_torch.models.contrastive import (ProjectionMLP, _l2norm, byol_loss, moco_loss,
                                               momentum_update, nt_xent_loss, queue_update,
                                               swav_loss)
from mspi_tpu_torch.train import engine
from mspi_tpu_torch.train.optim import set_lr

OBJECTIVES = ("moco", "simclr", "byol", "swav")


class ContrastiveNet(nn.Module):
    """Trunk + projector (+ predictor, + SwAV prototypes): the trunk maps
    clips to a pyramid (its last level is taken) or to one [B, ..., C] map,
    which is average-pooled over everything but B and C before the
    projector. The prototypes are drawn as the JAX initialiser draws them
    (normal, std 0.02, here from a generator seeded 0); the linear layers
    take torch's default, which is the JAX package's."""

    def __init__(self, trunk: nn.Module, dim_in: int, dim_hidden: int = 2048,
                 dim_out: int = 128, use_predictor: bool = False, num_prototypes: int = 0):
        super().__init__()
        self.dim_out, self.use_predictor = dim_out, use_predictor
        self.trunk = trunk
        self.projector = ProjectionMLP(dim_in, dim_hidden, dim_out)
        if use_predictor:
            self.predictor = ProjectionMLP(dim_out, dim_hidden // 4, dim_out, num_layers=2)
        if num_prototypes:
            gen = torch.Generator().manual_seed(0)
            self.prototypes = nn.Parameter(0.02 * torch.randn(num_prototypes, dim_out,
                                                              generator=gen))

    def embed(self, clips):
        feats = self.trunk(clips)
        if isinstance(feats, (list, tuple)):
            feats = feats[-1]
        pooled = feats.reshape(feats.shape[0], -1, feats.shape[-1]).mean(dim=1)
        return self.projector(pooled)

    def forward(self, clips, predict: bool = False):
        z = self.embed(clips)
        if predict and self.use_predictor:
            return z, self.predictor(z)
        return z, None


@dataclasses.dataclass
class SSLTrainState:
    """The online net, its momentum copy (eval mode, no gradients), the
    optimizer over the online net's parameters, the MoCo queue [K, dim_out]
    (None without one) and its pointer, and the drop-path generator."""

    model: ContrastiveNet
    momentum_model: ContrastiveNet
    optimizer: torch.optim.Optimizer
    queue: Optional[torch.Tensor]
    queue_ptr: int
    generator: torch.Generator


def create_ssl_state(model: ContrastiveNet, make_optimizer: Callable, queue_size: int = 4096,
                     seed: int = 0) -> SSLTrainState:
    """make_optimizer(named parameters) -> the optimizer. The queue is drawn
    from N(0, 1) off a generator seeded with `seed`, on the model's device."""
    momentum_model = copy.deepcopy(model).eval().requires_grad_(False)
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    queue = (torch.randn(queue_size, model.dim_out, generator=gen).to(device)
             if queue_size else None)
    return SSLTrainState(model, momentum_model, make_optimizer(list(model.named_parameters())),
                         queue, 0, gen)


def momentum_anneal_cosine(m_base: float, epoch_exact: float, max_epoch: float) -> float:
    """contrastive.py:252-262: the momentum from m_base (epoch 0) to 1
    (max_epoch), cosine-style."""
    return 1.0 - (1.0 - m_base) * (math.cos(math.pi * epoch_exact / max_epoch) + 1.0) * 0.5


def make_ssl_train_step(objective: str, momentum: float = 0.994, temperature: float = 0.07,
                        compute_dtype: Optional[torch.dtype] = None):
    """step(state, batch {clips1, clips2}, lr[, mom]) -> the loss (a float);
    the state is updated in place (module docstring)."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective {objective!r} not in {OBJECTIVES}")

    def loss_of(state: SSLTrainState, batch):
        online, target = state.model, state.momentum_model
        c1, c2 = batch["clips1"], batch["clips2"]
        keys = None
        if objective == "moco":
            z1, p1 = online(c1, predict=True)
            q = p1 if p1 is not None else z1
            with torch.no_grad():
                k, _ = target(c2)
            loss, keys = moco_loss(q, k, state.queue, temperature), k
        elif objective == "byol":
            _, p1 = online(c1, predict=True)
            _, p2 = online(c2, predict=True)
            with torch.no_grad():
                t1, _ = target(c1)
                t2, _ = target(c2)
            loss = byol_loss(p1, t2, p2, t1)
        else:
            z1, _ = online(c1)
            z2, _ = online(c2)
            loss = (nt_xent_loss(z1, z2, temperature) if objective == "simclr"
                    else swav_loss(z1, z2, online.prototypes, temperature))
        return loss, keys

    def train_step(state: SSLTrainState, batch, lr: float, mom: Optional[float] = None) -> float:
        mom = momentum if mom is None else mom
        model, opt = state.model, state.optimizer
        model.train()
        state.momentum_model.eval()
        seed = int(torch.randint(2 ** 62, (), generator=state.generator))
        engine._use_generator(model, torch.Generator().manual_seed(seed))
        set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        device = batch["clips1"].device
        with torch.autocast(device.type, dtype=compute_dtype or torch.float32,
                            enabled=compute_dtype is not None):
            loss, keys = loss_of(state, batch)
        loss.backward()
        for p in model.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        with torch.no_grad():
            if objective in ("moco", "byol"):
                momentum_update(model.parameters(), state.momentum_model.parameters(), mom)
                for b, t in zip(model.buffers(), state.momentum_model.buffers()):
                    t.copy_(b)
            if objective == "moco":
                state.queue, state.queue_ptr = queue_update(state.queue, keys, state.queue_ptr)
            elif objective == "swav":
                model.prototypes.copy_(_l2norm(model.prototypes))
        return float(loss.detach())

    return train_step


# ----------------------------------------------------------------- kNN eval


def knn_mem_create(num_samples: int, dim: int) -> torch.Tensor:
    """Memory1D: one unit embedding slot per training sample, drawn from
    N(0, 1) off a generator seeded 0."""
    return _l2norm(torch.randn(num_samples, dim, generator=torch.Generator().manual_seed(0)))


def knn_mem_update(mem: torch.Tensor, embeddings: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
    """contrastive.py knn_mem_update: a copy of mem with the normalised
    embeddings at the sample indices."""
    out = mem.clone()
    out[indices] = _l2norm(embeddings.float()).to(mem.dtype)
    return out


def eval_knn(queries: torch.Tensor, mem: torch.Tensor, mem_labels: torch.Tensor,
             knn_k: int = 200, num_classes: int = 400,
             temperature: float = 0.07) -> torch.Tensor:
    """contrastive.py eval_knn + train_net.py's kNN eval: the
    temperature-weighted vote of the k nearest memory slots -> the predicted
    class [B]."""
    sim = _l2norm(queries.float()) @ mem.float().T  # [B, N]
    top_sim, top_idx = torch.topk(sim, min(knn_k, mem.shape[0]), dim=-1)
    weights = torch.exp(top_sim / temperature)
    votes = torch.nn.functional.one_hot(mem_labels[top_idx].long(), num_classes) \
        * weights[..., None]
    return votes.sum(dim=1).argmax(dim=-1)
