"""Contrastive / self-supervised pretraining heads and losses (MoCo,
SimCLR, BYOL, SwAV).

Counterpart of `mspi_tpu/models/contrastive.py` (reference
SlowFast/slowfast/models/contrastive.py:32-1166): the projector / predictor
MLP, the four objectives' losses, the momentum encoder's EMA and the MoCo
queue's update. The losses compute in fp32 whatever the embeddings' dtype
(under autocast the projector gives bf16). The EMA and the queue update
write their results into the momentum parameters and the queue in place.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ProjectionMLP(nn.Module):
    """SSL projector: Linear-LN-ReLU x (n-1) -> Linear (contrastive.py
    heads). The module names are the flax scopes: `layers_list_{i}`,
    `norms_{i}`."""

    def __init__(self, dim_in: int, dim_hidden: int = 2048, dim_out: int = 128,
                 num_layers: int = 3):
        super().__init__()
        dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            setattr(self, f"layers_list_{i}", nn.Linear(dims[i], dims[i + 1]))
        for i in range(self.num_layers - 1):
            setattr(self, f"norms_{i}", nn.LayerNorm(dims[i + 1], eps=1e-5))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"norms_{i}")(getattr(self, f"layers_list_{i}")(x)))
        return getattr(self, f"layers_list_{self.num_layers - 1}")(x)


def _l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.1):
    """SimCLR NT-Xent over the batch."""
    z1, z2 = _l2norm(z1.float()), _l2norm(z2.float())
    B = z1.shape[0]
    z = torch.cat([z1, z2], dim=0)
    sim = z @ z.T / temperature
    sim = sim - 1e9 * torch.eye(2 * B, device=z.device)
    idx = torch.arange(B, device=z.device)
    targets = torch.cat([idx + B, idx])
    rows = torch.arange(2 * B, device=z.device)
    return torch.mean(-F.log_softmax(sim, dim=-1)[rows, targets])


def moco_loss(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
              temperature: float = 0.07):
    """MoCo InfoNCE: positives = momentum keys, negatives = queue."""
    q, k = _l2norm(q.float()), _l2norm(k.detach().float())
    l_pos = torch.sum(q * k, dim=-1, keepdim=True)
    l_neg = q @ _l2norm(queue.float()).T
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return torch.mean(-F.log_softmax(logits, dim=-1)[:, 0])


def byol_loss(p1, z2, p2, z1):
    """BYOL symmetric negative cosine (predictions vs stop-grad targets)."""

    def d(p, z):
        return 2 - 2 * torch.sum(_l2norm(p.float()) * _l2norm(z.detach().float()), dim=-1)

    return torch.mean(d(p1, z2) + d(p2, z1)) * 0.5


def sinkhorn(scores: torch.Tensor, eps: float = 0.05, n_iters: int = 3) -> torch.Tensor:
    """SwAV Sinkhorn-Knopp assignment (contrastive.py sinkhorn)."""
    tiny = torch.finfo(scores.dtype).tiny
    scaled = scores / eps
    scaled = scaled - scaled.max()  # stabilise exp
    Q = torch.exp(scaled).T  # [K, B]
    Q = Q / Q.sum().clamp_min(tiny)
    K, B = Q.shape
    for _ in range(n_iters):
        Q = Q / Q.sum(dim=1, keepdim=True).clamp_min(tiny) / K
        Q = Q / Q.sum(dim=0, keepdim=True).clamp_min(tiny) / B
    return (Q * B).T


def swav_loss(z1: torch.Tensor, z2: torch.Tensor, prototypes: torch.Tensor,
              temperature: float = 0.1):
    """SwAV swapped prediction with Sinkhorn targets."""
    p = _l2norm(prototypes.float())
    s1 = _l2norm(z1.float()) @ p.T
    s2 = _l2norm(z2.float()) @ p.T
    q1 = sinkhorn(s1.detach())
    q2 = sinkhorn(s2.detach())
    l1 = -torch.mean(torch.sum(q2 * F.log_softmax(s1 / temperature, dim=-1), dim=-1))
    l2 = -torch.mean(torch.sum(q1 * F.log_softmax(s2 / temperature, dim=-1), dim=-1))
    return (l1 + l2) * 0.5


@torch.no_grad()
def momentum_update(online: Iterable[torch.Tensor], momentum: Iterable[torch.Tensor],
                    m: float = 0.994) -> None:
    """EMA of the momentum encoder (contrastive.py _update_momentum): each
    momentum tensor t becomes m * t + (1 - m) * o, o its online tensor."""
    for o, t in zip(online, momentum):
        t.copy_(m * t + (1.0 - m) * o)


@torch.no_grad()
def queue_update(queue: torch.Tensor, keys: torch.Tensor, ptr: int) -> Tuple[torch.Tensor, int]:
    """The MoCo queue: the L2-normalised keys overwrite B rows from ptr
    (moved back to K - B where they would run past the end, as
    `jax.lax.dynamic_update_slice` clamps its start), and ptr advances by B
    modulo K."""
    B, K = keys.shape[0], queue.shape[0]
    start = max(0, min(int(ptr), K - B))
    queue[start:start + B] = _l2norm(keys.float()).to(queue.dtype)
    return queue, (int(ptr) + B) % K
