"""Training and evaluation steps of the port.

Counterpart of `mspi_tpu/train/engine.py` (`make_train_step`,
`make_ddp_train_step`, `make_eval_step`, the optimizer, the frozen split and
the LR schedule). `make_train_step` runs on one device: the model forward
in train mode, SalLoss + gamma * SimSiam, backward through the hand-written
kernels' backward passes, the global gradient L2 norm (no clipping) and an
AdamW update over the trainable parameters only. The frozen encoders
(`FROZEN_TOPLEVEL`) run in eval mode under `torch.no_grad()` and hold
`requires_grad=False`.

bf16, as the JAX package's `--bf16`: parameters and the AdamW state stay
fp32, and the forward runs under `torch.autocast(..., torch.bfloat16)`; the
kernel wrappers cast their operands to bf16 there, and the casts return the
gradients to the fp32 parameters.

Stochastic depth draws from the TrainState's CPU `torch.Generator`, so a
step is reproducible on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mspi_tpu_torch.config import MSPIConfig
from mspi_tpu_torch.models.fusion import FROZEN as FROZEN_TOPLEVEL
from mspi_tpu_torch.ops.layers import DropPath
from mspi_tpu_torch.train.loss import sal_loss

ADAMW_BETAS = (0.9, 0.999)  # optax.adamw defaults
ADAMW_EPS = 1e-8


def split_frozen(model: nn.Module) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by name, in module order; marks the
    frozen ones requires_grad=False."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        if name.split(".", 1)[0] in FROZEN_TOPLEVEL:
            p.requires_grad_(False)
            frozen[name] = p
        else:
            trainable[name] = p
    return trainable, frozen


def step_lr_schedule(base_lr: float, max_epoch: int) -> list:
    """The reference's train.py:161-166: the base LR for 60 epochs, then
    x0.1, then x0.1 again every further 60."""
    values = [base_lr] * min(60, max_epoch)
    lr = base_lr * 0.1
    for i in range(max_epoch - 60):
        values.append(lr)
        if (i + 1) % 60 == 0:
            lr *= 0.1
    return values[:max_epoch]


def make_optimizer(cfg: MSPIConfig, params) -> torch.optim.AdamW:
    """AdamW (beta 0.9/0.999, eps 1e-8, weight decay from the config) over
    `params`; the LR is set at every step."""
    return torch.optim.AdamW(list(params), lr=cfg.solver.lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                             weight_decay=cfg.solver.weight_decay)


@dataclasses.dataclass
class TrainState:
    """Counterpart of the JAX TrainState: the model holds params, frozen
    params and batch statistics; the optimizer holds the AdamW state over
    `param_names` (in that order); `generator` drives drop-path."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    param_names: List[str]
    epoch: int = 0
    generator: torch.Generator = dataclasses.field(default_factory=torch.Generator)


def create_train_state(cfg: MSPIConfig, model: nn.Module,
                       seed: Optional[int] = None) -> TrainState:
    trainable, _ = split_frozen(model)
    gen = torch.Generator().manual_seed(cfg.train.seed if seed is None else seed)
    return TrainState(model=model, optimizer=make_optimizer(cfg, trainable.values()),
                      param_names=list(trainable), generator=gen)


def trainable_parameters(state: TrainState) -> List[nn.Parameter]:
    params = dict(state.model.named_parameters())
    return [params[n] for n in state.param_names]


def _use_generator(model: nn.Module, gen: torch.Generator) -> None:
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = gen


def to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on `device`: pinned, non-blocking copies
    on CUDA. uint8 clips stay uint8; the model normalises them on the
    device."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                    else t.to(device))
    return out


def _forward(model, batch, use_sound: bool):
    if use_sound:
        return model(batch["clips"], batch["audio"])
    return model(batch["clips"])


def _backward(state: TrainState, batch, gamma: float, use_sound: bool,
              compute_dtype: Optional[torch.dtype]):
    """The forward in train mode and the backward: every trainable
    parameter's .grad set (zeros outside the graph, as JAX gives), the
    metrics as tensors."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    device = batch["gt"].device
    with torch.autocast(device.type, dtype=compute_dtype or torch.float32,
                        enabled=compute_dtype is not None):
        out, loss_va = _forward(model, batch, use_sound)
        loss_sal, aux = sal_loss(out.float(), batch["gt"].float())
        loss = loss_sal + gamma * loss_va
    loss.backward()
    for p in trainable_parameters(state):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return dict(aux, loss_va=loss_va, loss=loss)


def _as_floats(metrics: Mapping[str, torch.Tensor], device) -> Dict[str, float]:
    values = torch.stack([torch.as_tensor(v, device=device).detach().float().reshape(())
                          for v in metrics.values()]).cpu()
    return dict(zip(metrics, values.tolist()))


def make_train_step(gamma: float, use_sound: bool = True,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Callable[[TrainState, Mapping[str, torch.Tensor], float], Dict[str, float]]:
    """Returns step(state, batch, lr) -> metrics, which updates the state
    in place. batch: clips [B,T,H,W,3] (uint8 or normalised float), audio
    [B,F,Tw,1], gt [B,H,W], on the model's device. metrics: kl, cc, sim,
    loss_va, loss and grad_norm as Python floats, read after one sync.
    compute_dtype=torch.bfloat16 runs the forward under autocast."""

    def train_step(state: TrainState, batch, lr: float) -> Dict[str, float]:
        _use_generator(state.model, state.generator)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        metrics = _backward(state, batch, gamma, use_sound, compute_dtype)
        params = trainable_parameters(state)
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([p.grad for p in params])))
        state.optimizer.step()
        return _as_floats(dict(metrics, grad_norm=grad_norm), batch["gt"].device)

    return train_step


def fold_in(seed: int, index: int) -> int:
    """A seed of its own for stream `index` of `seed` (jax.random.fold_in's
    role): a rank's drop-path draws."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def bn_statistics(model: nn.Module) -> List[torch.Tensor]:
    """The running statistics of the trainable BatchNorms (the frozen
    encoders' stay as they are)."""
    return [b for name, b in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")
            and name.split(".", 1)[0] not in FROZEN_TOPLEVEL]


def average_over_data(mesh, tensors: List[torch.Tensor], scalars: torch.Tensor
                      ) -> torch.Tensor:
    """The DDP steps' single collective: `tensors` (gradients, BatchNorm
    statistics; averaged in place) and `scalars` (returned averaged) as one
    flat fp32 all-reduce over the mesh's data group."""
    flat = torch.cat([t.detach().float().flatten() for t in tensors] + [scalars.float()])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.dp
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat[offset:]


def make_ddp_train_step(gamma: float, mesh, use_sound: bool = True,
                        compute_dtype: Optional[torch.dtype] = None):
    """The DDP step with exactly one collective, counterpart of the JAX
    package's `make_ddp_train_step` (`shard_map` + one `pmean`): each rank
    runs the forward and backward on its rows of the batch
    (`parallel.data_rows`), then ONE flat all-reduce over the mesh's
    data group averages the gradients, the trainable BatchNorms' running
    statistics and the scalar metrics together, and every rank applies the
    same optimizer update to its replica. Not DistributedDataParallel:
    its bucketed all-reduces average neither the statistics nor keep one
    collective a step.

    Drop-path: every rank draws one seed from the state's generator (the
    same on every rank, which keeps the generators equal) and folds its
    data index into it (`fold_in`), as `fold_in(axis_index('data'))` does.
    With the SyncBlock split over the model axis (`parallel.
    shard_sync_block`) the ranks of one model group share their draws, the
    split layers add their activation all-reduces, and the gradient norm
    sums the split parameters' parts over the model group. mesh=None: one
    process, the same step without a collective."""
    tp = mesh.tp if mesh is not None else 1

    def train_step(state: TrainState, batch, lr: float) -> Dict[str, float]:
        seed = int(torch.randint(2 ** 62, (), generator=state.generator))
        gen = torch.Generator().manual_seed(fold_in(seed, mesh.data_rank if mesh else 0))
        _use_generator(state.model, gen)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        metrics = _backward(state, batch, gamma, use_sound, compute_dtype)
        params = trainable_parameters(state)
        grads = [p.grad for p in params]
        stats = bn_statistics(state.model)
        names = list(metrics)
        scalars = torch.stack([torch.as_tensor(v).detach().float().reshape(()).to(grads[0].device)
                               for v in metrics.values()])
        if mesh is not None:
            scalars = average_over_data(mesh, grads + stats, scalars)
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        if tp > 1:  # the split parameters' squares summed over their shards
            split = torch.tensor([getattr(p, "tp_sharded", False) for p in params],
                                 device=sq.device)
            part = (sq * split).sum()
            dist.all_reduce(part, group=mesh.model_group)
            total = (sq * ~split).sum() + part
        else:
            total = sq.sum()
        state.optimizer.step()
        out = dict(zip(names, scalars))
        out["grad_norm"] = total.sqrt()
        return _as_floats(out, grads[0].device)

    return train_step


def make_eval_step(use_sound: bool = True, compute_dtype: Optional[torch.dtype] = None):
    """Returns step(state, batch) -> (log-saliency map, metrics as floats):
    an eval-mode forward and the SalLoss components."""

    def eval_step(state: TrainState, batch):
        model = state.model
        model.eval()
        device = batch["gt"].device
        with torch.no_grad(), torch.autocast(device.type, dtype=compute_dtype or torch.float32,
                                             enabled=compute_dtype is not None):
            out, _ = _forward(model, batch, use_sound)
            _, aux = sal_loss(out.float(), batch["gt"].float())
        values = torch.stack([v.float() for v in aux.values()]).cpu()
        return out, dict(zip(aux, values.tolist()))

    return eval_step
