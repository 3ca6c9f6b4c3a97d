"""Video-classification training and testing: counterpart of
`mspi_tpu/train/classification.py` (reference SlowFast
tools/train_net.py:33-778 and tools/test_net.py:25-284).

One train step is the forward on the batch (MixUp / CutMix drawn inside the
step), cross-entropy with label smoothing or the soft cross-entropy of the
mixed targets, the backward through the kernels' backward passes and the
optimizer's update; with a mesh it is the single-collective DDP step (one
all-reduce of the gradients, BatchNorm statistics and loss over the data
group, `train.engine.average_over_data`). A step's random draws (MixUp,
drop-path, the head's dropout) come from a seed drawn off the state's
generator and folded with the rank's data index, as the JAX step folds its
key with `axis_index`. bf16: autocast, the parameters fp32.

Checkpoints (`ckpt_{epoch}`, auto-resume) are the port's own `torch.save`
files: model, optimizer, generator and epoch (the JAX package writes
orbax).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.data.augment import (cutmix_batch, draw_beta, draw_cutmix, mixup_batch,
                                         one_hot_smooth)
from mspi_tpu_torch.train import engine
from mspi_tpu_torch.train.optim import set_lr
from mspi_tpu_torch.utils.meters import TestMeter, TrainMeter, ValMeter, topk_errors


@dataclasses.dataclass
class ClsTrainState:
    """The classifier (parameters and BatchNorm statistics), its optimizer
    and the generator of the steps' random draws."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    epoch: int = 0


def create_cls_state(model: nn.Module, make_optimizer: Callable, seed: int = 0
                     ) -> ClsTrainState:
    """make_optimizer(named parameters) -> the optimizer (e.g.
    `functools.partial(optim.construct_optimizer, optimizing_method=...)`)."""
    return ClsTrainState(model, make_optimizer(list(model.named_parameters())),
                         torch.Generator().manual_seed(seed))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    n = logits.shape[-1]
    log_p = F.log_softmax(logits.float(), dim=-1)
    if smoothing > 0:
        one_hot = F.one_hot(labels.long(), n).float() * (1 - smoothing) + smoothing / n
        return -(one_hot * log_p).sum(-1).mean()
    return -log_p.gather(-1, labels.long()[:, None]).mean()


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """SoftTargetCrossEntropy of mixed targets (train_net.py:175-186)."""
    return -(targets * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()


def _step_generator(state: ClsTrainState, mesh) -> torch.Generator:
    seed = int(torch.randint(2 ** 62, (), generator=state.generator))
    return torch.Generator().manual_seed(engine.fold_in(seed, mesh.data_rank if mesh else 0))


def make_cls_train_step(label_smoothing: float = 0.0, mixup_alpha: float = 0.0,
                        cutmix_alpha: float = 0.0, mixup_prob: float = 1.0,
                        switch_prob: float = 0.5, num_classes: Optional[int] = None,
                        mesh=None, compute_dtype: Optional[torch.dtype] = None):
    """Returns step(state, batch, lr) -> (loss, logits): batch clips
    [B,T,H,W,3] normalised and labels [B] on the model's device (with a
    mesh, this rank's shard); the loss a float (averaged over the data
    group), the logits this rank's. MixUp / CutMix as datasets/mixup.py: on
    with mixup_prob, CutMix against MixUp by switch_prob when both are on."""
    use_mix = mixup_alpha > 0.0 or cutmix_alpha > 0.0
    if use_mix and num_classes is None:
        raise ValueError("mixup needs num_classes")

    def mixed(gen, clips, labels):
        if torch.rand((), generator=gen) >= mixup_prob:
            return clips, one_hot_smooth(labels, num_classes, label_smoothing)
        cut = cutmix_alpha > 0.0 and (mixup_alpha == 0.0
                                      or torch.rand((), generator=gen) < switch_prob)
        if cut:
            lam, cy, cx = draw_cutmix(gen, cutmix_alpha, clips.shape[2], clips.shape[3])
            return cutmix_batch(clips, labels, num_classes, lam, cy, cx, label_smoothing)
        return mixup_batch(clips, labels, num_classes, draw_beta(gen, mixup_alpha),
                           label_smoothing)

    def train_step(state: ClsTrainState, batch, lr: float):
        model, opt = state.model, state.optimizer
        model.train()
        gen = _step_generator(state, mesh)
        engine._use_generator(model, gen)
        set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        clips, labels = batch["clips"], batch["labels"]
        with torch.autocast(clips.device.type, dtype=compute_dtype or torch.float32,
                            enabled=compute_dtype is not None):
            if use_mix:
                clips, targets = mixed(gen, clips, labels)
                logits = model(clips, gen)
                loss = soft_cross_entropy(logits, targets)
            else:
                logits = model(clips, gen)
                loss = cross_entropy(logits, labels, label_smoothing)
        loss.backward()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        value = loss.detach().reshape(1)
        if mesh is not None:
            value = engine.average_over_data(
                mesh, [p.grad for p in params] + engine.bn_statistics(model), value)
        opt.step()
        return float(value[0]), logits.detach()

    return train_step


def make_cls_eval_step(compute_dtype: Optional[torch.dtype] = None):
    """Returns step(state, clips) -> the class softmax (eval mode)."""

    def eval_step(state: ClsTrainState, clips):
        state.model.eval()
        with torch.no_grad(), torch.autocast(clips.device.type,
                                             dtype=compute_dtype or torch.float32,
                                             enabled=compute_dtype is not None):
            return state.model(clips).float()

    return eval_step


def _device_batch(batch, device) -> Dict[str, torch.Tensor]:
    return engine.to_device({"clips": np.asarray(batch["clips"], np.float32),
                             "labels": np.asarray(batch["labels"])}, device)


def train_epoch(state, train_step, loader, lr_policy, cur_epoch, steps_per_epoch,
                meter: Optional[TrainMeter] = None, device="cpu"):
    """tools/train_net.py:33-285 (a per-iteration LR). With a mesh the
    loader yields this rank's rows: the loss is the data group's mean, the
    top-k errors are this rank's rows'."""
    meter = meter or TrainMeter(steps_per_epoch)
    for it, batch in enumerate(loader):
        lr = lr_policy(cur_epoch + it / steps_per_epoch)
        loss, logits = train_step(state, _device_batch(batch, device), lr)
        top1, top5 = topk_errors(logits.float().cpu().numpy(), np.asarray(batch["labels"]),
                                 (1, 5))
        meter.update_stats(top1, top5, loss, lr, len(batch["labels"]))
        meter.log_iter_stats(cur_epoch, it)
    return state, meter.get_epoch_stats(cur_epoch)


def eval_epoch(state, eval_step, loader, cur_epoch, max_iter,
               meter: Optional[ValMeter] = None, device="cpu"):
    meter = meter or ValMeter(max_iter)
    for batch in loader:
        preds = eval_step(state, _device_batch(batch, device)["clips"])
        top1, top5 = topk_errors(preds.cpu().numpy(), np.asarray(batch["labels"]), (1, 5))
        meter.update_stats(top1, top5, len(batch["labels"]))
    return meter.get_epoch_stats(cur_epoch)


def perform_test(state, eval_step, loader, num_videos, num_clips, num_cls, device="cpu"):
    """tools/test_net.py:25-163: the multi-view ensemble."""
    meter = TestMeter(num_videos, num_clips, num_cls)
    for batch in loader:
        preds = eval_step(state, _device_batch(batch, device)["clips"])
        meter.update_stats(preds.cpu().numpy(), np.asarray(batch["labels"]),
                           np.asarray(batch["indices"]))
    return meter.finalize_metrics()


def save_cls_checkpoint(ckpt_dir: str, state: ClsTrainState, epoch: int) -> str:
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_{epoch}"))
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "generator": state.generator.get_state(), "epoch": int(epoch)}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def restore_latest_cls_checkpoint(ckpt_dir: str, state: ClsTrainState):
    """TRAIN.AUTO_RESUME (train_net.py:551-563): the newest epoch's
    checkpoint into `state`; returns (state, the epoch to start at)."""
    from mspi_tpu_torch.train.checkpoints import latest_checkpoint

    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return state, 0
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.generator.set_state(blob["generator"])
    return state, int(blob["epoch"]) + 1


def run_classification_training(
        model: nn.Module, make_optimizer: Callable, make_dataset: Callable, epochs: int,
        batch_size: int, lr_policy: Callable, base_t: int, base_crop: int,
        label_smoothing: float = 0.0, mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
        num_classes: Optional[int] = None, multigrid: bool = False,
        precise_bn_batches: int = 0, ckpt_dir: Optional[str] = None,
        auto_resume: bool = False, tb_dir: Optional[str] = None, mesh=None,
        eval_every: int = 1, seed: int = 0, log: Callable[[str], None] = print,
        device="cpu", compute_dtype: Optional[torch.dtype] = None):
    """The reference's train loop (train_net.py:512-778) through
    `train_epoch` and `eval_epoch`: MixUp / CutMix in the step, multigrid's
    long-cycle shapes, precise BN before evaluation, epoch checkpoints and
    auto-resume, TensorBoard scalars, DDP over the mesh's data axis (every
    rank draws the same seeded order and decodes only its rows of each
    training batch, `parallel.data_rows`; precise BN and evaluation run on
    whole batches on every rank, so the replicas' statistics stay equal;
    rank 0 writes). make_dataset(split, num_frames, crop_size) -> a
    map-style dataset of {'clips': uint8 [T,H,W,3], 'labels': int}."""
    from mspi_tpu_torch.data.video import normalize_frames
    from mspi_tpu_torch.parallel import data_rows, replicated
    from mspi_tpu_torch.train.multigrid import MultigridSchedule
    from mspi_tpu_torch.train.precise_bn import update_precise_bn

    rank0 = mesh is None or mesh.rank == 0
    rng = np.random.default_rng(seed)
    writer = None
    if tb_dir and rank0:
        from mspi_tpu_torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(tb_dir)
    schedule = (MultigridSchedule().schedule(epochs, base_t, base_crop, batch_size)
                if multigrid else None)
    if mesh is not None:  # every replica starts from rank 0's weights
        replicated(model.state_dict().values(), mesh)
    state = create_cls_state(model, make_optimizer, seed=seed)
    start_epoch = 0
    if ckpt_dir and auto_resume:
        state, start_epoch = restore_latest_cls_checkpoint(ckpt_dir, state)
        if start_epoch:
            log(f"auto-resumed from epoch {start_epoch - 1}")
    step = make_cls_train_step(label_smoothing, mixup_alpha, cutmix_alpha,
                               num_classes=num_classes, mesh=mesh, compute_dtype=compute_dtype)
    eval_step = make_cls_eval_step(compute_dtype)

    def loader(ds, bsz, shuffle=True, rows=slice(None)):
        order = np.arange(len(ds))
        if shuffle:
            rng.shuffle(order)
        for b in range(len(ds) // bsz):
            samples = [ds[int(i)] for i in order[b * bsz:(b + 1) * bsz][rows]]
            yield {"clips": normalize_frames(np.stack([s["clips"] for s in samples])),
                   "labels": np.asarray([s["labels"] for s in samples])}

    history = []
    for epoch in range(start_epoch, epochs):
        t, crop, bsz = base_t, base_crop, batch_size
        if schedule is not None:
            bsz, t, crop = MultigridSchedule().get_current(schedule, epoch)
            bsz = max(1, bsz)
        train_ds = make_dataset("train", t, crop)
        bsz = min(bsz, len(train_ds))
        if mesh is not None:  # the batch divides over the data axis
            bsz = max(mesh.dp, (bsz // mesh.dp) * mesh.dp)
        steps_per_epoch = max(1, len(train_ds) // bsz)
        state, train_stats = train_epoch(
            state, step, loader(train_ds, bsz, rows=data_rows(bsz, mesh)), lr_policy, epoch,
            steps_per_epoch, TrainMeter(steps_per_epoch, log=log), device)
        stats = {"epoch": epoch, "loss": train_stats["loss"], "lr": train_stats["lr"], "t": t,
                 "crop": crop, "batch": bsz}
        history.append(stats)
        log(f"train epoch {epoch}: {stats}")
        if writer:
            writer.add_scalars({"train/loss": stats["loss"], "train/lr": stats["lr"]},
                               step=epoch)
        if (epoch + 1) % eval_every == 0 or epoch == epochs - 1:
            if precise_bn_batches > 0:  # train_net.py:442-464
                update_precise_bn(state.model, loader(train_ds, bsz, shuffle=False),
                                  lambda b: (_device_batch(b, device)["clips"],),
                                  precise_bn_batches)
            val_ds = make_dataset("val", base_t, base_crop)
            meter = ValMeter(len(val_ds) // batch_size)
            eval_epoch(state, eval_step, loader(val_ds, batch_size, shuffle=False), epoch,
                       meter.max_iter, meter, device)
            if meter.num_samples:
                stats["val_top1_err"] = meter.get_epoch_stats(epoch)["top1_err"]
                log(f"val epoch {epoch}: top1_err={stats['val_top1_err']:.2f}")
                if writer:
                    writer.add_scalar("val/top1_err", stats["val_top1_err"], step=epoch)
        state.epoch = epoch + 1
        if ckpt_dir and rank0:
            save_cls_checkpoint(ckpt_dir, state, epoch)
    if writer:
        writer.close()
    return state, history
