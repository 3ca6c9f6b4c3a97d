"""AVA action detection: the detector, its train and eval steps and the
mAP evaluation loop. Counterpart of `mspi_tpu/train/detection.py`
(reference SlowFast video_model_builder.py's DETECTION branch,
tools/train_net.py:100-168's detection loss, utils/meters.py AVAMeter and
ava_eval_helper.py).

Boxes arrive padded to a static `max_boxes` per clip with a `box_mask`; the
padded boxes still run through ROI-align and the head, and the loss keeps
the real ones only: sum(per_box * mask) / max(sum(mask), 1).

A train step draws its random numbers (the trunk's drop-path, the head's
dropout) from a seed drawn off the state's generator, sets the LR passed to
it (optax's `inject_hyperparams` role), and gives every trainable tensor
outside the loss's graph a zero gradient before the optimizer's update, as
JAX's gradient tree does: with the ROI head on tap 2 of MViTv2-S, blocks 14
and 15 feed nothing, and `torch.optim.AdamW` would otherwise skip them and
leave out their weight decay, which optax applies. bf16: autocast with fp32
parameters; the BCE runs in fp32 on the bf16 probabilities (in bf16, 1 -
1e-7 rounds to 1 and a saturated probability's log(1 - p) is -inf).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mspi_tpu_torch.models.roi_head import ResNetRoIHead
from mspi_tpu_torch.train import engine
from mspi_tpu_torch.train.optim import set_lr
from mspi_tpu_torch.utils.ava_eval import AVAMeter


class VideoDetector(nn.Module):
    """Feature trunk + ROI head. trunk: any pyramid backbone of
    `mspi_tpu_torch.models.registry`; the head reads pyramid level `tap`
    (2: the stride-16 level, block 13's output for MViTv2-S, 384 channels)."""

    def __init__(self, trunk: nn.Module, dim_in: int, num_classes: int = 80, tap: int = 2,
                 spatial_scale: float = 1.0 / 16, pool_size: int = 7,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.trunk = trunk
        self.tap = tap
        self.head = ResNetRoIHead(dim_in, num_classes, pool_size, spatial_scale, dropout_rate)

    def forward(self, clips: torch.Tensor, boxes: torch.Tensor, box_batch_idx: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.trunk(clips)
        return self.head(feats[self.tap], boxes, box_batch_idx, generator)


@dataclasses.dataclass
class DetTrainState:
    """The detector (its parameters and BatchNorm statistics), its
    optimizer and the generator of the steps' random draws."""

    model: VideoDetector
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


def create_det_state(model: VideoDetector, make_optimizer: Callable, seed: int = 0
                     ) -> DetTrainState:
    """make_optimizer(named parameters) -> the optimizer, e.g.
    `lambda p: torch.optim.AdamW([t for _, t in p], lr=1e-3, weight_decay=0.0)`."""
    return DetTrainState(model, make_optimizer(list(model.named_parameters())),
                         torch.Generator().manual_seed(seed))


def _flatten_boxes(boxes: torch.Tensor):
    """[B, max_boxes, 4] -> ([B*max_boxes, 4], [B*max_boxes] batch index)."""
    B, M = boxes.shape[:2]
    idx = torch.arange(B, device=boxes.device).repeat_interleave(M)
    return boxes.reshape(B * M, 4), idx


def masked_bce(probs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               eps: float = 1e-7) -> torch.Tensor:
    """Mean BCE over the real boxes only (train_net.py's detection loss is
    nn.BCELoss on sigmoid outputs), in fp32."""
    probs = probs.float().clamp(eps, 1 - eps)
    labels = labels.float()
    per_box = -(labels * torch.log(probs) + (1 - labels) * torch.log(1 - probs)).mean(dim=-1)
    mask = mask.to(per_box.dtype)
    return (per_box * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def make_det_train_step(compute_dtype: Optional[torch.dtype] = None):
    """Returns step(state, batch, lr) -> the loss as a float. batch: clips
    [B,T,H,W,3] normalised, boxes [B,M,4], labels [B,M,num_classes],
    box_mask [B,M], on the model's device."""

    def train_step(state: DetTrainState, batch: Mapping[str, torch.Tensor], lr: float) -> float:
        model, opt = state.model, state.optimizer
        model.train()
        gen = torch.Generator().manual_seed(
            int(torch.randint(2 ** 62, (), generator=state.generator)))
        engine._use_generator(model, gen)
        set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        clips = batch["clips"]
        flat_boxes, idx = _flatten_boxes(batch["boxes"])
        with torch.autocast(clips.device.type, dtype=compute_dtype or torch.float32,
                            enabled=compute_dtype is not None):
            probs = model(clips, flat_boxes, idx, gen)
        labels = batch["labels"].reshape(probs.shape[0], -1)
        loss = masked_bce(probs, labels, batch["box_mask"].reshape(-1))
        loss.backward()
        for p in model.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        return loss.item()

    return train_step


def make_det_eval_step(compute_dtype: Optional[torch.dtype] = None):
    """Returns step(state, batch) -> the box probabilities [B*M,
    num_classes] in fp32 (eval mode)."""

    def eval_step(state: DetTrainState, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        model = state.model
        model.eval()
        clips = batch["clips"]
        flat_boxes, idx = _flatten_boxes(batch["boxes"])
        with torch.no_grad(), torch.autocast(clips.device.type,
                                             dtype=compute_dtype or torch.float32,
                                             enabled=compute_dtype is not None):
            return model(clips, flat_boxes, idx).float()

    return eval_step


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_ava_eval(state: DetTrainState, eval_step, batches: Iterable[Mapping],
                 num_classes: int = 80, iou_threshold: float = 0.5,
                 log: Optional[Callable[[str], None]] = None) -> Dict[str, float]:
    """The detection eval loop (train_net.py eval_epoch's detection branch
    and AVAMeter.finalize_metrics): the eval step per batch, predictions
    and ground truth keyed by "{video_idx},{sec:04d}", frame mAP. A box with
    k labels counts as k single-class ground truths, as the official
    evaluator counts it."""
    meter = AVAMeter(num_classes=num_classes, iou_threshold=iou_threshold)
    for batch in batches:
        probs = _host(eval_step(state, batch))
        B, M = batch["boxes"].shape[:2]
        probs = probs.reshape(B, M, -1)
        masks, metadata = _host(batch["box_mask"]).astype(bool), _host(batch["metadata"])
        ori_boxes, all_labels = _host(batch["ori_boxes"]), _host(batch["labels"])
        for b in range(B):
            mask = masks[b]
            if not mask.any():
                continue
            vid, sec = metadata[b][mask.argmax()]
            image_id = f"{int(vid)},{int(sec):04d}"
            boxes = ori_boxes[b][mask]
            meter.update_predictions(image_id, boxes, probs[b][mask])
            gt_boxes, gt_labels = [], []
            for box, lab in zip(boxes, all_labels[b][mask]):
                for cls in np.nonzero(lab)[0]:
                    gt_boxes.append(box)
                    gt_labels.append(cls)
            if gt_boxes:
                meter.update_groundtruth(image_id, np.stack(gt_boxes), np.asarray(gt_labels))
    stats = meter.finalize_metrics()
    if log:
        log(f"AVA eval: mAP={stats['mAP']:.4f} over "
            f"{stats['num_classes_evaluated']} classes")
    return stats
