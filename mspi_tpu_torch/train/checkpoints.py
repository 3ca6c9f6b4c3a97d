"""Checkpoint save / restore and the released encoder weights.

Counterpart of `mspi_tpu/train/checkpoints.py`: `ckpt_{epoch}` files under a
checkpoint directory (written with `torch.save`) hold the model's state
dict (parameters, frozen parameters and BatchNorm statistics), the AdamW
state, the epoch and the drop-path generator's state; `latest_checkpoint`
finds the newest for auto-resume. `load_pretrained_encoders` loads the
released torch encoder checkpoints straight into their submodules (the
port keeps the reference's parameter names) and skips missing files.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from mspi_tpu_torch.config import MSPIConfig
from mspi_tpu_torch.train.engine import TrainState


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int) -> str:
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_{epoch}"))
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "param_names": list(state.param_names), "epoch": int(epoch),
                "generator": state.generator.get_state()}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ckpt_{epoch} with the highest epoch, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch, best = int(m.group(1)), os.path.join(ckpt_dir, name)
    return best


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Load a checkpoint into `state` in place; returns (state, epoch)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if blob["param_names"] != list(state.param_names):
        raise ValueError(f"{path}: trainable parameters differ from this model's")
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.generator.set_state(blob["generator"])
    state.epoch = int(blob["epoch"])
    return state, state.epoch


def load_torch_checkpoint(path: str):
    """A state dict out of the checkpoint containers the reference uses."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict):
        for key in ("model_state", "state_dict", "model"):
            if isinstance(blob.get(key), dict):
                return blob[key]
    return blob


def load_pretrained_encoders(cfg: MSPIConfig, model: torch.nn.Module) -> torch.nn.Module:
    """Load the released audio, image-saliency and motion encoder weights
    into `audnet`, `image_encoder` and `visnet` when their files exist;
    missing files are skipped (random initialisation stays). mmaction
    VideoSwin checkpoints prefix the trunk with 'backbone.'
    (video_swin_transformer.py:593-605), which is stripped for
    `videoswins`."""
    mc = cfg.model
    for path, name in ((mc.audio_encoder_weight, "audnet"),
                       (mc.image_saliency_encoder_weight, "image_encoder"),
                       (mc.motion_encoder_weight, "visnet")):
        if path and os.path.exists(path) and hasattr(model, name):
            module = getattr(model, name)
            sd = load_torch_checkpoint(path)
            if name == "visnet" and mc.motion_encoder == "videoswins":
                sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v
                      for k, v in sd.items()}
            ref = next(module.parameters())
            module.load_state_dict({k: v.to(ref.dtype) if v.is_floating_point() else v
                                    for k, v in sd.items()}, strict=False)
    return model
