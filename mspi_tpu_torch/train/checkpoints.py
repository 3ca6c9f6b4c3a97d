"""Checkpoint save / restore and the released encoder weights.

Counterpart of `mspi_tpu/train/checkpoints.py`: `ckpt_{epoch}` files under a
checkpoint directory (written with `torch.save`) hold the model's state
dict (parameters, frozen parameters and BatchNorm statistics), the AdamW
state, the epoch and the drop-path generator's state; `latest_checkpoint`
finds the newest for auto-resume. `load_pretrained_encoders` loads the
released encoder checkpoints straight into their submodules (the port keeps
the reference's parameter names) and skips missing files: torch files, and
caffe2 pickles (`.pkl`, and every motion-encoder file of `slowfast4x16`)
through `mspi_tpu_torch.caffe2`. Its merges, and the inference CLI's, are
non-strict and say what they left out (`load_non_strict`).

With a mesh, rank 0 writes the one-device form: the SyncBlock's split
tensors (and their AdamW moments) gathered over the model group, so any
run reads the file; on resume each model rank takes its part of them.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from mspi_tpu_torch.config import MSPIConfig
from mspi_tpu_torch.train.engine import TrainState


def _moments(opt_sd: dict, names, fn) -> dict:
    """opt_sd with its parameter-shaped state tensors (AdamW's moments)
    passed through fn, a map of {parameter name: tensor}."""
    state = {i: dict(st) for i, st in opt_sd["state"].items()}
    keys = {k for st in state.values() for k, v in st.items() if torch.is_tensor(v) and v.dim()}
    for key in sorted(keys):
        got = fn({names[i]: st[key] for i, st in state.items()})
        for i, st in state.items():
            st[key] = got[names[i]]
    return {**opt_sd, "state": state}


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, mesh=None) -> Optional[str]:
    """Write ckpt_{epoch}; with a mesh, every rank of data index 0 calls it
    (the gather over the model group) and rank 0 writes."""
    model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
    if mesh is not None:
        if mesh.data_rank:
            return None
        if mesh.tp > 1:
            from mspi_tpu_torch.parallel.tensor_parallel import gather_sync_block

            model_sd = gather_sync_block(state.model, mesh, model_sd)
            opt_sd = _moments(opt_sd, state.param_names,
                              lambda t: gather_sync_block(state.model, mesh, t))
        if mesh.rank:
            return None
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_{epoch}"))
    tmp = path + ".tmp"
    torch.save({"model": model_sd, "optimizer": opt_sd,
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


def restore_checkpoint(path: str, state: TrainState, mesh=None) -> Tuple[TrainState, int]:
    """Load a checkpoint into `state` in place (with a mesh of tp > 1, each
    split tensor's part for this model rank); returns (state, epoch)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if blob["param_names"] != list(state.param_names):
        raise ValueError(f"{path}: trainable parameters differ from this model's")
    model_sd, opt_sd = blob["model"], blob["optimizer"]
    if mesh is not None and mesh.tp > 1:
        from mspi_tpu_torch.parallel.tensor_parallel import split_whole

        model_sd = split_whole(state.model, mesh, model_sd)
        opt_sd = _moments(opt_sd, state.param_names, lambda t: split_whole(state.model, mesh, t))
    state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(opt_sd)
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


def load_non_strict(module: torch.nn.Module, sd) -> None:
    """`module.load_state_dict(sd, strict=False)` that prints, as the JAX
    package's `merge_converted(strict=False)` does, how many checkpoint keys
    went unused, how many of the model's tensors were left at init and the
    first unused key, when either count is not 0. BatchNorm's
    `num_batches_tracked`, which JAX trees do not hold, is not counted.
    Shapes must still match."""
    result = module.load_state_dict(sd, strict=False)
    unexpected = list(result.unexpected_keys)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if unexpected or missing:
        print(f"[convert] non-strict merge: {len(unexpected)} checkpoint keys "
              f"unused, {len(missing)} model leaves left at init"
              + (f"; first unused: {unexpected[0]}" if unexpected else ""))


def load_pretrained_encoders(cfg: MSPIConfig, model: torch.nn.Module) -> torch.nn.Module:
    """Load the released audio, image-saliency and motion encoder weights
    into `audnet`, `image_encoder` and `visnet` when their files exist;
    missing files are skipped (random initialisation stays). A `.pkl` file,
    and every motion-encoder file of `slowfast4x16`, is a caffe2 pickle
    (`caffe2.load_caffe2_pickle`). mmaction VideoSwin checkpoints prefix the
    trunk with 'backbone.' (video_swin_transformer.py:593-605), which is
    stripped for `videoswins`."""
    from mspi_tpu_torch.caffe2 import load_caffe2_pickle

    mc = cfg.model
    for path, name in ((mc.audio_encoder_weight, "audnet"),
                       (mc.image_saliency_encoder_weight, "image_encoder"),
                       (mc.motion_encoder_weight, "visnet")):
        if path and os.path.exists(path) and hasattr(model, name):
            module = getattr(model, name)
            if (name == "visnet" and mc.motion_encoder == "slowfast4x16") or path.endswith(".pkl"):
                sd = {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in load_caffe2_pickle(path).items()}
            else:
                sd = load_torch_checkpoint(path)
            if name == "visnet" and mc.motion_encoder == "videoswins":
                sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v
                      for k, v in sd.items()}
            ref = next(module.parameters())
            load_non_strict(module, {k: v.to(ref.dtype) if v.is_floating_point() else v
                                     for k, v in sd.items()})
    return model
