"""Model visualisation: Grad-CAM, weight and activation statistics, scalar
logging and the prediction overlay. Counterpart of
`mspi_tpu/utils/visualization.py` (reference SlowFast/slowfast/
visualization/gradcam_utils.py:12-178, visualization/utils.py's weight
and activation statistics, tensorboard_vis.py:20-429, and
video_visualizer.py:349-641).

Grad-CAM: the zoo classifiers split into backbone features and a head, so
the CAM weights are the gradient of the class score with respect to the
tapped feature map alone: the backbone runs under `no_grad`, and
`torch.autograd.grad` differentiates the head on the tap.

`activation_stats` captures module outputs with forward hooks and names each
as the JAX function names flax's `capture_intermediates` ("backbone/blocks/
layers_0/__call__/[0]/[0]"), so the modules the two packages share carry the
same names.
Scalars are written as JSONL; histograms and statistics with numpy.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn


def grad_cam(backbone_apply: Callable, head_apply: Callable, clips: torch.Tensor,
             class_idx: Optional[torch.Tensor] = None, tap: int = -1):
    """Grad-CAM heatmaps for a video classifier.

    backbone_apply(clips) -> list of [B,T,H,W,C] feature maps;
    head_apply(feats) -> [B, num_classes] scores.
    Returns ([B,T,H,W] maps min-max normalised per sample, the scores)
    (gradcam_utils.py:66-131: ReLU(sum_c w_c A_c), w_c the mean gradient
    over T, H, W); the class is the argmax unless class_idx [B] is given.
    """
    with torch.no_grad():
        feats = list(backbone_apply(clips))
    target = feats[tap].detach().requires_grad_(True)
    feats[tap] = target
    with torch.enable_grad():
        scores = head_apply(feats)
        idx = torch.argmax(scores, dim=-1) if class_idx is None else class_idx
        score = torch.gather(scores, -1, idx.reshape(-1, 1).to(scores.device)).sum()
        (grads,) = torch.autograd.grad(score, target, allow_unused=True)
    if grads is None:  # a tap the head does not read: zero gradients, as JAX gives
        grads = torch.zeros_like(target)
    weights = grads.mean(dim=(1, 2, 3), keepdim=True)  # GAP over T, H, W
    cam = torch.relu((weights * target.detach()).sum(dim=-1))  # [B,T,H,W]
    flat = cam.reshape(cam.shape[0], -1)
    mn = flat.amin(dim=1)[:, None, None, None]
    mx = flat.amax(dim=1)[:, None, None, None]
    return (cam - mn) / torch.clamp_min(mx - mn, 1e-12), scores.detach()


def _stats(arr: np.ndarray, extremes: bool) -> Dict[str, object]:
    out = {"shape": list(arr.shape), "mean": float(arr.mean()), "std": float(arr.std())}
    if extremes:
        out.update(min=float(arr.min()), max=float(arr.max()))
    return out


def weight_stats(model: nn.Module) -> Dict[str, Dict[str, float]]:
    """Per-parameter weight statistics (visualization/utils.py get_layer
    stats), keyed by the torch names."""
    return {name: _stats(t.detach().float().cpu().numpy(), True)
            for name, t in model.named_parameters()}


def flax_name(torch_name: str) -> str:
    """A torch module name as flax's `capture_intermediates` names the
    module's call: "backbone.blocks.0" -> "backbone/blocks/layers_0/__call__"
    (the root module: "__call__")."""
    parts = [f"layers_{p}" if p.isdigit() else p for p in torch_name.split(".") if p]
    return "/".join(parts + ["__call__"])


def _output_leaves(prefix: str, value):
    """(name, array) of a module output's tensors and numbers, one "/[i]"
    per tuple level, as flax's tree paths print."""
    if isinstance(value, torch.Tensor):
        yield prefix, value.detach().float().cpu().numpy()
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield prefix, np.asarray(value)
    elif isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            yield from _output_leaves(f"{prefix}/[{i}]", v)


def activation_stats(model: nn.Module, *args, filter_fn=None, **kwargs):
    """Run model(*args, **kwargs) and summarise every module's output
    (shape, mean, std of each tensor and number in it) by forward hooks,
    named as the JAX function names the captured intermediates: `flax_name`
    + "/[0]", then "/[i]" per element of a tuple output."""
    out = {}

    def hook_for(name):
        def hook(module, inputs, output):
            for leaf, arr in _output_leaves(flax_name(name) + "/[0]", output):
                if filter_fn and not filter_fn(leaf):
                    continue
                out[leaf] = _stats(arr, False)
        return hook

    handles = [m.register_forward_hook(hook_for(n)) for n, m in model.named_modules()]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return out


class ScalarWriter:
    """JSONL scalar writer with TensorBoard-compatible layout
    (tensorboard_vis.py add_scalars semantics)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")

    def add_scalars(self, scalars: Dict[str, float], global_step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": global_step, "time": time.time(),
                                **{k: float(v) for k, v in scalars.items()}}) + "\n")

    def add_histogram(self, name: str, values, global_step: int, bins: int = 32):
        hist, edges = np.histogram(np.asarray(values).ravel(), bins=bins)
        with open(os.path.join(self.log_dir, "histograms.jsonl"), "a") as f:
            f.write(json.dumps({"step": global_step, "name": name,
                                "hist": hist.tolist(),
                                "edges": edges.tolist()}) + "\n")

    def plot_confusion_matrix(self, preds: np.ndarray, labels: np.ndarray,
                              num_classes: int, global_step: int):
        cm = np.zeros((num_classes, num_classes), dtype=np.int64)
        for p, l in zip(preds, labels):
            cm[int(l), int(p)] += 1
        np.save(os.path.join(self.log_dir, f"confusion_{global_step}.npy"), cm)
        # rendered figure alongside the raw matrix (reference
        # tensorboard_vis.py:165-230 draws the matplotlib figure)
        try:
            import cv2

            from mspi_tpu_torch.utils.tensorboard import _render_confusion_matrix

            img = _render_confusion_matrix(cm)
            cv2.imwrite(os.path.join(self.log_dir,
                                     f"confusion_{global_step}.png"),
                        img[:, :, ::-1])
        except ImportError:
            pass
        return cm

    def close(self):
        pass


class VideoVisualizer:
    """Prediction / AVA-box overlay renderer (reference
    SlowFast/slowfast/visualization/video_visualizer.py:349-641).

    PIL-based (no matplotlib dependency): per-class colors come from an HSV
    wheel, predictions are picked by "top-k" or "thres" mode, and boxes are
    drawn with their class labels on uint8 RGB frames.
    """

    def __init__(self, num_classes: int, class_names=None, top_k: int = 1,
                 thres: float = 0.7, mode: str = "top-k"):
        assert mode in ("top-k", "thres"), mode
        self.num_classes = num_classes
        if isinstance(class_names, str):  # json {classname: id}
            import json

            with open(class_names) as f:
                mapping = json.load(f)
            class_names = [None] * num_classes
            for name, i in mapping.items():
                if 0 <= int(i) < num_classes:
                    class_names[int(i)] = name
        self.class_names = class_names or [str(i) for i in range(num_classes)]
        self.top_k = top_k
        self.thres = thres
        self.mode = mode

    def _color(self, class_id: int):
        import colorsys

        r, g, b = colorsys.hsv_to_rgb(class_id / max(self.num_classes, 1), 0.9, 1.0)
        return int(r * 255), int(g * 255), int(b * 255)

    def _pick(self, scores: np.ndarray):
        scores = np.asarray(scores)
        if self.mode == "top-k":
            ids = np.argsort(-scores)[: self.top_k]
        else:
            ids = np.nonzero(scores >= self.thres)[0]
        return [(int(i), float(scores[i])) for i in ids]

    def draw_one_frame(self, frame: np.ndarray, preds: np.ndarray,
                       bboxes=None) -> np.ndarray:
        """frame: [H,W,3] uint8; preds: [num_boxes, C] (or [C] clip-level);
        bboxes: [num_boxes, 4] (x1,y1,x2,y2) or None."""
        from PIL import Image, ImageDraw

        img = Image.fromarray(np.asarray(frame).astype(np.uint8))
        draw = ImageDraw.Draw(img)
        preds = np.atleast_2d(np.asarray(preds))
        if bboxes is None:
            y = 2
            for cid, score in self._pick(preds[0]):
                draw.text((2, y), f"{self.class_names[cid]}: {score:.2f}",
                          fill=self._color(cid))
                y += 11
        else:
            for box, sc in zip(np.asarray(bboxes), preds):
                picks = self._pick(sc)
                color = self._color(picks[0][0]) if picks else (255, 255, 255)
                draw.rectangle([float(box[0]), float(box[1]),
                                float(box[2]), float(box[3])],
                               outline=color, width=2)
                y = float(box[1]) + 2
                for cid, score in picks:
                    draw.text((float(box[0]) + 2, y),
                              f"{self.class_names[cid]}: {score:.2f}",
                              fill=self._color(cid))
                    y += 11
        return np.asarray(img)

    def draw_clip(self, frames: np.ndarray, preds: np.ndarray, bboxes=None,
                  keyframe_idx=None) -> np.ndarray:
        """frames: [T,H,W,3] uint8 -> same, annotated.  Boxes are drawn on
        every frame (the reference repeats the keyframe detections across
        the clip); text only on the keyframe if given."""
        out = []
        for t, frame in enumerate(np.asarray(frames)):
            if bboxes is not None:
                out.append(self.draw_one_frame(frame, preds, bboxes))
            elif keyframe_idx is None or t == keyframe_idx:
                out.append(self.draw_one_frame(frame, preds))
            else:
                out.append(np.asarray(frame).astype(np.uint8))
        return np.stack(out)
