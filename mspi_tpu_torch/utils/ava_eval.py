"""AVA-style detection evaluation: per-class average precision (frame
mAP). Counterpart of `mspi_tpu/utils/ava_eval.py`, the same numpy code
(reference SlowFast/slowfast/utils/{meters.py AVAMeter,
ava_eval_helper.py}): accumulate per-box class scores and ground-truth
boxes, compute PASCAL-style AP per class at an IoU threshold, report mAP.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] xyxy -> [N,M] IoU."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def average_precision(scores: np.ndarray, matched: np.ndarray, num_gt: int) -> float:
    """PASCAL AP from detection scores and per-detection match flags."""
    if num_gt == 0:
        return float("nan")
    order = np.argsort(-scores)
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # interpolated precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)


class AVAMeter:
    """Accumulates (image_id, boxes, class scores) predictions and GT;
    finalize -> per-class AP at the IoU threshold + mAP."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou = iou_threshold
        self.preds: List[Tuple[str, np.ndarray, np.ndarray]] = []
        self.gts: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def update_predictions(self, image_id: str, boxes: np.ndarray, scores: np.ndarray):
        self.preds.append((image_id, np.asarray(boxes), np.asarray(scores)))

    def update_groundtruth(self, image_id: str, boxes: np.ndarray, labels: np.ndarray):
        self.gts[image_id] = (np.asarray(boxes), np.asarray(labels))

    def finalize_metrics(self) -> Dict[str, float]:
        aps = []
        for cls in range(self.num_classes):
            scores, matches = [], []
            num_gt = 0
            claimed: Dict[str, set] = {}
            # count GT of this class
            for img, (gboxes, glabels) in self.gts.items():
                num_gt += int(np.sum(glabels == cls))
            dets = []
            for img, boxes, cls_scores in self.preds:
                for b, s in zip(boxes, cls_scores[:, cls]):
                    dets.append((s, img, b))
            dets.sort(key=lambda t: -t[0])
            for s, img, box in dets:
                gboxes, glabels = self.gts.get(img, (np.zeros((0, 4)), np.zeros(0)))
                mask = glabels == cls
                cand = gboxes[mask]
                matched = 0.0
                if len(cand):
                    ious = box_iou(box[None], cand)[0]
                    order = np.argsort(-ious)
                    used = claimed.setdefault(f"{img}/{cls}", set())
                    for j in order:
                        if ious[j] >= self.iou and j not in used:
                            used.add(j)
                            matched = 1.0
                            break
                scores.append(s)
                matches.append(matched)
            if num_gt:
                aps.append(average_precision(np.asarray(scores),
                                             np.asarray(matches), num_gt))
        m = float(np.nanmean(aps)) if aps else float("nan")
        return {"mAP": m, "num_classes_evaluated": len(aps)}
