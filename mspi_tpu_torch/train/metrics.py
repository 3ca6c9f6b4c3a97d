"""Saliency metrics as batched torch functions, plus the host-side numpy
AUCs.

Counterpart of `mspi_tpu/train/metrics.py` (the reference's
utils/compute_saliency_metrics.py conventions): per-image sum-normalisation
with eps = 2.2204e-16 for KLD and IG, min-max then sum normalisation for
SIM, unbiased (ddof = 1) std for CC and NSS. The torch metrics take [B,H,W]
maps on any device and return a scalar tensor; the threshold-sweep AUCs are
data-dependent sweeps and stay host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 2.2204e-16  # MATLAB eps, as in the reference


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _sum_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / x.sum(dim=1, keepdim=True)


def kldiv(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """KL divergence between per-image sum-normalised maps."""
    s = _sum_normalise(_flat(s_map))
    g = _sum_normalise(_flat(gt))
    return (g * torch.log(EPS + g / (s + EPS))).sum(dim=1).mean()


def normalize_map(s_map: torch.Tensor) -> torch.Tensor:
    """Per-image min-max normalisation (MIT code convention)."""
    s = _flat(s_map)
    mn = s.min(dim=1, keepdim=True).values
    mx = s.max(dim=1, keepdim=True).values
    return ((s - mn) / (mx - mn)).reshape(s_map.shape)


def similarity(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Histogram intersection of min-max + sum normalised maps."""
    s = _sum_normalise(_flat(normalize_map(s_map)))
    g = _sum_normalise(_flat(normalize_map(gt)))
    return torch.minimum(s, g).sum(dim=1).mean()


def _standardise(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return (x - x.mean(dim=1, keepdim=True)) / (x.std(dim=1, keepdim=True) + eps)


def cc(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pearson correlation after per-image standardisation (ddof = 1)."""
    s = _standardise(_flat(s_map))
    g = _standardise(_flat(gt))
    ab = (s * g).sum(dim=1)
    return (ab / torch.sqrt((s * s).sum(dim=1) * (g * g).sum(dim=1))).mean()


def nss(s_map: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Normalized Scanpath Saliency: standardised map averaged at fixations."""
    s = _standardise(_flat(s_map), EPS)
    g = _flat(gt)
    return ((s * g).sum(dim=1) / g.sum(dim=1)).mean()


def ig(s_map: torch.Tensor, gt: torch.Tensor, baseline: torch.Tensor) -> torch.Tensor:
    """Information gain of s_map over a baseline at GT locations."""
    s = _sum_normalise(_flat(s_map))
    g = _sum_normalise(_flat(gt))
    b = _sum_normalise(_flat(baseline))
    return (g * (torch.log(EPS + s) - torch.log(EPS + b))).sum(dim=1).mean()


# --- host-side AUCs (offline evaluation, as in the reference) ---


def auc_judd(saliency_map: np.ndarray, fixation_map: np.ndarray, jitter: bool = True,
             rng: np.random.Generator | None = None) -> float:
    """AUC-Judd: threshold sweep at each fixated saliency value."""
    saliency_map = np.asarray(saliency_map, dtype=np.float64)
    fixation_map = np.asarray(fixation_map)
    if saliency_map.ndim == 3:
        saliency_map = saliency_map[0]
        fixation_map = fixation_map[0]
    if not fixation_map.any():
        return float("nan")
    if saliency_map.shape != fixation_map.shape:
        import cv2

        saliency_map = cv2.resize(saliency_map, (fixation_map.shape[1], fixation_map.shape[0]))
    if jitter:
        rng = rng or np.random.default_rng()
        saliency_map = saliency_map + rng.random(saliency_map.shape) / 1e7
    saliency_map = (saliency_map - saliency_map.min()) / (saliency_map.max() - saliency_map.min())

    s = saliency_map.ravel()
    f = fixation_map.ravel()
    sth = np.sort(s[f > 0])[::-1]
    n_fix = len(sth)
    n_pix = len(s)
    # for the i-th highest fixated value, count the saliency values >= it
    order = np.sort(s)
    above = n_pix - np.searchsorted(order, sth, side="left")
    tp = np.concatenate([[0.0], (np.arange(n_fix) + 1) / n_fix, [1.0]])
    fp = np.concatenate([[0.0], (above - np.arange(n_fix)) / (n_pix - n_fix), [1.0]])
    return float(np.trapezoid(tp, x=fp))


def auc_shuff(s_map: np.ndarray, gt: np.ndarray, other_map: np.ndarray,
              splits: int = 100, rng: np.random.Generator | None = None) -> float:
    """Shuffled AUC with negatives sampled from fixations of other images."""
    rng = rng or np.random.default_rng()
    s_map = np.asarray(s_map, dtype=np.float64)
    if s_map.ndim == 3:
        s_map, gt, other_map = s_map[0], gt[0], other_map[0]
    s_map = (s_map - s_map.min()) / (s_map.max() - s_map.min())
    gt = np.asarray(gt)
    other_map = np.asarray(other_map)

    num_fixations = np.sum(gt)
    x, y = np.where(other_map == 1)
    other_fixs = x * other_map.shape[0] + y
    ind = len(other_fixs)

    thresholds = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
    aucs = []
    for _ in range(splits):
        perm = rng.permutation(ind)
        flat_idx = other_fixs[perm]
        r_sal = s_map[flat_idx % s_map.shape[0] - 1, (flat_idx / s_map.shape[0]).astype(int)]
        area = [(0.0, 0.0)]
        for thresh in thresholds:
            temp = (s_map >= thresh).astype(np.float64)
            num_overlap = np.sum((temp + gt) == 2)
            tp = num_overlap / (num_fixations * 1.0)
            fp = np.sum(r_sal > thresh) / (num_fixations * 1.0)
            area.append((round(tp, 4), round(fp, 4)))
        area.append((1.0, 1.0))
        area.sort(key=lambda t: t[0])
        tp_list = np.array([a[0] for a in area])
        fp_list = np.array([a[1] for a in area])
        aucs.append(np.trapezoid(tp_list, fp_list))
    return float(np.mean(aucs))
