"""Training / validation / test meters for the video-classification surface.

Reference: SlowFast/slowfast/utils/meters.py:46-928 (TrainMeter, ValMeter,
TestMeter with multi-view ensembling, EpochTimer) and
SlowFast/slowfast/utils/metrics.py:9-55 (top-k errors).

The port's own copy (host numpy): the trainer hands it values already
averaged over the data-parallel ranks.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

import numpy as np


def topk_correct(preds: np.ndarray, labels: np.ndarray, ks) -> List[float]:
    """Number of top-k correct predictions (metrics.py:9-34)."""
    order = np.argsort(-preds, axis=1)[:, : max(ks)]
    hits = order == labels[:, None]
    return [float(hits[:, :k].sum()) for k in ks]


def topk_errors(preds, labels, ks):
    n = preds.shape[0]
    return [(1.0 - c / n) * 100.0 for c in topk_correct(preds, labels, ks)]


def topk_accuracies(preds, labels, ks):
    n = preds.shape[0]
    return [c / n * 100.0 for c in topk_correct(preds, labels, ks)]


class ScalarMeter:
    def __init__(self, window_size: int = 10):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_global_avg(self):
        return self.total / self.count if self.count else 0.0


class TrainMeter:
    """Per-epoch training statistics (meters.py:429-564); `log` takes its
    line every log_period iterations."""

    def __init__(self, epoch_iters: int, log_period: int = 10, log=print):
        self.epoch_iters = epoch_iters
        self.log_period = log_period
        self.log = log
        self.loss = ScalarMeter(log_period)
        self.lr = 0.0
        self.mb_top1_err = ScalarMeter(log_period)
        self.mb_top5_err = ScalarMeter(log_period)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.loss_total = 0.0
        self._start = time.time()

    def reset(self):
        self.__init__(self.epoch_iters, self.log_period, self.log)

    def update_stats(self, top1_err, top5_err, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        if top1_err is not None:
            self.mb_top1_err.add_value(top1_err)
            self.mb_top5_err.add_value(top5_err)
            self.num_top1_mis += top1_err * mb_size / 100.0
            self.num_top5_mis += top5_err * mb_size / 100.0

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.log_period:
            return
        self.log(f"train e{cur_epoch} it{cur_iter + 1}/{self.epoch_iters} "
                 f"loss {self.loss.get_win_median():.4f} lr {self.lr:.2e} "
                 f"top1_err {self.mb_top1_err.get_win_median():.2f}")

    def get_epoch_stats(self, cur_epoch) -> Dict:
        stats = {"epoch": cur_epoch,
                 "loss": self.loss_total / max(self.num_samples, 1),
                 "lr": self.lr,
                 "time": time.time() - self._start}
        if self.num_samples:
            stats["top1_err"] = self.num_top1_mis / self.num_samples * 100.0
            stats["top5_err"] = self.num_top5_mis / self.num_samples * 100.0
        return stats


class ValMeter:
    """Validation statistics (meters.py:566-686)."""

    def __init__(self, max_iter: int, log_period: int = 10):
        self.max_iter = max_iter
        self.log_period = log_period
        self.mb_top1_err = ScalarMeter(log_period)
        self.mb_top5_err = ScalarMeter(log_period)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.min_top1_err = 100.0

    def reset(self):
        log = self.min_top1_err
        self.__init__(self.max_iter, self.log_period)
        self.min_top1_err = log

    def update_stats(self, top1_err, top5_err, mb_size):
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size / 100.0
        self.num_top5_mis += top5_err * mb_size / 100.0
        self.num_samples += mb_size

    def get_epoch_stats(self, cur_epoch) -> Dict:
        top1 = self.num_top1_mis / max(self.num_samples, 1) * 100.0
        self.min_top1_err = min(self.min_top1_err, top1)
        return {"epoch": cur_epoch, "top1_err": top1,
                "top5_err": self.num_top5_mis / max(self.num_samples, 1) * 100.0,
                "min_top1_err": self.min_top1_err}


class TestMeter:
    """Multi-view test-time ensembling (meters.py:247-423): accumulate
    per-clip predictions into per-video scores (sum or max), then top-k."""

    def __init__(self, num_videos: int, num_clips: int, num_cls: int,
                 ensemble_method: str = "sum"):
        assert ensemble_method in ("sum", "max")
        self.num_clips = num_clips
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), dtype=np.float32)
        self.video_labels = np.zeros(num_videos, dtype=np.int64)
        self.clip_count = np.zeros(num_videos, dtype=np.int64)

    def update_stats(self, preds: np.ndarray, labels: np.ndarray, clip_ids: np.ndarray):
        for i, clip_id in enumerate(clip_ids):
            vid = int(clip_id) // self.num_clips
            if self.clip_count[vid]:
                assert self.video_labels[vid] == labels[i]
            self.video_labels[vid] = labels[i]
            if self.ensemble_method == "sum":
                self.video_preds[vid] += preds[i]
            else:
                self.video_preds[vid] = np.maximum(self.video_preds[vid], preds[i])
            self.clip_count[vid] += 1

    def finalize_metrics(self, ks=(1, 5)) -> Dict:
        if not all(self.clip_count == self.num_clips):
            missing = int(np.sum(self.clip_count != self.num_clips))
            print(f"[test] warning: {missing} videos with incomplete clips")
        accs = topk_accuracies(self.video_preds, self.video_labels, ks)
        return {f"top{k}_acc": a for k, a in zip(ks, accs)}


class EpochTimer:
    """Epoch duration tracking (meters.py:876-928)."""

    def __init__(self):
        self.epoch_durations: List[float] = []
        self._start = None

    def epoch_tic(self):
        self._start = time.time()

    def epoch_toc(self):
        self.epoch_durations.append(time.time() - self._start)

    def last_epoch_time(self):
        return self.epoch_durations[-1]

    def avg_epoch_time(self):
        return float(np.mean(self.epoch_durations))

    def median_epoch_time(self):
        return float(np.median(self.epoch_durations))
