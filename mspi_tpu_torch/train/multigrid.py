"""Multigrid training schedules.

Reference: SlowFast/slowfast/utils/multigrid.py:13-240 (long/short cycle
mutation of (T, HxW, batch)) and datasets/multigrid_helper.py
(ShortCycleBatchSampler).  The short cycle varies the spatial crop every
iteration; the long cycle varies (T, crop) every few epochs with the batch
size rescaled to keep memory constant.

The port's own copy of `mspi_tpu/train/multigrid.py` (plain Python).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

DEFAULT_LONG_CYCLE_FACTORS = ((0.25, 0.5 ** 0.5), (0.5, 0.5 ** 0.5), (0.5, 1.0), (1.0, 1.0))
DEFAULT_SHORT_CYCLE_FACTORS = (0.5, 0.5 ** 0.5)


@dataclass
class MultigridSchedule:
    """Long-cycle schedule planner (multigrid.py:30-160 semantics)."""

    long_cycle_factors: Sequence[Tuple[float, float]] = DEFAULT_LONG_CYCLE_FACTORS
    epoch_factor: float = 1.5

    def long_cycle_shapes(self, base_t: int, base_crop: int, base_batch: int
                          ) -> List[Tuple[int, int, int]]:
        """[(batch, T, crop)] per long-cycle phase, batch scaled to keep
        batch*T*crop^2 roughly constant."""
        shapes = []
        for t_factor, s_factor in self.long_cycle_factors:
            t = max(1, int(round(base_t * t_factor)))
            crop = int(round(base_crop * s_factor))
            crop = crop - crop % 8  # keep conv strides exact
            rel = (base_t * base_crop * base_crop) / (t * crop * crop)
            shapes.append((int(base_batch * rel), t, crop))
        return shapes

    def schedule(self, total_epochs: int, base_t: int, base_crop: int,
                 base_batch: int) -> List[Tuple[int, int, int, int]]:
        """[(start_epoch, batch, T, crop)] covering the run; the final phase
        always runs at base shape (multigrid.py fine-tuning tail)."""
        shapes = self.long_cycle_shapes(base_t, base_crop, base_batch)
        n_phases = len(shapes)
        phase_epochs = max(1, int(total_epochs * self.epoch_factor) // max(n_phases, 1))
        out = []
        epoch = 0
        for shape in shapes:
            out.append((epoch, *shape))
            epoch += phase_epochs
        out.append((epoch, base_batch, base_t, base_crop))
        return out

    def get_current(self, schedule, epoch: int):
        cur = schedule[0]
        for entry in schedule:
            if entry[0] <= epoch:
                cur = entry
        return cur[1:]


def short_cycle_crops(base_crop: int,
                      factors: Sequence[float] = DEFAULT_SHORT_CYCLE_FACTORS
                      ) -> List[int]:
    """Per-iteration crop sizes: [c*f0, c*f1, c] repeating
    (multigrid_helper.py ShortCycleBatchSampler)."""
    crops = [int(round(base_crop * f)) for f in factors]
    crops = [c - c % 8 for c in crops]
    return crops + [base_crop]


def short_cycle_batches(num_samples: int, base_batch: int, base_crop: int,
                        factors: Sequence[float] = DEFAULT_SHORT_CYCLE_FACTORS,
                        rng=None, shuffle: bool = True):
    """ShortCycleBatchSampler (multigrid_helper.py:19-77): iterate sample
    indices in batches whose (batch_size, crop_size) cycles every iteration —
    smaller crops get proportionally bigger batches so per-step pixel count
    stays constant.  Yields (indices, crop_size)."""
    import numpy as np

    crops = short_cycle_crops(base_crop, factors)
    batch_sizes = [max(1, int(round(base_batch * (base_crop / c) ** 2)))
                   for c in crops]
    order = np.arange(num_samples)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    pos = 0
    it = 0
    while pos + batch_sizes[it % len(crops)] <= num_samples:
        b = batch_sizes[it % len(crops)]
        yield order[pos:pos + b], crops[it % len(crops)]
        pos += b
        it += 1
