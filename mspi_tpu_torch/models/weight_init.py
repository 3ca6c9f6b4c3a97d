"""Weight initialisation for classifiers trained from scratch: counterpart
of `mspi_tpu/models/weight_init.py` (reference SlowFast
weight_init_helper.py, RESNET.ZERO_INIT_FINAL_BN): the scale of each
residual branch's last BatchNorm starts at zero, so every block begins as
the identity. The last BatchNorm is `c_bn` where the transform has one
(bottleneck, X3D, CSN, (2+1)D), else `b_bn` (basic)."""

from __future__ import annotations

import torch
from torch import nn


def zero_init_final_bn(model: nn.Module) -> nn.Module:
    """Zero, in place, the weight of the last BatchNorm of every module
    named `branch2` (a ResBlock's transform)."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.rsplit(".", 1)[-1] != "branch2":
                continue
            final = getattr(m, "c_bn", None) or getattr(m, "b_bn", None)
            if final is not None:
                final.weight.zero_()
    return model
