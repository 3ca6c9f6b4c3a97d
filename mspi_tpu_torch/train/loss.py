"""Saliency training loss: counterpart of `mspi_tpu/train/loss.py`.

SalLoss = KLD(exp(pred), gt) - CC(exp(pred), gt), and - 0.1 * NSS when
fixations are given (the reference never passes them in training). The
component metrics come back in an aux dict of scalar tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mspi_tpu_torch.train.metrics import cc, kldiv, nss, similarity


def sal_loss(log_pred: torch.Tensor, targets: torch.Tensor,
             fixations: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """log_pred: [B,H,W] log-probability map (the model output); targets
    [B,H,W]. Returns (loss, aux) with aux = {kl, cc, sim[, nss], loss}."""
    pred = torch.exp(log_pred)
    kl_loss = kldiv(pred, targets)
    cc_loss = cc(pred, targets)
    aux = {"kl": kl_loss, "cc": cc_loss, "sim": similarity(pred, targets)}
    if fixations is None:
        loss = kl_loss - cc_loss
    else:
        aux["nss"] = nss(pred, fixations)
        loss = kl_loss - cc_loss - 0.1 * aux["nss"]
    aux["loss"] = loss
    return loss, aux
