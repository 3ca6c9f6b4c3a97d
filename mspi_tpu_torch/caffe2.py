"""Caffe2 pickle checkpoints (the SLOWFAST_*.pkl releases) -> torch state dicts.

Counterpart of `mspi_tpu/convert/caffe2.py` (reference
SlowFast/slowfast/utils/checkpoint.py:226-294 and the name grammar of
utils/c2_model_loading.py:9-120). A release is a pickle of
`{"blobs": {name: ndarray}}`; each caffe2 blob name maps to the key of the
reference's pytorch module tree, which the port keeps:

  conv1_w                          stem conv (slow)
  conv1_xy_w                       x3d stem spatial conv
  res_conv1_bn_{s,b,rm,riv}        stem BN
  res{S}_{B}_branch1_w             projection shortcut
  res{S}_{B}_branch1_bn_*          projection BN
  res{S}_{B}_branch2{a,b,c}_w      bottleneck convs
  res{S}_{B}_branch2{a,b,c}_bn_*   bottleneck BNs
  t_...                            the same, fast pathway (pathway1)
  t_pool1_subsample[_bn]_*         s1_fuse conv/bn
  t_res{S}_{B}_branch2c_bn_subsample[_bn]_*   s{S}_fuse conv/bn
  pred_{w,b}                       classifier head (dropped for features)
  *_momentum / lr / model_iter     solver state (dropped)

`load_caffe2_pickle` returns numpy values; the checkpoint loader turns them
into tensors in the model's dtype. Unpickling can run code: load only
releases from a source you trust, as with `torch.load(weights_only=False)`.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Optional, Tuple

import numpy as np

_SUFFIX = {
    "w": "weight",
    "b": "bias",
    "bn_s": "bn:weight",
    "bn_b": "bn:bias",
    "bn_rm": "bn:running_mean",
    "bn_riv": "bn:running_var",
}

_DROP_SUBSTR = ("momentum", "lr", "model_iter")


def _split_suffix(name: str) -> Tuple[Optional[str], Optional[str]]:
    """(base, kind) where kind is a _SUFFIX key, longest match first."""
    for suf in ("bn_riv", "bn_rm", "bn_s", "bn_b", "w", "b"):
        if name.endswith("_" + suf):
            return name[: -(len(suf) + 1)], suf
    return None, None


def caffe2_blob_to_torch_key(blob: str) -> Optional[str]:
    """One caffe2 blob name -> its pytorch state_dict key, or None for solver
    state and the classifier head."""
    if any(s in blob for s in _DROP_SUBSTR):
        return None
    if blob.startswith("pred_"):
        return None  # classifier head; the saliency backbones never use it

    # fusion blobs (fast->slow lateral convs)
    m = re.fullmatch(r"t_pool1_subsample(_bn)?_(w|b|bn_s|bn_b|bn_rm|bn_riv|s|rm|riv)", blob)
    if m:
        return _fuse_key(1, m.group(1) is not None, m.group(2))
    m = re.fullmatch(r"t_res(\d+)_\d+_branch2c_bn_subsample(_bn)?_(w|b|s|rm|riv)", blob)
    if m:
        return _fuse_key(int(m.group(1)), m.group(2) is not None, m.group(3))

    pathway, name = 0, blob
    if name.startswith("t_"):
        pathway, name = 1, name[2:]

    base, suf = _split_suffix(name)
    if suf is None:
        return None
    leaf = _SUFFIX[suf]

    # stem
    if base == "conv1":
        return f"s1.pathway{pathway}_stem.conv.{leaf}"
    if base == "conv1_xy":
        return f"s1.pathway{pathway}_stem.conv_xy.{leaf}"
    if base == "res_conv1" and leaf.startswith("bn:"):
        return f"s1.pathway{pathway}_stem.bn.{leaf.split(':')[1]}"

    # residual blocks
    m = re.fullmatch(r"res(\d+)_(\d+)_branch(\d+)([a-z]?)", base)
    if m:
        stage, block, branch, conv = m.groups()
        prefix = f"s{stage}.pathway{pathway}_res{block}"
        if branch == "1":
            if leaf.startswith("bn:"):
                return f"{prefix}.branch1_bn.{leaf.split(':')[1]}"
            return f"{prefix}.branch1.{leaf}"
        if leaf.startswith("bn:"):
            return f"{prefix}.branch2.{conv}_bn.{leaf.split(':')[1]}"
        return f"{prefix}.branch2.{conv}.{leaf}"
    return None


def _fuse_key(stage: int, is_bn: bool, suf: str) -> str:
    leaf = {"w": "weight", "b": "bias", "s": "weight", "rm": "running_mean",
            "riv": "running_var", "bn_s": "weight", "bn_b": "bias",
            "bn_rm": "running_mean", "bn_riv": "running_var"}[suf]
    mod = "bn" if is_bn else "conv_f2s"
    return f"s{stage}_fuse.{mod}.{leaf}"


def load_caffe2_pickle(path: str) -> Dict[str, np.ndarray]:
    """caffe2 pkl -> torch-style state_dict with numpy values."""
    with open(path, "rb") as f:
        blobs = pickle.load(f, encoding="latin1")["blobs"]
    out = {}
    for blob_name, value in blobs.items():
        key = caffe2_blob_to_torch_key(blob_name)
        if key is not None:
            out[key] = np.asarray(value)
    return out
