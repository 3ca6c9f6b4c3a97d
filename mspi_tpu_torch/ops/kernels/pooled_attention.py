"""Attention kernels: K1 `attention_rel` (MViT pooled attention with the
decomposed rel-pos bias) and K4 `self_attention` (SyncBlock packed
multi-head self-attention).

Counterparts of `mspi_tpu/ops/pallas/pooled_attention.py::
fused_attention_rel` and `::fused_self_attention`. Kernel sources:
`mspi_tpu_torch/csrc/attention_rel.cu`, `csrc/self_attention.cu` and their
shared flash body `csrc/flash_attention.cuh`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mspi_tpu_torch.ops import kernels

SUPPORTED_D = (96, 128)  # MViT heads, SyncBlock heads


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 path loads token rows 16 bytes at a time."""
    if tensors[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 operands must be 16-byte aligned")


def key_expansion(k_shape: Sequence[int]) -> np.ndarray:
    """The static 0/1 expansion E [Nk, kt+kh+kw] of the flat key index
    (row-major t, h, w) onto the rel columns t | h | w — the transpose of
    `mspi_tpu.models.mvit._onehot_rows` stacked over t, h, w."""
    kt, kh, kw = k_shape
    idx = np.arange(kt * kh * kw)
    E = np.zeros((idx.size, kt + kh + kw), np.float32)
    E[idx, idx // (kh * kw)] = 1.0
    E[idx, kt + (idx // kw) % kh] = 1.0
    E[idx, kt + kh + idx % kw] = 1.0
    return E


def attention_rel_reference(q, k, v, rel, k_shape, scale: float) -> torch.Tensor:
    """Plain version: softmax(scale * q k^T + rel E^T) v in fp32."""
    E = torch.from_numpy(key_expansion(k_shape)).to(q.device)
    s = scale * q.float() @ k.float().transpose(-1, -2) + rel.float() @ E.T
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def attention_rel(q, k, v, rel, k_shape, scale: float) -> torch.Tensor:
    """K1. q [B,H,Nq,D], k/v [B,H,Nk,D] (k_shape = (kt, kh, kw) of the
    pooled key grid), rel [B,H,Nq,kt+kh+kw] -> [B,H,Nq,D]."""
    if not kernels.dispatch_device(q, k, v, rel):
        return attention_rel_reference(q, k, v, rel, k_shape, scale)
    name = "attention_rel"
    dtype = kernels.check_operands(name, q, k, v, rel)
    B, H, Nq, D = q.shape
    kt, kh, kw = (int(s) for s in k_shape)
    Nk, R = kt * kh * kw, kt + kh + kw
    if D not in SUPPORTED_D:
        raise ValueError(f"{name}: head dim {D} not compiled (have {SUPPORTED_D})")
    if (tuple(k.shape) != (B, H, Nk, D) or tuple(v.shape) != (B, H, Nk, D)
            or tuple(rel.shape) != (B, H, Nq, R)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} rel {tuple(rel.shape)} do not "
                         f"match k_shape {tuple(k_shape)}")
    _check_aligned(name, q, k, v, rel)
    out = torch.empty_like(q)
    err = kernels.lib().mspi_attention_rel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
        B, H, Nq, Nk, D, R, kt, kh, kw, float(scale), dtype,
        kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out


def self_attention_reference(q, kv, num_heads: int) -> torch.Tensor:
    """Plain version: per-head softmax(q k^T / sqrt(D)) v in fp32 on packed
    q [B,N,C] and kv [B,N,2C]."""
    B, N, C = q.shape
    D = C // num_heads

    def heads(t):
        return t.float().reshape(B, -1, num_heads, D).transpose(1, 2)

    s = heads(q) @ heads(kv[..., :C]).transpose(-1, -2) * (D ** -0.5)
    out = torch.softmax(s, dim=-1) @ heads(kv[..., C:])
    return out.transpose(1, 2).reshape(B, N, C).to(q.dtype)


def self_attention(q, kv, num_heads: int) -> torch.Tensor:
    """K4. q [B,N,C], kv [B,N,2C] head-major lanes -> [B,N,C]."""
    if not kernels.dispatch_device(q, kv):
        return self_attention_reference(q, kv, num_heads)
    name = "self_attention"
    dtype = kernels.check_operands(name, q, kv)
    B, N, C = q.shape
    if C % num_heads or C // num_heads not in SUPPORTED_D:
        raise ValueError(f"{name}: C={C} / {num_heads} heads gives an "
                         f"uncompiled head dim (have {SUPPORTED_D})")
    if tuple(kv.shape) != (B, N, 2 * C):
        raise ValueError(f"{name}: kv {tuple(kv.shape)} for q {tuple(q.shape)}")
    _check_aligned(name, q, kv)
    out = torch.empty_like(q)
    err = kernels.lib().mspi_self_attention(
        q.data_ptr(), kv.data_ptr(), out.data_ptr(), B, N, C, num_heads, dtype,
        kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out
