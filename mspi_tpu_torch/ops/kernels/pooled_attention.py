"""Attention kernels: K1 `attention_rel` (MViT pooled attention with the
decomposed rel-pos bias), K4 `self_attention` (SyncBlock packed
multi-head self-attention), row 6 `attention` (MViT attention on augmented
q/k lanes) and row 8 `attention_rel_packed` (K1 on MViT's packed
token-major layout with the residual add), each with its backward.

Counterparts of `mspi_tpu/ops/pallas/pooled_attention.py::
fused_attention_rel`, `::fused_self_attention`, `::fused_attention` and
`::fused_attention_rel_packed` and their custom VJPs (`_bwd_impl_rel`,
`_bwd_impl`, `_attention_rel_packed_bwd`). Kernel sources:
`mspi_tpu_torch/csrc/attention_rel.cu` (K1 and row 8),
`csrc/self_attention.cu`, `csrc/attention.cu` (row 6, in the form
`aug_form` names) and their shared flash bodies
`csrc/flash_attention_sm90.cuh` (bf16) and `csrc/flash_attention.cuh`
(fp32); every backward in
`csrc/attention_bwd.cu` (K1's in bf16 in `csrc/attention_rel_bwd_sm90.cu`,
in the form `rel_bwd_form` names; row 8's is K1's after a layout change;
K4's in bf16 in `csrc/self_attention_bwd_sm90.cu`, in the form
`self_bwd_form` names; row 6's in bf16 in `csrc/attention_aug_bwd_sm90.cu`,
in the form `aug_bwd_form` names).

All four are `torch.autograd.Function`s: on the card the forward kernel
also writes the rows' log-sum-exp when a gradient is needed, and the
backward kernel rebuilds the probabilities from it. On the CPU both
directions run the plain versions below.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mspi_tpu_torch.ops import kernels

SUPPORTED_D = (64, 96, 128)  # UniFormer-B heads, MViT heads, SyncBlock heads
PACKED_D = 96  # row 8's head dim (MViT)
# row 6's q_aug/k_aug widths Da = 96 + R, zero-filled to the score width of
# the first form that holds them (`csrc/flash_attention.cuh::aug_width`):
# MViTv2-S at 16 frames has R = kt + kh + kw = 8 + H / 16 + W / 16 at its
# widest calls (Da 114 at --resolution 64 96, 142 at 224x384, 162 at 288x640,
# 184 at 512x768, 256 at 1024x1408); past the widest compile-time form, 256,
# the wide form takes Da rounded up to a multiple of AUG_CHUNK (Da 258 at
# 1024x1440, 320 at 1536x1920, 400 at 2048x2688), streaming q and k in
# chunks of that many lanes
AUG_FORMS = (128, 144, 176, 192, 256)
AUG_CHUNK = 64
AUG_SPLIT = 128  # the bf16 wide backward's dq / dk columns a block
AUG_DV = 96  # row 6's value width (MViT heads)
BWD_TILE = 64  # query and key tile of the backward kernels
REL_BWD_D = 96  # the bf16 K1 backward's head dim (every K1 call of MViTv2-S)
REL_BWD_SM90_MAX_R = 64  # the widest rel width of its passes compiled per RS


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


def _segments(q: torch.Tensor, nq: int, nk: int, bh: int) -> int:
    """Query-tile segments of the dk/dv pass: enough blocks for two waves
    on the card's SMs, each segment at least one tile."""
    q_tiles = -(-nq // BWD_TILE)
    blocks = -(-nk // BWD_TILE) * bh
    return max(1, min(q_tiles, -(-2 * kernels.num_sms(q) // blocks)))


def rel_bwd_form(R: int) -> Tuple[str, int]:
    """The bf16 K1 backward's form at rel width R, as
    `csrc/attention_rel_bwd_sm90.cu` chooses it, and its RS = max(2,
    ceil(R / 16)) rel k-steps (the `rel_pad` scratch has 16 RS columns):
    ("sm90", RS), the passes compiled per RS with drel and E's fragments in
    registers, up to R = 64; ("sm90_wide", RS), the form with RS at run time
    and drel and E's rows in shared memory, above."""
    if R <= 0:
        raise ValueError(f"rel width {R}")
    rs = max(2, -(-R // 16))
    return ("sm90" if R <= REL_BWD_SM90_MAX_R else "sm90_wide"), rs


def self_bwd_form(D: int) -> str:
    """The bf16 K4 backward's form at head dim D, as
    `csrc/self_attention_bwd_sm90.cu` chooses it: "kv_registers" (D = 64
    and 96: the dk/dv pass holds its keys' K and V A fragments in
    registers) or "kv_shared" (D = 128: K and V rows resident in shared
    memory, their fragments read by ldmatrix per use, so that dk and dv fit
    the registers)."""
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim {D} not compiled (have {SUPPORTED_D})")
    return "kv_registers" if D <= 96 else "kv_shared"


SELF_BWD_BLOCKS_PER_SM = 2  # the bf16 K4 dk/dv pass's blocks per SM (__launch_bounds__)
SELF_BWD_MAX_SEGMENTS = 4  # each segment adds fp32 partials of dk and dv to write and sum


def self_bwd_segments(n: int, bh: int, sms: int) -> int:
    """Query-tile segments of the bf16 K4 backward's dk/dv pass at N = n
    tokens, bh = batch x heads, on `sms` SMs: the count (at most
    SELF_BWD_MAX_SEGMENTS) that minimises waves of blocks x query tiles per
    block, the smallest such. At the SyncBlock's training shape (N 708,
    batch 2 x 4 heads) on the H100's 132 SMs: 2 (192 blocks, one wave of 6
    tiles each) where `_segments` gives 3 (288 blocks, two waves of 4)."""
    tiles = -(-n // BWD_TILE)
    slots = SELF_BWD_BLOCKS_PER_SM * sms

    def cost(s):
        return -(-tiles * bh * s // slots) * -(-tiles // s)
    return min(range(1, min(tiles, SELF_BWD_MAX_SEGMENTS) + 1), key=lambda s: (cost(s), s))


def _softmax_backward(p, v, dout, out):
    """dv = P^T dO and dS = P (dP - rowsum(dO O)) in fp32."""
    dv = p.transpose(-1, -2) @ dout
    dp = dout @ v.transpose(-1, -2)
    ds = p * (dp - (dout * out).sum(-1, keepdim=True))
    return dv, ds


def attention_rel_reference(q, k, v, rel, k_shape, scale: float) -> torch.Tensor:
    """Plain version: softmax(scale * q k^T + rel E^T) v in fp32."""
    E = torch.from_numpy(key_expansion(k_shape)).to(q.device)
    s = scale * q.float() @ k.float().transpose(-1, -2) + rel.float() @ E.T
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def attention_rel_backward_reference(q, k, v, rel, k_shape, scale: float, dout):
    """Plain version of the K1 backward in fp32: (dq, dk, dv, drel) with
    dq = scale dS k, dk = scale dS^T q, drel = dS E."""
    E = torch.from_numpy(key_expansion(k_shape)).to(q.device)
    qf, kf, vf, do = (t.float() for t in (q, k, v, dout))
    s = scale * qf @ kf.transpose(-1, -2) + rel.float() @ E.T
    p = torch.softmax(s, dim=-1)
    dv, ds = _softmax_backward(p, vf, do, p @ vf)
    grads = (scale * ds @ kf, scale * ds.transpose(-1, -2) @ qf, dv, ds @ E)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, rel)))


def _rel_geometry(name, q, k, v, rel, k_shape):
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
    return B, H, Nq, Nk, D, R, kt, kh, kw


def _attention_rel_fwd(q, k, v, rel, k_shape, scale: float, with_lse: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 forward: (out, lse) on the card (lse [B*H, Nq] fp32 when asked
    for, else None); (plain out, None) on the CPU."""
    if not kernels.dispatch_device(q, k, v, rel):
        return attention_rel_reference(q, k, v, rel, k_shape, scale), None
    name = "attention_rel"
    dtype = kernels.check_operands(name, q, k, v, rel)
    B, H, Nq, Nk, D, R, kt, kh, kw = _rel_geometry(name, q, k, v, rel, k_shape)
    _check_aligned(name, q, k, v, rel)
    out = torch.empty_like(q)
    lse = q.new_empty((B * H, Nq), dtype=torch.float32) if with_lse else None
    err = kernels.lib().mspi_attention_rel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
        kernels.ptr(lse), B, H, Nq, Nk, D, R, kt, kh, kw, float(scale), dtype,
        kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out, lse


def attention_rel_backward(q, k, v, rel, out, lse, k_shape, scale: float, dout):
    """K1 backward -> (dq, dk, dv, drel). On the card: the kernel, from the
    forward's out and lse; on the CPU: the plain version (out and lse are
    not needed there)."""
    if not kernels.dispatch_device(q, k, v, rel, dout):
        return attention_rel_backward_reference(q, k, v, rel, k_shape, scale, dout)
    name = "attention_rel_bwd"
    dtype = kernels.check_operands(name, q, k, v, rel, out, dout)
    B, H, Nq, Nk, D, R, kt, kh, kw = _rel_geometry(name, q, k, v, rel, k_shape)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"{name}: out {tuple(out.shape)} / dout {tuple(dout.shape)} "
                         f"for q {tuple(q.shape)}")
    if lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (B * H, Nq):
        raise ValueError(f"{name}: needs the forward's fp32 lse [{B * H}, {Nq}]")
    _check_aligned(name, q, k, v, rel, out, dout)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and D != REL_BWD_D:
        raise ValueError(f"{name}: the bf16 kernel takes head dim {REL_BWD_D}, got {D}")
    segments = _segments(q, Nq, Nk, B * H)
    f32 = dict(device=q.device, dtype=torch.float32)
    delta = torch.empty((B * H, Nq), **f32)
    dk_part = torch.empty((segments, B * H, Nk, D), **f32)
    dv_part = torch.empty_like(dk_part)
    # the bf16 passes' rel rows at the pitch of their rel k-steps, 16
    # columns each (`rel_bwd_form`)
    rel_pad = q.new_empty((B * H, Nq, 16 * rel_bwd_form(R)[1])) if bf16 else None
    dq, dk, dv, drel = (torch.empty_like(t) for t in (q, k, v, rel))
    err = kernels.lib().mspi_attention_rel_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        drel.data_ptr(), delta.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(),
        kernels.ptr(rel_pad), segments, B, H, Nq, Nk, D, R, kt, kh, kw, float(scale), dtype,
        kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return dq, dk, dv, drel


class _AttentionRel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel, k_shape, scale):
        out, lse = _attention_rel_fwd(q, k, v, rel, k_shape, scale,
                                      with_lse=any(ctx.needs_input_grad[:4]))
        ctx.k_shape, ctx.scale = k_shape, scale
        ctx.save_for_backward(q, k, v, rel, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel, out, lse = ctx.saved_tensors
        grads = attention_rel_backward(q, k, v, rel, out, lse, ctx.k_shape, ctx.scale,
                                       dout.contiguous())
        return (*grads, None, None)


def attention_rel(q, k, v, rel, k_shape, scale: float) -> torch.Tensor:
    """K1. q [B,H,Nq,D], k/v [B,H,Nk,D] (k_shape = (kt, kh, kw) of the
    pooled key grid), rel [B,H,Nq,kt+kh+kw] -> [B,H,Nq,D]; differentiable
    in q, k, v and rel."""
    q, k, v, rel = kernels.cast_for_autocast(q, k, v, rel)
    return _AttentionRel.apply(q, k, v, rel, tuple(int(s) for s in k_shape), float(scale))


# ---- row 6: attention on augmented lanes (scale and bias folded into q/k) ----


def attention_reference(q, k, v) -> torch.Tensor:
    """Plain version: softmax(q k^T) v in fp32, no scale."""
    s = q.float() @ k.float().transpose(-1, -2)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def attention_backward_reference(q, k, v, dout):
    """Plain version of row 6's backward (row 7 head-major) in fp32:
    (dq, dk, dv) with dq = dS k, dk = dS^T q, dv = P^T dO."""
    qf, kf, vf, do = (t.float() for t in (q, k, v, dout))
    p = torch.softmax(qf @ kf.transpose(-1, -2), dim=-1)
    dv, ds = _softmax_backward(p, vf, do, p @ vf)
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf, dv)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def aug_form(Da: int) -> int:
    """Row 6's and row 7 head-major's score width DK at augmented width Da,
    as `csrc/flash_attention.cuh::aug_width` chooses it: q_aug and k_aug rows
    zero-filled to the narrowest of AUG_FORMS that holds them, or past 256
    (the wide form) to Da rounded up to a multiple of AUG_CHUNK. Every Da >= 1
    has a form."""
    if Da < 1:
        raise ValueError(f"Da {Da}: the augmented lanes need at least one")
    if Da > AUG_FORMS[-1]:
        return -(-Da // AUG_CHUNK) * AUG_CHUNK
    return next(dk for dk in AUG_FORMS if Da <= dk)


def aug_is_wide(Da: int) -> bool:
    """Whether Da takes the wide form (a run-time score width, in chunks)."""
    return aug_form(Da) > AUG_FORMS[-1]


def aug_fwd_form(Da: int) -> Tuple[int, int, bool]:
    """The bf16 row 6 forward's form at Da, as `csrc/flash_attention_sm90.cuh`
    lays it out: (DK, shared memory bytes, q rows in shared memory). Up to Da
    256 (`Layout<DK, 0, kNoBias, 96>`): k_aug is copied into zero-filled rows
    of DK lanes (the `pad` scratch of `_attention_fwd`) and its 2-slot ring
    holds 64-key tiles of K [64][DK + 8] and V [64][96 + 8]; up to DK = 176
    each warp holds its q rows' A fragments in registers, at 192 and 256
    (`Layout::kQRows`) the block's 64 q rows [64][DK + 8] sit beside the
    ring and are read by ldmatrix per key tile. Past 256 (`WideLayout`):
    q_aug and k_aug both go into padded rows, and each ring slot holds a
    step's q and k chunks [64][AUG_CHUNK + 8] and, on a key tile's last
    chunk, V [64][104]."""
    dk = aug_form(Da)
    if aug_is_wide(Da):
        return dk, 2 * 2 * BWD_TILE * (2 * (AUG_CHUNK + 8) + AUG_DV + 8), True
    q_rows = dk > 176
    return (dk, 2 * 2 * BWD_TILE * ((dk + 8) + (AUG_DV + 8)) + (2 * BWD_TILE * (dk + 8)
                                                                 if q_rows else 0), q_rows)


def aug_bwd_form(Da: int) -> Tuple[int, int, int, int, int]:
    """The bf16 row 7 head-major backward's form at Da, as
    `csrc/attention_aug_bwd_sm90.cu` (`AugBytes<DK>`, `WideBytes`) lays it
    out: (DK, dq pass and dk/dv pass shared memory bytes, the blocks that
    split dq's columns, the blocks that split dk's). q_aug and k_aug are
    copied into zero-filled rows of DK = `aug_form(Da)` lanes, whose 16-byte
    rows its `cp.async` ring copies; the dq pass rings (K, V) tiles of 64 rows
    through 2 slots (and in the wide forms, DK > 144, holds its 64 q rows,
    whose A fragments leave the registers), the dk/dv pass (q, dO, lse,
    delta) and holds its K and V rows; operand rows at a pitch of 8 lanes
    more. At DK = 256 two blocks split dq's columns, above 176 two split
    dk's (the first also takes dv), so that the accumulators fit the
    registers; each recomputes the scores. Past Da 256 both passes walk
    (tile, AUG_CHUNK-lane chunk) steps, a slot holding both sides' chunks
    [64][AUG_CHUNK + 8], V or dO [64][104] and the split's AUG_SPLIT columns
    of k or q (the dk/dv pass also lse and delta), and dq's and dk's
    columns split over ceil(DK / AUG_SPLIT) blocks each."""
    dk = aug_form(Da)
    if aug_is_wide(Da):
        chunk = 2 * BWD_TILE * (AUG_CHUNK + 8)
        slot = 2 * chunk + 2 * BWD_TILE * (AUG_DV + 8) + 2 * chunk
        splits = -(-dk // AUG_SPLIT)
        return dk, 2 * slot, 2 * (slot + 8 * BWD_TILE), splits, splits
    op_k, op_v = 2 * BWD_TILE * (dk + 8), 2 * BWD_TILE * (AUG_DV + 8)
    dq = 2 * (op_k + op_v) + (op_k if dk > 144 else 0)
    return (dk, dq, 2 * (op_k + op_v + 8 * BWD_TILE) + op_k + op_v, 2 if dk > 192 else 1,
            2 if dk > 176 else 1)


def _aug_geometry(name, q, k, v):
    B, H, Nq, Da = q.shape
    Nk, Dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, H, Nk, Da) or tuple(v.shape) != (B, H, Nk, Dv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if Dv != AUG_DV:
        raise ValueError(f"{name}: value width Dv {Dv} not compiled (Dv {AUG_DV})")
    if Da < 1:
        raise ValueError(f"{name}: Da {Da}: the augmented lanes need at least one")
    return B, H, Nq, Nk, Da, Dv


def _attention_fwd(q, k, v, with_lse: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Row 6 forward: (out, lse [B*H, Nq] fp32 or None) on the card,
    (plain out, None) on the CPU."""
    if not kernels.dispatch_device(q, k, v):
        return attention_reference(q, k, v), None
    name = "attention"
    dtype = kernels.check_operands(name, q, k, v)
    B, H, Nq, Nk, Da, Dv = _aug_geometry(name, q, k, v)
    _check_aligned(name, v)  # q_aug / k_aug rows need no alignment
    out = q.new_empty((B, H, Nq, Dv))
    lse = q.new_empty((B * H, Nq), dtype=torch.float32) if with_lse else None
    # bf16: k_aug's rows (and in the wide form q_aug's first) zero-filled to
    # the form's DK lanes, for the ring's copies
    pad = None
    if q.dtype == torch.bfloat16:
        pad = q.new_empty((B * H * (Nk + (Nq if aug_is_wide(Da) else 0)), aug_form(Da)))
    err = kernels.lib().mspi_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kernels.ptr(lse),
        kernels.ptr(pad), B, H, Nq, Nk, Da, Dv, dtype, kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out, lse


def attention_backward(q, k, v, out, lse, dout):
    """Row 6 backward -> (dq, dk, dv): row 7's kernel on head-major operands
    with Da != Dv and scale 1 on the card, from the forward's lse (bf16:
    the register-resident passes, delta = rowsum(P dP) as the TPU kernel
    takes it; fp32: the FMA passes, delta from out); the plain version on
    the CPU."""
    if not kernels.dispatch_device(q, k, v, dout):
        return attention_backward_reference(q, k, v, dout)
    name = "attention_bwd"
    dtype = kernels.check_operands(name, q, k, v, out, dout)
    B, H, Nq, Nk, Da, Dv = _aug_geometry(name, q, k, v)
    if tuple(out.shape) != (B, H, Nq, Dv) or tuple(dout.shape) != (B, H, Nq, Dv):
        raise ValueError(f"{name}: out {tuple(out.shape)} / dout {tuple(dout.shape)} "
                         f"for v {tuple(v.shape)}")
    if lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (B * H, Nq):
        raise ValueError(f"{name}: needs the forward's fp32 lse [{B * H}, {Nq}]")
    _check_aligned(name, v, dout)
    segments = _segments(q, Nq, Nk, B * H)
    f32 = dict(device=q.device, dtype=torch.float32)
    delta = torch.empty((B * H, Nq), **f32)
    pad = None
    if q.dtype == torch.bfloat16:  # q_aug and k_aug in zero-filled rows of DK lanes
        dk_width = aug_bwd_form(Da)[0]
        pad = q.new_empty((B * H * (Nq + Nk), dk_width))
    else:
        dk_width = Da
    dk_part = torch.empty((segments, B * H, Nk, dk_width), **f32)
    dv_part = torch.empty((segments, B * H, Nk, Dv), **f32)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = kernels.lib().mspi_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), kernels.ptr(pad), segments, B, H, Nq, Nk, Da,
        Dv, dtype, kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _attention_fwd(q, k, v, with_lse=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return attention_backward(q, k, v, out, lse, dout.contiguous())


def attention(q_aug, k_aug, v) -> torch.Tensor:
    """Row 6. softmax(q_aug k_aug^T) v with no scale: q_aug [B,H,Nq,Da],
    k_aug [B,H,Nk,Da], v [B,H,Nk,Dv] -> [B,H,Nq,Dv]; differentiable in all
    three (the k_aug lanes that hold constants get a gradient the caller
    drops)."""
    q_aug, k_aug, v = kernels.cast_for_autocast(q_aug, k_aug, v)
    return _Attention.apply(q_aug, k_aug, v)


# ---- row 8: K1 on the packed token-major layout, with the residual add ----


def _to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, heads*W] -> head-major [B, heads, N, W] (contiguous)."""
    B, N, C = t.shape
    return t.reshape(B, N, heads, C // heads).transpose(1, 2).contiguous()


def _to_packed(t: torch.Tensor) -> torch.Tensor:
    """Head-major [B, heads, N, W] -> [B, N, heads*W]."""
    B, H, N, W = t.shape
    return t.transpose(1, 2).reshape(B, N, H * W)


def attention_rel_packed_reference(q, k, v, rel, k_shape, heads: int, scale: float,
                                   residual: bool) -> torch.Tensor:
    """Plain version: K1's plain version per head of the packed operands;
    with residual, + q added in q's dtype to the output rounded to it."""
    out = _to_packed(attention_rel_reference(*(_to_heads(t, heads) for t in (q, k, v, rel)),
                                             k_shape, scale))
    return out + q if residual else out


def attention_rel_packed_backward_reference(q, k, v, rel, k_shape, heads: int, scale: float,
                                            residual: bool, dout):
    """Plain version of row 8's backward in fp32, packed: K1's plain
    backward per head, with residual dq += dout."""
    grads = attention_rel_backward_reference(
        *(_to_heads(t.float(), heads) for t in (q, k, v, rel)), k_shape, scale,
        _to_heads(dout.float(), heads))
    dq, dk, dv, drel = (_to_packed(g) for g in grads)
    grads = (dq + dout.float() if residual else dq), dk, dv, drel
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, rel)))


def _packed_geometry(name, q, k, v, rel, k_shape, heads):
    B, Nq, C = q.shape
    kt, kh, kw = (int(s) for s in k_shape)
    Nk, R = kt * kh * kw, kt + kh + kw
    if C % heads or C // heads != PACKED_D:
        raise ValueError(f"{name}: C={C} / {heads} heads: head dim {PACKED_D} compiled")
    if (tuple(k.shape) != (B, Nk, C) or tuple(v.shape) != (B, Nk, C)
            or tuple(rel.shape) != (B, Nq, heads * R)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} rel {tuple(rel.shape)} do not match "
                         f"k_shape {tuple(k_shape)} and {heads} heads")
    return B, Nq, Nk, C // heads, R, kt, kh, kw


def _attention_rel_packed_fwd(q, k, v, rel, k_shape, heads: int, scale: float,
                              residual: bool, with_lse: bool = False
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Row 8 forward: (out, lse [B*heads, Nq] fp32 or None) on the card,
    (plain out, None) on the CPU."""
    if not kernels.dispatch_device(q, k, v, rel):
        return attention_rel_packed_reference(q, k, v, rel, k_shape, heads, scale,
                                              residual), None
    name = "attention_rel_packed"
    dtype = kernels.check_operands(name, q, k, v, rel)
    B, Nq, Nk, D, R, kt, kh, kw = _packed_geometry(name, q, k, v, rel, k_shape, heads)
    _check_aligned(name, q, k, v, rel)
    out = torch.empty_like(q)
    lse = q.new_empty((B * heads, Nq), dtype=torch.float32) if with_lse else None
    err = kernels.lib().mspi_attention_rel_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
        kernels.ptr(lse), B, heads, Nq, Nk, D, R, kt, kh, kw, float(scale), int(residual),
        dtype, kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out, lse


def attention_rel_packed_backward(q, k, v, rel, out, lse, k_shape, heads: int, scale: float,
                                  residual: bool, dout):
    """Row 8 backward -> (dq, dk, dv, drel), all packed: the operands to
    head-major, K1's backward (row 5; `out` is the attention's output
    without the residual and `lse` the forward's), back to packed, and with
    residual dq += dout, as the JAX package's `_attention_rel_packed_bwd`."""
    grads = attention_rel_backward(
        *(_to_heads(t, heads) for t in (q, k, v, rel, out)), lse, k_shape, scale,
        _to_heads(dout, heads))
    dq, dk, dv, drel = (_to_packed(g) for g in grads)
    return (dq + dout if residual else dq), dk, dv, drel


class _AttentionRelPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel, k_shape, heads, scale, residual):
        ctx.k_shape, ctx.heads, ctx.scale, ctx.residual = k_shape, heads, scale, residual
        if not any(ctx.needs_input_grad[:4]):
            out, _ = _attention_rel_packed_fwd(q, k, v, rel, k_shape, heads, scale, residual)
            return out
        # the backward needs the attention output without the residual: the
        # kernel writes it, and the residual (the same add in q's dtype) runs here
        o, lse = _attention_rel_packed_fwd(q, k, v, rel, k_shape, heads, scale, False,
                                           with_lse=True)
        ctx.save_for_backward(q, k, v, rel, o, lse)
        return o + q if residual else o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel, o, lse = ctx.saved_tensors
        grads = attention_rel_packed_backward(q, k, v, rel, o, lse, ctx.k_shape, ctx.heads,
                                              ctx.scale, ctx.residual, dout.contiguous())
        return (*grads, None, None, None, None)


def attention_rel_packed(q, k, v, rel, k_shape, heads: int, scale: float,
                         residual: bool) -> torch.Tensor:
    """Row 8. Per head h (lanes [h*D, (h+1)*D)): softmax(scale q_h k_h^T +
    rel_h E^T) v_h, + q_h with residual. q [B,Nq,H*D], k/v [B,Nk,H*D] (k_shape
    the pooled key grid), rel [B,Nq,H*R] -> [B,Nq,H*D]; differentiable in
    q, k, v and rel."""
    q, k, v, rel = kernels.cast_for_autocast(q, k, v, rel)
    return _AttentionRelPacked.apply(q, k, v, rel, tuple(int(s) for s in k_shape), int(heads),
                                     float(scale), bool(residual))


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


def self_attention_backward_reference(q, kv, num_heads: int, dout):
    """Plain version of the K4 backward in fp32 -> (dq [B,N,C], dkv
    [B,N,2C])."""
    B, N, C = q.shape
    D = C // num_heads
    scale = D ** -0.5

    def heads(t):
        return t.float().reshape(B, -1, num_heads, D).transpose(1, 2)

    def packed(t):
        return t.transpose(1, 2).reshape(B, -1, C)

    qh, kh, vh, do = heads(q), heads(kv[..., :C]), heads(kv[..., C:]), heads(dout)
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    dv, ds = _softmax_backward(p, vh, do, p @ vh)
    dq = packed(scale * ds @ kh)
    dkv = torch.cat([packed(scale * ds.transpose(-1, -2) @ qh), packed(dv)], dim=-1)
    return dq.to(q.dtype), dkv.to(kv.dtype)


def _self_geometry(name, q, kv, num_heads):
    B, N, C = q.shape
    if C % num_heads or C // num_heads not in SUPPORTED_D:
        raise ValueError(f"{name}: C={C} / {num_heads} heads gives an "
                         f"uncompiled head dim (have {SUPPORTED_D})")
    if tuple(kv.shape) != (B, N, 2 * C):
        raise ValueError(f"{name}: kv {tuple(kv.shape)} for q {tuple(q.shape)}")
    return B, N, C


def _self_attention_fwd(q, kv, num_heads: int, with_lse: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K4 forward: (out, lse [B*heads, N] fp32 or None) on the card,
    (plain out, None) on the CPU."""
    if not kernels.dispatch_device(q, kv):
        return self_attention_reference(q, kv, num_heads), None
    name = "self_attention"
    dtype = kernels.check_operands(name, q, kv)
    B, N, C = _self_geometry(name, q, kv, num_heads)
    _check_aligned(name, q, kv)
    out = torch.empty_like(q)
    lse = q.new_empty((B * num_heads, N), dtype=torch.float32) if with_lse else None
    err = kernels.lib().mspi_self_attention(
        q.data_ptr(), kv.data_ptr(), out.data_ptr(), kernels.ptr(lse), B, N, C, num_heads,
        dtype, kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out, lse


def self_attention_backward(q, kv, out, lse, num_heads: int, dout):
    """K4 backward -> (dq [B,N,C], dkv [B,N,2C]): the bias-free attention
    backward kernel on the packed lanes on the card, the plain version on
    the CPU."""
    if not kernels.dispatch_device(q, kv, dout):
        return self_attention_backward_reference(q, kv, num_heads, dout)
    name = "attention_bwd"
    dtype = kernels.check_operands(name, q, kv, out, dout)
    B, N, C = _self_geometry(name, q, kv, num_heads)
    if tuple(out.shape) != (B, N, C) or tuple(dout.shape) != (B, N, C):
        raise ValueError(f"{name}: out {tuple(out.shape)} / dout {tuple(dout.shape)} "
                         f"for q {tuple(q.shape)}")
    if lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (B * num_heads, N):
        raise ValueError(f"{name}: needs the forward's fp32 lse [{B * num_heads}, {N}]")
    _check_aligned(name, q, kv, out, dout)
    bh = B * num_heads
    if q.dtype == torch.bfloat16:
        segments = self_bwd_segments(N, bh, kernels.num_sms(q))
    else:
        segments = _segments(q, N, N, bh)
    f32 = dict(device=q.device, dtype=torch.float32)
    delta = torch.empty((bh, N), **f32)
    dk_part = torch.empty((segments, bh, N, C // num_heads), **f32)
    dv_part = torch.empty_like(dk_part)
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    err = kernels.lib().mspi_self_attention_bwd(
        q.data_ptr(), kv.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dkv.data_ptr(), delta.data_ptr(), dk_part.data_ptr(),
        dv_part.data_ptr(), segments, B, N, C, num_heads, dtype, kernels.stream_handle(q))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return dq, dkv


class _SelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, num_heads):
        out, lse = _self_attention_fwd(q, kv, num_heads,
                                       with_lse=any(ctx.needs_input_grad[:2]))
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, kv, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv, out, lse = ctx.saved_tensors
        dq, dkv = self_attention_backward(q, kv, out, lse, ctx.num_heads, dout.contiguous())
        return dq, dkv, None


def self_attention(q, kv, num_heads: int) -> torch.Tensor:
    """K4. q [B,N,C], kv [B,N,2C] head-major lanes -> [B,N,C];
    differentiable in q and kv."""
    q, kv = kernels.cast_for_autocast(q, kv)
    return _SelfAttention.apply(q, kv, int(num_heads))
