"""Window attention on packed qkv: the VideoSwin kernels, forward and
backward.

Counterpart of `mspi_tpu/ops/pallas/attention.py::fused_window_attention`
(TPU kernel row 15, `_packed_fwd_kernel`) and its custom VJP, whose two TPU
backward kernels (row 16 `_packed_bwd_impl`, row 17 `_bwd_impl_perhead`)
compute one function; the port's one backward kernel serves both. Kernel
sources: `mspi_tpu_torch/csrc/window_attention.cu` (the forward, through the
shared flash body `csrc/flash_attention.cuh` with a dense bias) and the
window backward in `csrc/attention_bwd.cu`.

Per window b of B_ and head h, with qkv [B_, N, 3C] in lane order
(3, head, D) and out [B_, N, C]:

    out[b, :, h] = softmax(q_s k^T + bias[h] [+ mask[b mod nW]]) v

where q_s = q * scale is rounded to the storage dtype (scale = D^-0.5, cast
to that dtype first), as the TPU kernel scales q before Q K^T; the softmax
is fp32 and P is rounded to v's dtype before P V. The backward returns
dqkv and dbias = the sum over all windows of dS (fp32 sums, returned in the
bias's dtype); the mask gets no gradient.

`window_attention` is a `torch.autograd.Function`: on the card the forward
kernel also writes the rows' log-sum-exp when a gradient is needed, and the
backward kernel rebuilds P from it. On the CPU both directions run the plain
versions below.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mspi_tpu_torch.ops import kernels

SUPPORTED_D = (32,)  # VideoSwin-S: 96/3 = 192/6 = 384/12 = 768/24
TILE = 64  # query tile of the backward's dq/dbias pass
MAX_N = 7 * TILE  # the dq/dbias pass keeps [64, N] fp32 dbias rows in shared memory
MAX_GRID_Y = 65535  # the kernels put windows x heads on the grid's y axis


def _split(qkv: torch.Tensor, num_heads: int):
    """[B_, N, 3C] -> q, k, v as [B_, H, N, D] views."""
    B, N, C3 = qkv.shape
    x = qkv.reshape(B, N, 3, num_heads, C3 // (3 * num_heads)).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q * D^-0.5 in q's dtype, the scale cast to that dtype first."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)


def _scores(qs, k, bias, mask, num_windows: int) -> torch.Tensor:
    """fp32 scores [B_, H, N, N] = qs k^T + bias (+ mask[b mod nW])."""
    s = qs.float() @ k.float().transpose(-1, -2) + bias.float()
    if mask is not None:
        B, H, N, _ = s.shape
        s = (s.reshape(B // num_windows, num_windows, H, N, N)
             + mask.float()[None, :, None]).reshape(B, H, N, N)
    return s


def window_attention_reference(qkv, bias, mask, num_heads: int,
                               num_windows: int = 1) -> torch.Tensor:
    """Plain version of the TPU kernel `_packed_fwd_kernel`: q scaled in the
    storage dtype, fp32 scores and softmax, P rounded to v's dtype."""
    B, N, C3 = qkv.shape
    q, k, v = _split(qkv, num_heads)
    p = torch.softmax(_scores(_scaled_q(q), k, bias, mask, num_windows), dim=-1)
    out = p.to(v.dtype).float() @ v.float()
    return out.transpose(1, 2).reshape(B, N, C3 // 3).to(qkv.dtype)


def window_attention_backward_reference(qkv, bias, mask, num_heads: int,
                                        num_windows: int, dout):
    """Plain version of the backward (TPU rows 16 and 17) in fp32 from the
    storage-rounded q_s: (dqkv [B_, N, 3C], dbias [H, N, N]) with
    dq = scale dS k, dk = dS^T q_s, dv = P^T dO, dbias = sum_b dS."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = _split(qkv, num_heads)
    qs = _scaled_q(q).float()
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, N, num_heads, -1).transpose(1, 2)
    p = torch.softmax(_scores(qs, kf, bias, mask, num_windows), dim=-1)
    dv = p.transpose(-1, -2) @ do
    dp = do @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (q.shape[-1] ** -0.5) * ds @ kf
    dk = ds.transpose(-1, -2) @ qs
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, N, C3)
    return dqkv.to(qkv.dtype), ds.sum(0).to(bias.dtype)


def _geometry(name, qkv, bias, mask, num_heads: int, num_windows: int):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not [B_, N, 3C] for "
                         f"{num_heads} heads")
    B, N, C3 = qkv.shape
    D = C3 // (3 * num_heads)
    if D not in SUPPORTED_D:
        raise ValueError(f"{name}: head dim {D} not compiled (have {SUPPORTED_D})")
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} for {num_heads} heads, N={N}")
    if mask is not None and (tuple(mask.shape) != (num_windows, N, N) or B % num_windows):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} for {B} windows, "
                         f"num_windows={num_windows}, N={N}")
    if N > MAX_N:
        raise ValueError(f"{name}: N={N} tokens per window above {MAX_N}")
    if B * num_heads > MAX_GRID_Y:
        raise ValueError(f"{name}: {B} windows x {num_heads} heads exceed the grid")
    if qkv.dtype == torch.bfloat16 and qkv.data_ptr() % 16:
        raise ValueError(f"{name}: bf16 qkv must be 16-byte aligned")
    return B, N, C3 // 3


def _operands(name, qkv, bias, mask, *more):
    ops = [qkv, bias, *more] + ([] if mask is None else [mask])
    return kernels.check_operands(name, *ops)


def _window_attention_fwd(qkv, bias, mask, num_heads: int, num_windows: int,
                          with_lse: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Row 15 forward: (out, lse [B_*H, N] fp32 when asked for, else None)
    on the card, (plain out, None) on the CPU."""
    masked = () if mask is None else (mask,)
    if not kernels.dispatch_device(qkv, bias, *masked):
        return window_attention_reference(qkv, bias, mask, num_heads, num_windows), None
    name = "window_attention"
    dtype = _operands(name, qkv, bias, mask)
    B, N, C = _geometry(name, qkv, bias, mask, num_heads, num_windows)
    out = qkv.new_empty((B, N, C))
    lse = qkv.new_empty((B * num_heads, N), dtype=torch.float32) if with_lse else None
    err = kernels.lib().mspi_window_attention(
        qkv.data_ptr(), bias.data_ptr(), kernels.ptr(mask), out.data_ptr(), kernels.ptr(lse),
        B, N, C, num_heads, num_windows, dtype, kernels.stream_handle(qkv))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out, lse


def _window_groups(qkv: torch.Tensor, N: int, num_heads: int, B: int) -> int:
    """Window groups of the dq/dbias pass: enough (query tile, head, group)
    blocks for two waves on the card's SMs, each group at least one window."""
    blocks = -(-N // TILE) * num_heads
    return max(1, min(B, -(-2 * kernels.num_sms(qkv) // blocks)))


def window_attention_backward(qkv, bias, mask, out, lse, num_heads: int,
                              num_windows: int, dout):
    """Rows 16/17 backward -> (dqkv, dbias). On the card: the kernel, from
    the forward's out and lse; on the CPU: the plain version."""
    masked = () if mask is None else (mask,)
    if not kernels.dispatch_device(qkv, bias, dout, *masked):
        return window_attention_backward_reference(qkv, bias, mask, num_heads, num_windows,
                                                   dout)
    name = "window_attention_bwd"
    dtype = _operands(name, qkv, bias, mask, out, dout)
    B, N, C = _geometry(name, qkv, bias, mask, num_heads, num_windows)
    if tuple(out.shape) != (B, N, C) or tuple(dout.shape) != (B, N, C):
        raise ValueError(f"{name}: out {tuple(out.shape)} / dout {tuple(dout.shape)} "
                         f"for qkv {tuple(qkv.shape)}")
    if lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (B * num_heads, N):
        raise ValueError(f"{name}: needs the forward's fp32 lse [{B * num_heads}, {N}]")
    if dtype == kernels.DTYPE_CODES[torch.bfloat16] and (out.data_ptr() % 16
                                                          or dout.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 operands must be 16-byte aligned")
    groups = _window_groups(qkv, N, num_heads, B)
    D = C // num_heads
    f32 = dict(device=qkv.device, dtype=torch.float32)
    delta = torch.empty((B * num_heads, N), **f32)
    dk_part = torch.empty((B * num_heads, N, D), **f32)
    dv_part = torch.empty_like(dk_part)
    dbias_part = torch.empty((groups, num_heads, N, N), **f32)
    dqkv, dbias = torch.empty_like(qkv), torch.empty_like(bias)
    err = kernels.lib().mspi_window_attention_bwd(
        qkv.data_ptr(), bias.data_ptr(), kernels.ptr(mask), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), delta.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), dbias_part.data_ptr(), groups, B, N, C,
        num_heads, num_windows, dtype, kernels.stream_handle(qkv))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return dqkv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads, num_windows):
        out, lse = _window_attention_fwd(qkv, bias, mask, num_heads, num_windows,
                                         with_lse=any(ctx.needs_input_grad[:2]))
        ctx.num_heads, ctx.num_windows = num_heads, num_windows
        ctx.save_for_backward(qkv, bias, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask, out, lse = ctx.saved_tensors
        dqkv, dbias = window_attention_backward(qkv, bias, mask, out, lse, ctx.num_heads,
                                                ctx.num_windows, dout.contiguous())
        dmask = torch.zeros_like(mask) if ctx.needs_input_grad[2] else None
        return dqkv, dbias, dmask, None, None


def window_attention(qkv, bias, mask, num_heads: int, num_windows: int = 1) -> torch.Tensor:
    """Row 15. qkv [B_, N, 3C] packed (lane order 3, head, D), bias
    [H, N, N], mask [nW, N, N] of {0, -100} or None -> [B_, N, C];
    differentiable in qkv and bias."""
    if mask is None:
        qkv, bias = kernels.cast_for_autocast(qkv, bias)
    else:
        qkv, bias, mask = kernels.cast_for_autocast(qkv, bias, mask)
    return _WindowAttention.apply(qkv, bias, mask, int(num_heads), int(num_windows))
