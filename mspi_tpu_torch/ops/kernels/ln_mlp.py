"""Fused LayerNorm + MLP: y = fc2(gelu(fc1(LN(x)))) — kernel K2 and the
call site of K3 — and the fused MLP without the LayerNorm (rows 13-14).

Counterpart of `mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp` (K2, with its
custom VJP `_ln_bwd_impl`) and `fused_ln_mlp_t` (K3). K3's transposed
[N, C, B*T] layout served only the TPU's batch-minor lane tiling; the
ConvNeXt prior calls the same CUDA kernel on its channels-last tokens
through `ln_mlp_prior`, which keeps its own launch count and, like K3, has
no backward (the prior is frozen). Kernel sources:
`mspi_tpu_torch/csrc/ln_mlp.cu` (forward) and `csrc/ln_mlp_bwd.cu`.

`ln_mlp` is a `torch.autograd.Function`: it saves x and the weights and
its backward recomputes LN, u and h from them, as the TPU kernel does.

In bf16 every forward here except row 12 runs the wgmma + TMA body of
`csrc/ln_mlp_sm90.cuh` in the launch form `sm90_form` mirrors; fp32 runs
`csrc/ln_mlp.cuh`'s FMA-pipe body; the kernel labs run the wgmma body in
variants of their own (`lab.py`). The
bf16 backwards (K2's and row 14) run `csrc/ln_mlp_bwd_sm90.cuh`'s wgmma +
TMA kernels in the form `bwd_sm90_form` mirrors; fp32 the FMA passes of
`csrc/ln_mlp_bwd.cu`.

Weights come in `nn.Linear` layout: w1 [H, C], w2 [C, H]. Residual,
drop-path and layer-scale stay with the caller, except in
`ln_mlp_prior_res`.

Two serving options live here too, each with its own launch count:
- `ln_mlp_prior_res` (TPU row 10, `fused_ln_mlp_t_res`): the prior's
  block tail `shortcut + gamma * mlp(LN(x))` from one K2 launch, the
  residual sum folded into the kernel's epilogue;
- `ln_mlp_int8` (TPU row 12, `fused_ln_mlp_int8`): int8 weights quantised
  per output channel once (`int8_operands`), activations quantised per row
  in the kernel, int8 x int8 -> int32 products on s8 wgmma fed by TMA
  (`csrc/ln_mlp_int8.cu`, in the launch form `int8_sm90_form` mirrors).
  Inference only. `ln_mlp_block` routes a transformer block's norm + MLP
  to it as the JAX package's `_dispatch_ln_mlp` does.

And the kernel-level fused MLP, y = fc2(gelu(fc1(x))):
- `fused_mlp` (TPU rows 13-14, `mspi_tpu/ops/pallas/mlp.py::fused_mlp` and
  its VJP `_bwd_impl`): K2's forward body with the LayerNorm compiled out
  (`csrc/ln_mlp.cu`, `mspi_mlp`) and K2's backward without its LayerNorm
  (`csrc/ln_mlp_bwd.cu`, `mspi_mlp_bwd`), each with its own launch count;
- `maybe_fused_mlp(mlp, x)`, the counterpart of the JAX `maybe_fused_mlp`.
  As in the JAX package no model calls it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.ops import kernels

SUPPORTED_C = (96, 192, 320, 384, 512, 768)  # MViT / Swin stages, UniFormer-B's stage 3
SM90_HC = 64  # the bf16 body's hidden units per chunk (H % 64 == 0)
INT8_C = (256, 320, 384, 512, 768)  # widths the int8 kernel is compiled for
INT8_HC = 128  # the int8 kernel's W2 box: two 64-unit chunks (H % 128 == 0)
INT8_LAB_C = 96  # the int8 lab's width (`lab.mlp_int8w`), a form of the same body
QUANT_MIN_C = 256  # the JAX package's QUANT_MIN_C: narrower blocks stay on K2
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
# The JAX package's degree-8 fit of erf(z)/z on |z| <= 4 (`_ERF_COEF_FAST`,
# mspi_tpu/ops/pallas/mlp.py), Horner in (z^2 - 8) / 8. The int8 kernel's
# GELU uses it whatever the storage dtype, as the TPU kernel does.
_ERF_COEF_FAST = (
    3.536022699613e-01, -1.745360228158e-01, 1.282262975445e-01,
    -1.335568183591e-01, 1.164849409594e-01, 1.073632742169e-02,
    -7.948334927669e-03, -1.415578021638e-01, 9.874117476355e-02,
)


def _ln_mlp_f32(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    C = x.shape[-1]
    z = F.layer_norm(x.float(), (C,), g.float(), b.float(), eps).to(x.dtype)
    h = F.gelu(F.linear(z.float(), w1.float(), b1.float())).to(x.dtype)
    return F.linear(h.float(), w2.float(), b2.float())


def ln_mlp_reference(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Plain version: LN statistics in fp32, z and h rounded to x's dtype at
    the points the kernel rounds them, exact erf GELU."""
    return _ln_mlp_f32(x, g, b, w1, b1, w2, b2, eps).to(x.dtype)


def ln_mlp_prior_res_reference(x, shortcut, gamma, g, b, w1, b1, w2, b2,
                               eps: float) -> torch.Tensor:
    """Plain version of row 10: K2's y kept in fp32, then
    shortcut + gamma * y in fp32 and one cast, as `_ln_fwd_kernel_t_res`
    sums; gamma arrives in the storage dtype."""
    y = _ln_mlp_f32(x, g, b, w1, b1, w2, b2, eps)
    return (shortcut.float() + gamma.float() * y).to(x.dtype)


def _erf_fast(x: torch.Tensor) -> torch.Tensor:
    z = x.clamp(-4.0, 4.0)
    u = z * z * 0.125 - 1.0
    r = torch.full_like(u, _ERF_COEF_FAST[-1])
    for c in _ERF_COEF_FAST[-2::-1]:
        r = r * u + c
    return z * r


def _quant_rows(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row abs-max int8 codes (as exact floats) and scales of an fp32
    tile: amax floored at 1e-6, codes round(v * (127 / amax)) half to even,
    scale amax * (1/127) (the JAX package's `_quant_rows`)."""
    amax = v.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    return torch.round(v * (amax.new_full((), 127.0) / amax)), amax * (1.0 / 127.0)


def _int_products(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """q @ wq^T of int8 codes, exact (float64 holds every partial sum at
    these widths: |sum| <= 127^2 * 3072 < 2^53), then rounded once to fp32
    as the int32 -> fp32 conversion rounds."""
    return (q.double() @ wq.double().T).float()


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an `nn.Linear` weight [out, in]:
    (codes int8 [out, in], scales fp32 [out]) with w ~= codes * scale. The
    JAX package's `quantize_weight` takes the [in, out] kernel and reduces
    over its axis 0; here the input axis is dim 1."""
    wf = w.detach().float()
    amax = wf.abs().amax(1).clamp_min(1e-12)
    codes = torch.round(wf * (amax.new_full((), 127.0) / amax)[:, None])
    return codes.to(torch.int8), amax * (1.0 / 127.0)


def ln_mlp_int8_reference(x, g, b, w1q, s1, b1, w2q, s2, b2, eps: float) -> torch.Tensor:
    """Plain version of row 12, the order of operations of the TPU kernel
    `_ln_fwd_kernel_q`: LayerNorm in fp32 (var = E[x^2] - mu^2) with z kept
    in fp32, z quantised per row, exact int32 products, u = fp32(products)
    * (sz * s1) + b1, the degree-8 fast-erf GELU, h quantised per row over
    the whole hidden width, y = fp32(products) * (sh * s2) + b2, one cast
    to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    z = (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()
    zq, sz = _quant_rows(z)
    u = _int_products(zq, w1q) * (sz * s1) + b1
    h = 0.5 * u * (1.0 + _erf_fast(u * _INV_SQRT2))
    hq, sh = _quant_rows(h)
    return (_int_products(hq, w2q) * (sh * s2) + b2).to(x.dtype)


def ln_mlp_backward_reference(x, g, b, w1, b1, w2, b2, eps: float, dy):
    """Plain version of the K2 backward, the formulas of the TPU kernel
    `_ln_bwd_kernel`: LN statistics recomputed in fp32 with the fast
    variance E[x^2] - mu^2; z, h and du rounded to x's dtype where they
    enter a product; exact erf GELU'. Returns (dx in x's dtype, then
    dgamma, dbeta, dW1 [H,C], db1, dW2 [C,H], db2 summed in fp32)."""
    dt, C = x.dtype, x.shape[-1]
    xf, dyf = x.float().reshape(-1, C), dy.float().reshape(-1, C)
    w1f, w2f = w1.float(), w2.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + eps)
    xhat = (xf - mu) * rstd
    z = (xhat * g.float() + b.float()).to(dt).float()
    u = z @ w1f.T + b1.float()
    h = F.gelu(u).to(dt).float()
    dgelu = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2)) + u * _INV_SQRT2PI * torch.exp(-0.5 * u * u)
    du = (dyf @ w2f) * dgelu
    du_c = du.to(dt).float()
    dz = du_c @ w1f
    dxhat = dz * g.float()
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    return (dx.to(dt).reshape(x.shape), (dz * xhat).sum(0), dz.sum(0), du_c.T @ z,
            du.sum(0), dyf.T @ h, dyf.sum(0))


def mlp_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of row 13: u = x W1^T + b1 in fp32, h = gelu(u) (exact
    erf) rounded to x's dtype, y = h W2^T + b2 in fp32, one cast."""
    u = F.linear(x.float(), w1.float(), b1.float())
    h = F.gelu(u).to(x.dtype)
    return F.linear(h.float(), w2.float(), b2.float()).to(x.dtype)


def mlp_backward_reference(x, w1, b1, w2, b2, dy):
    """Plain version of row 14, the formulas of the TPU kernel `_bwd_kernel`:
    u and gelu'(u) recomputed in fp32; dh = dy W2; du = dh * gelu'(u); dx =
    du_c W1; dW1 = du_c^T x; dW2 = dy^T h_c; db1 = sum(du) (the fp32 du);
    db2 = sum(dy), where _c is rounded to x's dtype. Returns (dx in x's
    dtype, then dW1 [H,C], db1, dW2 [C,H], db2 in fp32). b2 is not read: it
    is in the signature to mirror the forward."""
    dt, C = x.dtype, x.shape[-1]
    xf, dyf = x.float().reshape(-1, C), dy.float().reshape(-1, C)
    w1f, w2f = w1.float(), w2.float()
    u = xf @ w1f.T + b1.float()
    h = F.gelu(u).to(dt).float()
    dgelu = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2)) + u * _INV_SQRT2PI * torch.exp(-0.5 * u * u)
    du = (dyf @ w2f) * dgelu
    du_c = du.to(dt).float()
    dx = du_c @ w1f
    return dx.to(dt).reshape(x.shape), du_c.T @ xf, du.sum(0), dyf.T @ h, dyf.sum(0)


def sm90_form(C: int) -> Tuple[int, int, int, bool]:
    """The bf16 body's launch form at width C, as `csrc/ln_mlp_sm90.cuh`'s
    `Form<C>` chooses it: (rows per block, y columns per block, column
    parts, pipelined). Two consumer warpgroups of 64 rows up to C = 512, one
    at C = 768 (a 128-row z tile would not fit in shared memory); y's
    columns whole up to C = 192, else in parts of 160 (C = 320: wgmma's
    n160, as 256 does not divide it), 192 (C = 384) or 256, each part
    recomputing fc1 (a 64-row fp32 y wider than 256 columns does not fit
    beside u and h in a thread's registers); pipelined (chunk j's GELU
    beside chunk j + 1's fc1, u in two register sets) up to C = 192. The
    grid is (ceil(M / rows), parts)."""
    if C not in SUPPORTED_C:
        raise ValueError(f"C={C} not compiled (have {SUPPORTED_C})")
    cn = C if C <= 192 else {320: 160, 384: 192}.get(C, 256)
    return (128 if C <= 512 else 64), cn, C // cn, C <= 192


def int8_sm90_form(C: int) -> Tuple[int, int, int, int, int]:
    """Row 12's launch form at width C, as `csrc/ln_mlp_int8.cu`'s
    `i8sm90::Form<C>` chooses it: (rows per block, y columns per consumer
    warpgroup, column parts, W1 ring slots, shared memory bytes). Up to C =
    512 the two consumer warpgroups share a block's 64 rows: each takes half
    of every 128 hidden units of fc1 and half of y's columns of fc2, so
    nothing is computed twice. At C = 768 (a [64, 384] s32 accumulator
    would take 192 registers a thread) each consumer owns 64 of 128 rows
    and y's columns come in parts of 256, each part recomputing fc1's two
    passes. C = 320 (UniFormer-B's stage 3) is a shared form: y's 160
    columns a consumer (s8 wgmma n160), z codes in three 128-k boxes of
    which C fills 320 (TMA fills W1 with zeros past k = 320). Shared
    memory holds the block's z codes [rows, C], a 2-slot ring of W2 for 128
    hidden units (all C columns, or the part's 256), two [64, 128] tiles of
    h codes and 1024 bytes of alignment; the ring of W1
    boxes (128 or 64 units by 128 k) takes what is left of the block's
    227 KiB less 1280 bytes of static memory, at most 12 slots. The grid is
    (ceil(M / rows), parts). The int8 lab's C = 96 takes the parts form
    with one part and three consumers: each owns 64 of 192 rows and all 96
    columns (s8 wgmma n96), steps of 64 units, its own h code tile, its z
    codes and W1 boxes 128 k wide (TMA fills W1 with zeros past k = 96), on
    a persistent grid of at most one block per SM."""
    if C not in INT8_C + (INT8_LAB_C,):
        raise ValueError(f"C={C} not compiled (have {INT8_C + (INT8_LAB_C,)})")
    shared = INT8_LAB_C < C <= 512
    consumers = 3 if C == INT8_LAB_C else 2
    rows, cn = (64, C // 2) if shared else (64 * consumers, min(C, 256))
    box = (128 if shared else 64) * 128
    fixed = (rows * -(-C // 128) * 128 + 2 * (C if shared else cn) * 128
             + (2 if shared else consumers) * 64 * 128 + 1024)
    slots = min(12, (232448 - 1280 - fixed) // box)
    return rows, cn, 1 if shared else C // cn, slots, fixed + slots * box


def _check_weights(name, x, g, b, w1, b1, w2, b2):
    dtype = kernels.check_operands(name, x, g, b, w1, b1, w2, b2)
    C = x.shape[-1]
    H = w1.shape[0]
    if C not in SUPPORTED_C:
        raise ValueError(f"{name}: C={C} not compiled (have {SUPPORTED_C})")
    if (tuple(g.shape) != (C,) or tuple(b.shape) != (C,)
            or tuple(w1.shape) != (H, C) or tuple(b1.shape) != (H,)
            or tuple(w2.shape) != (C, H) or tuple(b2.shape) != (C,)):
        raise ValueError(f"{name}: weight shapes do not match C={C}, H={H}")
    M = x.numel() // C
    if M >= 2 ** 31:
        raise ValueError(f"{name}: {M} rows exceed the kernel's int range")
    if dtype == kernels.DTYPE_CODES[torch.bfloat16]:
        # tensor-core paths: 64-unit hidden chunks, 32-byte aligned operands
        # (the weights' TMA boxes need 16)
        if H % SM90_HC:
            raise ValueError(f"{name}: bf16 needs H % 64 == 0, got H={H}")
        if any(t.data_ptr() % 32 for t in (x, g, b, w1, b1, w2, b2)):
            raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    return dtype, M, C, H


def _launch(x, g, b, w1, b1, w2, b2, eps: float, shortcut=None, gamma=None,
            name: str = "ln_mlp") -> torch.Tensor:
    """The K2 forward kernel; with `shortcut` and `gamma` its epilogue emits
    shortcut + gamma * y (row 10)."""
    dtype, M, C, H = _check_weights(name, x, g, b, w1, b1, w2, b2)
    if shortcut is not None:
        kernels.check_operands(name, x, shortcut, gamma)
        if tuple(shortcut.shape) != tuple(x.shape) or tuple(gamma.shape) != (C,):
            raise ValueError(f"{name}: shortcut {tuple(shortcut.shape)} / gamma "
                             f"{tuple(gamma.shape)} for x {tuple(x.shape)}")
        if x.dtype == torch.bfloat16 and (shortcut.data_ptr() % 32 or gamma.data_ptr() % 32):
            raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    y = torch.empty_like(x)
    if M == 0:
        return y
    err = kernels.lib().mspi_ln_mlp(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), kernels.ptr(shortcut), kernels.ptr(gamma),
        y.data_ptr(), M, C, H, float(eps), dtype, kernels.stream_handle(x))
    kernels.check(err, name)
    return y


BWD_SMEM_LIMIT = 232448  # a block's shared memory on the H100


def bwd_sm90_form(C: int) -> Tuple[int, int, int]:
    """The bf16 backward's row pass at width C, as `csrc/ln_mlp_bwd_sm90.cuh`'s
    `Form<C>` chooses it: (rows per block, weight ring slots, dynamic
    shared memory bytes). Two consumer warpgroups of 64 rows up to C = 384,
    one above (two 128-row z and dy tiles would not fit); the block holds
    its z and dy tiles in [rows, 64] boxes of the 128-byte swizzle, 1 KiB of
    alignment slack and a ring of [64, 64] weight boxes, as many slots as
    fit beside the static barriers and db1 sums, at most 16. u and dh take 32 fp32
    registers each; dz = du W1 runs as its own product (a 64-row fp32 dz
    would take C / 2 registers a thread)."""
    if C not in SUPPORTED_C:
        raise ValueError(f"C={C} not compiled (have {SUPPORTED_C})")
    rows = 128 if C <= 384 else 64
    fixed = 2 * -(-C // 64) * rows * 128 + 1024
    static = 2 * (rows // 64) * 4 * 64 * 4 + 128  # the barriers and the db1 sums
    slots = min(16, (BWD_SMEM_LIMIT - fixed - static) // (64 * 128))
    return rows, slots, fixed + slots * 64 * 128


def bwd_parts(M: int, C: int, sms: int) -> int:
    """The bf16 row pass's hidden parts at M rows: the P in 1 .. H / 64 (blocks
    per row tile, each taking a contiguous run of the 64-unit chunks) that
    minimises waves x (chunks per block + 1) on `sms` SMs at one block per
    SM, the smallest such; the + 1 stands for a block's prologue (its rows'
    LayerNorm and the z and dy tiles), which every part repeats. At the
    MViTv2-S shapes (batch 2, 132 SMs): 1 at stage 1, 3 at stages 2-3, 6 at
    stage 4."""
    rows = bwd_sm90_form(C)[0]
    tiles, n_h = -(-M // rows), 4 * C // SM90_HC
    return min(range(1, n_h + 1),
               key=lambda p: (-(-tiles * p // sms) * (-(-n_h // p) + 1), p))


BWD_SM90_TILE = (64, 128)  # the bf16 weight products' output tile (rows, columns)


def bwd_segments(dtype: int, M: int, C: int, H: int, sms: int) -> int:
    """Row segments of the weight-gradient sums: enough blocks for two waves
    of the card's SMs over the output tiles of dW1 [H, C] (fp32: 64 x 64
    tiles; bf16: 64 x 128, and segments of whole 64-row tiles), at most one
    segment per 256 rows (fp32) or per 64-row tile (bf16)."""
    if dtype == kernels.DTYPE_CODES[torch.bfloat16]:
        out_tiles, most = -(-H // BWD_SM90_TILE[0]) * -(-C // BWD_SM90_TILE[1]), -(-M // 64)
    else:
        out_tiles, most = -(-H // 64) * -(-C // 64), -(-M // 256)
    return max(1, min(most, -(-2 * sms // out_tiles)))


def _bwd_buffers(name, x, dy, dtype: int, M: int, C: int, H: int):
    """What the K2 and row-14 backward kernels need of dy, and their
    buffers -> (row segments of the weight sums, hidden parts of the bf16
    row pass (1 in fp32), (dx; h and du_c [M, H] for
    the weight products; bf16: dz = du W1 [M, C] in fp32, else None; the fp32
    column sums per row tile [tiles, 3C + H] and their total; the fp32
    weight sums per segment [segments, 2HC] and their total))."""
    kernels.check_operands(name, x, dy)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    if M == 0:
        raise ValueError(f"{name}: no rows")
    bf16 = dtype == kernels.DTYPE_CODES[torch.bfloat16]
    if bf16 and dy.data_ptr() % 32:
        raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    tiles = -(-M // kernels.lib().mspi_ln_mlp_bwd_rows(C, dtype))
    segments = bwd_segments(dtype, M, C, H, kernels.num_sms(x))
    parts = bwd_parts(M, C, kernels.num_sms(x)) if bf16 else 1
    f32 = dict(device=x.device, dtype=torch.float32)
    hc = torch.empty((M, H), device=x.device, dtype=x.dtype)
    dz = torch.empty((M, C), **f32) if bf16 else None
    return segments, parts, (torch.empty_like(x), hc, torch.empty_like(hc), dz,
                      torch.empty((tiles, 3 * C + H), **f32), torch.empty(3 * C + H, **f32),
                      torch.empty((segments, 2 * H * C), **f32), torch.empty(2 * H * C, **f32))


def ln_mlp_backward(x, g, b, w1, b1, w2, b2, eps: float, dy):
    """K2 backward -> (dx, dgamma, dbeta, dW1, db1, dW2, db2); dx in x's
    dtype, the parameter gradients in fp32. The kernel on the card, the
    plain version on the CPU."""
    if not kernels.dispatch_device(x, g, b, w1, b1, w2, b2, dy):
        return ln_mlp_backward_reference(x, g, b, w1, b1, w2, b2, eps, dy)
    name = "ln_mlp_bwd"
    dtype, M, C, H = _check_weights(name, x, g, b, w1, b1, w2, b2)
    segments, parts, (dx, hc, duc, dz, col_part, col_out, w_part, w_out) = _bwd_buffers(
        name, x, dy, dtype, M, C, H)
    zc = torch.empty((M, C), device=x.device, dtype=x.dtype)
    err = kernels.lib().mspi_ln_mlp_bwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), dy.data_ptr(), dx.data_ptr(), zc.data_ptr(), hc.data_ptr(),
        duc.data_ptr(), kernels.ptr(dz), col_part.data_ptr(), col_out.data_ptr(),
        w_part.data_ptr(), w_out.data_ptr(), M, C, H, float(eps), segments, parts, dtype,
        kernels.stream_handle(x))
    kernels.check(err, name)
    kernels.launches[name] += 1
    dg, dbe, db2, db1 = col_out.split([C, C, C, H])
    dw1, dw2 = w_out[:H * C].view(H, C), w_out[H * C:].view(C, H)
    return dx, dg, dbe, dw1, db1, dw2, db2


class _LnMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, eps):
        params = (g, b, w1, b1, w2, b2)
        ctx.param_dtypes = [p.dtype for p in params]
        ctx.eps = eps
        ws = tuple(p.to(x.dtype) for p in params)  # the kernel takes one dtype
        ctx.save_for_backward(x, *ws)
        if not kernels.dispatch_device(x, *ws):
            return ln_mlp_reference(x, *ws, eps)
        y = _launch(x, *ws, eps)
        kernels.launches["ln_mlp"] += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        dx, *dws = ln_mlp_backward(x, *ws, ctx.eps, dy.contiguous())
        return (dx, *(d.to(t) for d, t in zip(dws, ctx.param_dtypes)), None)


def ln_mlp(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """K2: fc2(gelu(fc1(LN(x)))) over the last axis of x [..., C];
    differentiable in x and every weight. Under CUDA autocast x runs in the
    autocast dtype; the weights are cast to x's dtype for the kernel and
    get their gradients in their own dtype."""
    (x,) = kernels.cast_for_autocast(x)
    return _LnMlp.apply(x, g, b, w1, b1, w2, b2, float(eps))


def ln_mlp_prior(x, g, b, w1, b1, w2, b2, eps: float = 1e-6) -> torch.Tensor:
    """K3's call site: the ConvNeXt prior's LN+MLP on channels-last tokens,
    served by the K2 kernel and counted on its own. Forward only: the
    prior is frozen."""
    (x,) = kernels.cast_for_autocast(x)
    g, b, w1, b1, w2, b2 = (t.to(x.dtype) for t in (g, b, w1, b1, w2, b2))
    if not kernels.dispatch_device(x, g, b, w1, b1, w2, b2):
        return ln_mlp_reference(x, g, b, w1, b1, w2, b2, eps)
    y = _launch(x, g, b, w1, b1, w2, b2, eps)
    kernels.launches["ln_mlp_prior"] += 1
    return y


def ln_mlp_prior_res(x, shortcut, gamma, g, b, w1, b1, w2, b2,
                     eps: float = 1e-6) -> torch.Tensor:
    """Row 10 (`fused_ln_mlp_t_res`): the ConvNeXt prior's block tail
    shortcut + gamma * fc2(gelu(fc1(LN(x)))) from one K2 launch, the sum
    taken in fp32 in the epilogue with one cast, so y never reaches device
    memory. Forward only, like the JAX function (the prior is frozen).

    In fp32 the JAX package sends C = 768 to its unfolded token-major path
    (the transposed kernel's weights overflow VMEM there); in fp32 the two
    forms compute the same shortcut + gamma * y, so the port folds every
    width."""
    x, shortcut = kernels.cast_for_autocast(x, shortcut)
    gamma, g, b, w1, b1, w2, b2 = (t.to(x.dtype) for t in (gamma, g, b, w1, b1, w2, b2))
    if not kernels.dispatch_device(x, shortcut, gamma, g, b, w1, b1, w2, b2):
        return ln_mlp_prior_res_reference(x, shortcut, gamma, g, b, w1, b1, w2, b2, eps)
    name = "ln_mlp_prior_res"
    y = _launch(x, g, b, w1, b1, w2, b2, eps, shortcut, gamma, name)
    kernels.launches[name] += 1
    return y


def _check_int8(name, x, g, b, w1q, s1, b1, w2q, s2, b2):
    if x.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (fp32 or bf16)")
    C, H = x.shape[-1], w1q.shape[0]
    if C not in INT8_C:
        raise ValueError(f"{name}: C={C} not compiled (have {INT8_C})")
    if H % INT8_HC:
        raise ValueError(f"{name}: needs H % {INT8_HC} == 0, got H={H}")
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8:
        raise TypeError(f"{name}: weight codes must be int8")
    if tuple(w1q.shape) != (H, C) or tuple(w2q.shape) != (C, H):
        raise ValueError(f"{name}: weight codes {tuple(w1q.shape)}, {tuple(w2q.shape)} "
                         f"for C={C}")
    for t, n in ((g, C), (b, C), (s1, H), (b1, H), (s2, C), (b2, C)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: LN, scale and bias vectors must be fp32 of the "
                             f"layer widths, got {t.dtype} {tuple(t.shape)}")
    for t in (x, g, b, w1q, s1, b1, w2q, s2, b2):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")
    if w1q.data_ptr() % 16 or w2q.data_ptr() % 16:
        raise ValueError(f"{name}: weight codes must be 16-byte aligned")
    M = x.numel() // C
    if M >= 2 ** 31:
        raise ValueError(f"{name}: {M} rows exceed the kernel's int range")
    return M, C, H


def ln_mlp_int8(x, g, b, w1q, s1, b1, w2q, s2, b2, eps: float) -> torch.Tensor:
    """Row 12 (`fused_ln_mlp_int8`): int8 inference of fc2(gelu(fc1(LN(x))))
    over the last axis of x [..., C]. w1q [H, C] / w2q [C, H] int8 codes
    with fp32 per-output-channel scales s1 [H] / s2 [C] (`quantize_weight`);
    g, b, b1, b2 fp32; the output in x's dtype. No backward: the JAX
    function has no VJP, so this refuses operands that need a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, g, b, s1, b1, s2, b2)):
        raise RuntimeError("ln_mlp_int8 is inference only: call it under torch.no_grad()")
    if not kernels.dispatch_device(x, g, b, w1q, s1, b1, w2q, s2, b2):
        return ln_mlp_int8_reference(x, g, b, w1q, s1, b1, w2q, s2, b2, eps)
    name = "ln_mlp_int8"
    M, C, H = _check_int8(name, x, g, b, w1q, s1, b1, w2q, s2, b2)
    y = torch.empty_like(x)
    if M == 0:
        return y
    err = kernels.lib().mspi_ln_mlp_int8(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1q.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(), b2.data_ptr(), y.data_ptr(), M, C, H,
        float(eps), kernels.DTYPE_CODES[x.dtype], kernels.stream_handle(x))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return y


_INT8_BUFFERS = ("int8_g", "int8_b", "int8_w1q", "int8_s1", "int8_b1", "int8_w2q",
                 "int8_s2", "int8_b2")


def int8_operands(norm: nn.LayerNorm, mlp: nn.Module) -> Tuple[torch.Tensor, ...]:
    """(g, b, w1q, s1, b1, w2q, s2, b2) of a block's norm + MLP for
    `ln_mlp_int8`: the weights quantised per output channel and the vectors
    in fp32, kept as non-persistent buffers of `mlp`. They are computed once
    (a model built with quant="int8" does it at set-up) and again only when
    a parameter has changed since (a loaded state_dict, a moved model)."""
    params = (norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
              mlp.fc2.bias)
    key = tuple((p.data_ptr(), p._version) for p in params)
    if getattr(mlp, "_int8_key", None) != key:
        with torch.no_grad():
            w1q, s1 = quantize_weight(mlp.fc1.weight)
            w2q, s2 = quantize_weight(mlp.fc2.weight)
            values = (norm.weight.float(), norm.bias.float(), w1q, s1, mlp.fc1.bias.float(),
                      w2q, s2, mlp.fc2.bias.float())
        for name, t in zip(_INT8_BUFFERS, values):
            mlp.register_buffer(name, t.contiguous(), persistent=False)
        mlp._int8_key = key
    return tuple(getattr(mlp, n) for n in _INT8_BUFFERS)


def ln_mlp_block(norm: nn.LayerNorm, mlp: nn.Module, x, int8: bool) -> torch.Tensor:
    """A transformer block's mlp(norm(x)), routed as the JAX package's
    `_dispatch_ln_mlp`: `ln_mlp_int8` when the caller asks for int8 (its
    quant option at inference) and C >= QUANT_MIN_C, else K2."""
    if int8 and x.shape[-1] >= QUANT_MIN_C:
        return ln_mlp_int8(x, *int8_operands(norm, mlp), norm.eps)
    return ln_mlp(x, norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                  mlp.fc2.bias, norm.eps)


def _check_mlp(name, x, w1, b1, w2, b2):
    """What rows 13-14 need of their operands: K2's widths without the
    LayerNorm vectors."""
    return _check_weights(name, x, b2, b2, w1, b1, w2, b2)


def _mlp_launch(x, w1, b1, w2, b2) -> torch.Tensor:
    name = "mlp"
    dtype, M, C, H = _check_mlp(name, x, w1, b1, w2, b2)
    y = torch.empty_like(x)
    if M == 0:
        return y
    err = kernels.lib().mspi_mlp(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                 b2.data_ptr(), y.data_ptr(), M, C, H, dtype,
                                 kernels.stream_handle(x))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return y


def mlp_backward(x, w1, b1, w2, b2, dy):
    """Row 14 -> (dx, dW1, db1, dW2, db2); dx in x's dtype, the parameter
    gradients in fp32. The kernel on the card, the plain version on the
    CPU."""
    if not kernels.dispatch_device(x, w1, b1, w2, b2, dy):
        return mlp_backward_reference(x, w1, b1, w2, b2, dy)
    name = "mlp_bwd"
    dtype, M, C, H = _check_mlp(name, x, w1, b1, w2, b2)
    segments, parts, (dx, hc, duc, dz, col_part, col_out, w_part, w_out) = _bwd_buffers(
        name, x, dy, dtype, M, C, H)
    err = kernels.lib().mspi_mlp_bwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        hc.data_ptr(), duc.data_ptr(), kernels.ptr(dz), col_part.data_ptr(),
        col_out.data_ptr(), w_part.data_ptr(), w_out.data_ptr(), M, C, H, segments, parts,
        dtype, kernels.stream_handle(x))
    kernels.check(err, name)
    kernels.launches[name] += 1
    db2, db1 = col_out[2 * C:].split([C, H])
    return dx, w_out[:H * C].view(H, C), db1, w_out[H * C:].view(C, H), db2


class _Mlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        params = (w1, b1, w2, b2)
        ctx.param_dtypes = [p.dtype for p in params]
        ws = tuple(p.to(x.dtype) for p in params)  # the kernel takes one dtype
        ctx.save_for_backward(x, *ws)
        if not kernels.dispatch_device(x, *ws):
            return mlp_reference(x, *ws)
        return _mlp_launch(x, *ws)

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        dx, *dws = mlp_backward(x, *ws, dy.contiguous())
        return (dx, *(d.to(t) for d, t in zip(dws, ctx.param_dtypes)))


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """Rows 13-14: fc2(gelu(fc1(x))) over the last axis of x [..., C] with
    w1 [H, C], b1 [H], w2 [C, H], b2 [C] (nn.Linear layout; the JAX
    function takes the transposes); differentiable in x and every weight.
    The weights are cast to x's dtype for the kernel and get their
    gradients in their own dtype; under CUDA autocast x runs in the
    autocast dtype."""
    (x,) = kernels.cast_for_autocast(x)
    return _Mlp.apply(x.contiguous(), w1, b1, w2, b2)


def maybe_fused_mlp(mlp: nn.Module, x: torch.Tensor):
    """`fused_mlp` on an MLP module with `fc1` / `fc2` linear layers, or None
    where the caller should take the plain layers: as the JAX function, for
    a layer without a bias or fc2's output width other than fc1's input
    width; and where the kernel has no instantiation (the port's
    counterpart of `fits_vmem`): C outside SUPPORTED_C, or in bf16 a hidden
    width that is not a multiple of 64."""
    fc1, fc2 = mlp.fc1, mlp.fc2
    if fc1.bias is None or fc2.bias is None:
        return None
    H, C = fc1.weight.shape
    if tuple(fc2.weight.shape) != (C, H) or C not in SUPPORTED_C:
        return None
    (xc,) = kernels.cast_for_autocast(x)
    if xc.dtype == torch.bfloat16 and H % 64:
        return None
    return fused_mlp(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
