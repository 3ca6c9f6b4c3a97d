"""Fused LayerNorm + MLP: y = fc2(gelu(fc1(LN(x)))) — kernel K2 and the
call site of K3.

Counterpart of `mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp` (K2, with its
custom VJP `_ln_bwd_impl`) and `fused_ln_mlp_t` (K3). K3's transposed
[N, C, B*T] layout served only the TPU's batch-minor lane tiling; the
ConvNeXt prior calls the same CUDA kernel on its channels-last tokens
through `ln_mlp_prior`, which keeps its own launch count and, like K3, has
no backward (the prior is frozen). Kernel sources:
`mspi_tpu_torch/csrc/ln_mlp.cu` (forward) and `csrc/ln_mlp_bwd.cu`.

`ln_mlp` is a `torch.autograd.Function`: it saves x and the weights and
its backward recomputes LN, u and h from them, as the TPU kernel does.

Weights come in `nn.Linear` layout: w1 [H, C], w2 [C, H]. Residual,
drop-path and layer-scale stay with the caller.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mspi_tpu_torch.ops import kernels

SUPPORTED_C = (96, 192, 384, 512, 768)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def ln_mlp_reference(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Plain version: LN statistics in fp32, z and h rounded to x's dtype at
    the points the kernel rounds them, exact erf GELU."""
    C = x.shape[-1]
    z = F.layer_norm(x.float(), (C,), g.float(), b.float(), eps).to(x.dtype)
    h = F.gelu(F.linear(z.float(), w1.float(), b1.float())).to(x.dtype)
    return F.linear(h.float(), w2.float(), b2.float()).to(x.dtype)


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
        # tensor-core path: 64-unit hidden chunks, 32-byte aligned fragments
        if H % 64:
            raise ValueError(f"{name}: bf16 needs H % 64 == 0, got H={H}")
        if any(t.data_ptr() % 32 for t in (x, g, b, w1, b1, w2, b2)):
            raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    return dtype, M, C, H


def _launch(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    name = "ln_mlp"
    dtype, M, C, H = _check_weights(name, x, g, b, w1, b1, w2, b2)
    y = torch.empty_like(x)
    if M == 0:
        return y
    err = kernels.lib().mspi_ln_mlp(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), y.data_ptr(), M, C, H, float(eps), dtype,
        kernels.stream_handle(x))
    kernels.check(err, name)
    return y


def ln_mlp_backward(x, g, b, w1, b1, w2, b2, eps: float, dy):
    """K2 backward -> (dx, dgamma, dbeta, dW1, db1, dW2, db2); dx in x's
    dtype, the parameter gradients in fp32. The kernel on the card, the
    plain version on the CPU."""
    if not kernels.dispatch_device(x, g, b, w1, b1, w2, b2, dy):
        return ln_mlp_backward_reference(x, g, b, w1, b1, w2, b2, eps, dy)
    name = "ln_mlp_bwd"
    dtype, M, C, H = _check_weights(name, x, g, b, w1, b1, w2, b2)
    kernels.check_operands(name, x, dy)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    if M == 0:
        raise ValueError(f"{name}: no rows")
    if dtype == kernels.DTYPE_CODES[torch.bfloat16] and dy.data_ptr() % 32:
        raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    lib = kernels.lib()
    rows = lib.mspi_ln_mlp_bwd_rows(C, dtype)
    tiles = -(-M // rows)
    out_tiles = -(-H // 64) * -(-C // 64)
    segments = max(1, min(-(-M // 256), -(-2 * kernels.num_sms(x) // out_tiles)))
    f32 = dict(device=x.device, dtype=torch.float32)
    dx, zc = torch.empty_like(x), torch.empty((M, C), device=x.device, dtype=x.dtype)
    hc = torch.empty((M, H), device=x.device, dtype=x.dtype)
    duc = torch.empty_like(hc)
    col_part = torch.empty((tiles, 3 * C + H), **f32)
    col_out = torch.empty(3 * C + H, **f32)
    w_part = torch.empty((segments, 2 * H * C), **f32)
    w_out = torch.empty(2 * H * C, **f32)
    err = lib.mspi_ln_mlp_bwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), dy.data_ptr(), dx.data_ptr(), zc.data_ptr(), hc.data_ptr(),
        duc.data_ptr(), col_part.data_ptr(), col_out.data_ptr(), w_part.data_ptr(),
        w_out.data_ptr(), M, C, H, float(eps), segments, dtype, kernels.stream_handle(x))
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
