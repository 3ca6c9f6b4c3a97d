"""Fused LayerNorm + MLP: y = fc2(gelu(fc1(LN(x)))) — kernel K2 and the
call site of K3.

Counterpart of `mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp` (K2) and
`fused_ln_mlp_t` (K3). K3's transposed [N, C, B*T] layout served only the
TPU's batch-minor lane tiling; the ConvNeXt prior calls the same CUDA kernel
on its channels-last tokens through `ln_mlp_prior`, which keeps its own
launch count. Kernel source: `mspi_tpu_torch/csrc/ln_mlp.cu`.

Weights come in `nn.Linear` layout: w1 [H, C], w2 [C, H]. Residual,
drop-path and layer-scale stay with the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mspi_tpu_torch.ops import kernels

SUPPORTED_C = (96, 192, 384, 512, 768)


def ln_mlp_reference(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Plain version: LN statistics in fp32, z and h rounded to x's dtype at
    the points the kernel rounds them, exact erf GELU."""
    C = x.shape[-1]
    z = F.layer_norm(x.float(), (C,), g.float(), b.float(), eps).to(x.dtype)
    h = F.gelu(F.linear(z.float(), w1.float(), b1.float())).to(x.dtype)
    return F.linear(h.float(), w2.float(), b2.float()).to(x.dtype)


def _launch(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    name = "ln_mlp"
    dtype = kernels.check_operands(name, x, g, b, w1, b1, w2, b2)
    C = x.shape[-1]
    H = w1.shape[0]
    if C not in SUPPORTED_C:
        raise ValueError(f"{name}: C={C} not compiled (have {SUPPORTED_C})")
    if (tuple(g.shape) != (C,) or tuple(b.shape) != (C,)
            or tuple(w1.shape) != (H, C) or tuple(b1.shape) != (H,)
            or tuple(w2.shape) != (C, H) or tuple(b2.shape) != (C,)):
        raise ValueError(f"{name}: weight shapes do not match C={C}, H={H}")
    if dtype == kernels.DTYPE_CODES[torch.bfloat16]:
        # tensor-core path: 64-unit hidden chunks, 32-byte aligned fragments
        if H % 64:
            raise ValueError(f"{name}: bf16 needs H % 64 == 0, got H={H}")
        if any(t.data_ptr() % 32 for t in (x, g, b, w1, b1, w2, b2)):
            raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    M = x.numel() // C
    if M >= 2 ** 31:
        raise ValueError(f"{name}: {M} rows exceed the kernel's int range")
    y = torch.empty_like(x)
    if M == 0:
        return y
    err = kernels.lib().mspi_ln_mlp(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), y.data_ptr(), M, C, H, float(eps), dtype,
        kernels.stream_handle(x))
    kernels.check(err, name)
    return y


def ln_mlp(x, g, b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """K2: fc2(gelu(fc1(LN(x)))) over the last axis of x [..., C]."""
    if not kernels.dispatch_device(x, g, b, w1, b1, w2, b2):
        return ln_mlp_reference(x, g, b, w1, b1, w2, b2, eps)
    y = _launch(x, g, b, w1, b1, w2, b2, eps)
    kernels.launches["ln_mlp"] += 1
    return y


def ln_mlp_prior(x, g, b, w1, b1, w2, b2, eps: float = 1e-6) -> torch.Tensor:
    """K3's call site: the ConvNeXt prior's LN+MLP on channels-last tokens,
    served by the K2 kernel and counted on its own."""
    if not kernels.dispatch_device(x, g, b, w1, b1, w2, b2):
        return ln_mlp_reference(x, g, b, w1, b1, w2, b2, eps)
    y = _launch(x, g, b, w1, b1, w2, b2, eps)
    kernels.launches["ln_mlp_prior"] += 1
    return y
