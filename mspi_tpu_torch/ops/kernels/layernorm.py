"""LayerNorm alone over the channels of channels-last tokens (TPU row 11).

Counterpart of `mspi_tpu/ops/pallas/mlp.py::fused_ln_t` (kernel
`_ln_only_kernel_t`), which the JAX package runs on the ConvNeXt prior's
stem and downsample LayerNorms with MSPI_PRIOR_LN_T=1. That kernel's
[N, C, B*T] layout served only the TPU's batch-minor lanes; here the same
function runs over the last axis of x [..., C]. Kernel source:
`mspi_tpu_torch/csrc/layernorm.cu` (`layernorm_sm90_kernel`, in the form
`layernorm_form` mirrors). Forward only: the prior is frozen.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mspi_tpu_torch.ops import kernels

LAYERNORM_C = (96, 192, 384, 768)  # the prior's widths, compiled in the kernel
LN_LANE_CHANNELS = 24  # channels a lane owns


def layernorm_form(C: int, dtype: torch.dtype, aligned: bool) -> Tuple[int, int, int]:
    """The kernel's form, as `csrc/layernorm.cu`'s `LnForm<T, C>` and the
    launch choose it: (lanes per row, loads per lane per row, rows per warp
    step). A row belongs to C / 24 lanes, each owning 24 channels: as
    16-byte chunks (3 of bf16, 6 of fp32) when x and y start 16 bytes
    aligned, else one element a load (24)."""
    if C not in LAYERNORM_C:
        raise ValueError(f"C={C} not compiled (have {LAYERNORM_C})")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype} not supported (fp32 or bf16)")
    lanes = C // LN_LANE_CHANNELS
    per_load = 16 // torch.empty((), dtype=dtype).element_size() if aligned else 1
    return lanes, LN_LANE_CHANNELS // per_load, 32 // lanes


def layernorm_tokens_reference(x, g, b, eps: float) -> torch.Tensor:
    """Plain version: statistics in fp32 with var = E[x^2] - mu^2, as the
    TPU kernel takes them, then one cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()).to(x.dtype)


def layernorm_tokens(x, g, b, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of x [..., C]; g and b are cast to x's
    dtype, as the JAX package passes them in the storage dtype."""
    (x,) = kernels.cast_for_autocast(x)
    g, b = g.to(x.dtype), b.to(x.dtype)
    x = x.contiguous()
    if not kernels.dispatch_device(x, g, b):
        return layernorm_tokens_reference(x, g, b, eps)
    name = "layernorm_tokens"
    dtype = kernels.check_operands(name, x, g, b)
    C = x.shape[-1]
    if C not in LAYERNORM_C:
        raise ValueError(f"{name}: C={C} not compiled (have {LAYERNORM_C})")
    # x at any element offset: the kernel picks its scalar form (layernorm_form)
    if tuple(g.shape) != (C,) or tuple(b.shape) != (C,):
        raise ValueError(f"{name}: weight shapes {tuple(g.shape)}, {tuple(b.shape)} "
                         f"for C={C}")
    M = x.numel() // C
    if M >= 2 ** 31:
        raise ValueError(f"{name}: {M} rows exceed the kernel's int range")
    y = torch.empty_like(x)
    if M == 0:
        return y
    err = kernels.lib().mspi_layernorm(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                                       M, C, float(eps), dtype, kernels.stream_handle(x))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return y
