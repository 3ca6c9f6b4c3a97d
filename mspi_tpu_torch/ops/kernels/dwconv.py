"""Row 18 `dwconv3d`: stride-1 SAME depthwise 3-D convolution on
channels-last tokens (MViT's stride-1 attention pools), with its backward;
and row 19 `dwconv2d`, the 7x7 depthwise conv2d of the dwconv kernel lab.

Counterpart of `mspi_tpu/ops/pallas/dwconv.py::fused_dwconv3d` and its
custom VJP. Kernel source: `mspi_tpu_torch/csrc/dwconv.cu`.

`dwconv3d` is a `torch.autograd.Function`: dx is the same kernel on dy
with the kernel flipped in t, h and w (a second launch, counted), as the
JAX package's backward reuses its Pallas kernel; dw is PyTorch's conv
weight gradient, as the JAX package takes dw from XLA. On the CPU the
forward and dx run the plain version below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mspi_tpu_torch.ops import kernels

KERNEL = (3, 3, 3)  # the kernel the CUDA kernel is compiled for (MViT's pools)


def dwconv3d_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x [N,T,H,W,C], w [C,1,kt,kh,kw] (odd kernel) ->
    [N,T,H,W,C], zeros outside the grid; fp32 products summed over the taps
    in (dt, dh, dw) order, rounded to x's dtype."""
    kt, kh, kw = w.shape[2:]
    N, T, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2, kt // 2, kt // 2))
    wf = w.float()
    acc = None
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                term = xp[:, dt:dt + T, dh:dh + H, dw:dw + W] * wf[:, 0, dt, dh, dw]
                acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def dwconv3d_backward_reference(x, w, dy):
    """Plain version of the backward in fp32 -> (dx, dw): dx is the
    convolution of dy with the flipped kernel, dw[c, 0, dt, dh, dw] the sum
    over every position of the shifted x times dy."""
    kt, kh, kw = w.shape[2:]
    N, T, H, W, C = x.shape
    dx = dwconv3d_reference(dy.float(), w.float().flip(2, 3, 4))
    xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2, kt // 2, kt // 2))
    dyf = dy.float()
    dw = torch.stack([(xp[:, dt:dt + T, dh:dh + H, d:d + W] * dyf).sum((0, 1, 2, 3))
                      for dt in range(kt) for dh in range(kh) for d in range(kw)], dim=1)
    return dx.to(x.dtype), dw.reshape(C, 1, kt, kh, kw).to(w.dtype)


def supported(kernel, stride) -> bool:
    """The pools row 18 serves: stride 1 and an odd kernel (the CUDA kernel
    takes 3x3x3, MViT's)."""
    return tuple(stride) == (1, 1, 1) and all(k % 2 == 1 for k in kernel)


def _dwconv3d_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel on the card, the plain version on the CPU."""
    if not kernels.dispatch_device(x, w):
        return dwconv3d_reference(x, w)
    name = "dwconv3d"
    N, T, H, W, C = x.shape
    if tuple(w.shape) != (C, 1, *KERNEL):
        raise ValueError(f"{name}: weight {tuple(w.shape)} for {C} channels; the kernel "
                         f"is compiled for {KERNEL}")
    taps = w.reshape(C, -1).t().contiguous()  # [27, C], (dt, dh, dw) row-major
    dtype = kernels.check_operands(name, x, taps)
    y = torch.empty_like(x)
    err = kernels.lib().mspi_dwconv3d(x.data_ptr(), taps.data_ptr(), y.data_ptr(), N, T, H, W,
                                      C, dtype, kernels.stream_handle(x))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return y


def dwconv3d_backward(x, w, dy):
    """-> (dx, dw): dx = row 18 on dy with the flipped kernel (the plain
    version on the CPU), dw = PyTorch's conv weight gradient on the
    NCDHW-contiguous operands (cuDNN runs channels-last grouped 3-D convs
    one launch per group)."""
    dx = _dwconv3d_fwd(dy, w.flip(2, 3, 4).contiguous())
    C = x.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3).contiguous(), tuple(w.shape),
        dy.permute(0, 4, 1, 2, 3).contiguous(), padding=tuple(k // 2 for k in w.shape[2:]),
        groups=C)
    return dx, dw


class _DWConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _dwconv3d_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return dwconv3d_backward(x, w, dy.contiguous())


def dwconv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row 18. x [N,T,H,W,C] channels-last, w [C,1,kt,kh,kw] (a depthwise
    nn.Conv3d's weight; the kernel in x's dtype) -> [N,T,H,W,C]: stride 1,
    SAME zero padding, no bias; differentiable in x and w."""
    x, w = kernels.cast_for_autocast(x, w)
    return _DWConv3d.apply(x.contiguous(), w.to(x.dtype))


def dwconv2d_reference(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of row 19 in the TPU kernel's arithmetic (no conv
    call): x [N,H,W,C] zero-padded by 3, the fp32 accumulator starting from
    the bias, then the 49 shifted products added in (i, j) order, one
    rounding to x's dtype. k [7,7,C], b [C]."""
    kh, kw = k.shape[:2]
    N, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    kf = k.float()
    acc = b.float().expand(N, H, W, C)
    for i in range(kh):
        for j in range(kw):
            acc = acc + xp[:, i:i + H, j:j + W] * kf[i, j]
    return acc.to(x.dtype)


def dwconv2d(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row 19 (`tools/bench_dwconv.py::pallas_dwconv`): 7x7 depthwise conv2d,
    stride 1, zero padding 3, plus the bias, on channels-last x [N,H,W,C];
    k [7,7,C] and b [C] in x's dtype. Forward only, as the lab's kernel.
    The kernel (`csrc/dwconv2d.cu`) on the card, the plain version on the
    CPU."""
    if not kernels.dispatch_device(x, k, b):
        return dwconv2d_reference(x, k, b)
    name = "dwconv2d"
    N, H, W, C = x.shape
    if tuple(k.shape) != (7, 7, C) or tuple(b.shape) != (C,):
        raise ValueError(f"{name}: kernel {tuple(k.shape)} and bias {tuple(b.shape)} for "
                         f"{C} channels; the kernel is compiled for 7x7")
    dtype = kernels.check_operands(name, x, k, b)
    y = torch.empty_like(x)
    err = kernels.lib().mspi_dwconv2d(x.data_ptr(), k.data_ptr(), b.data_ptr(), y.data_ptr(),
                                      N, H, W, C, dtype, kernels.stream_handle(x))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return y
