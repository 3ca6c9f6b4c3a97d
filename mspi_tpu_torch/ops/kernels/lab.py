"""The kernel labs' kernels (TPU rows 20 and 21) and their plain versions.

Counterparts of the Pallas bodies of the JAX package's kernel labs, which
`mspi_tpu_torch/tools/bench_lnmlp.py` and `bench_int8.py` time (row 19,
the 7x7 depthwise conv of `bench_dwconv.py`, is `dwconv.dwconv2d`). None of
them is on a model's path: `ln_mlp.py` stays the production module.

- `ln_mlp_lab(x, g, b, w1, b1, w2, b2, variant)`: row 20,
  `tools/bench_lnmlp.py::_call` with one of its five bodies, as K2's body
  compiled in a variant (`csrc/lnmlp_lab.cu`; bf16, C = 96 only):
  `matmul` (`_k_matmul`: no LN, no GELU), `matmul_gelu`
  (`_k_matmul_gelu`), `ln_matmul` (`_k_ln_matmul`: no GELU), `pipe2` /
  `pipe4` (`_k_pipe`, k = 2 / 4: the row tile in k groups, each group's
  fc1 tensor-core products issued before the previous group's GELU) and
  `mxu_stats` (`_k_mxu_stats`: the LN row sums on the tensor cores). The LN
  is the labs' `_ln_f32` (var = E[x^2] - mu^2); the GELU is K2's exact erf
  (the TPU bodies' degree-16 fit is within 2e-7 of it).
- row 21, `tools/bench_int8.py`: `gemm(a, b)` (`_gemm`; `csrc/gemm_lab.cu`)
  in bf16 and int8 (the s32 sum cut to int8 by wrap-around, as the TPU's
  astype does; int8 `wgmma` reads b K-major, so the call makes b^T in a
  scratch tensor first, with 64- or 128-row tiles, `gemm_int8_block_m`);
  `mlp_bf16(x, w1, w2)` (`_mlp_bf16_kernel`: K2's body with LN, biases and
  GELU compiled out) and `mlp_int8w(x, w1q, s1, w2q, s2)`
  (`_mlp_int8w_kernel`: row 12's two-pass int8 body with LN, biases and
  GELU compiled out and the lab's divide-form quantisation,
  `csrc/ln_mlp_int8.cu`), with the lab's host weight quantisation
  `quantize_weight_lab`.

Every plain version is written from the TPU body it stands for. The
dispatch rule is the port's: CUDA tensors launch the kernel or raise, CPU
tensors run the plain version. Each body has its own launch count
(`lab_<variant>`, `gemm_bf16`, `gemm_int8`, `mlp_bf16`, `mlp_int8w`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels.ln_mlp import _int_products

LAB_VARIANTS = ("matmul", "matmul_gelu", "ln_matmul", "pipe2", "pipe4", "mxu_stats")
_MLP_BF16_CODE = len(LAB_VARIANTS)  # the K2-body variant code of mlp_bf16 (csrc/lnmlp_lab.cu)
LAB_C = 96  # the width the lab kernels are compiled for
EPS = 1e-6  # the lab's LayerNorm eps
_INT8_CODE = 2  # mspi_gemm_lab's dtype code for int8


def ln_mlp_lab_reference(x, g, b, w1, b1, w2, b2, variant: str, eps: float = EPS):
    """Plain version of a row-20 body: the LN (none for `matmul*`) in fp32
    with var = E[x^2] - mu^2 (`mxu_stats`: both means as products with a
    1/C column, as `_k_mxu_stats` takes them), z rounded to x's dtype, u =
    z W1^T + b1 in fp32, the GELU (none for `matmul` and `ln_matmul`), h
    rounded to x's dtype, y = h W2^T + b2 in fp32, one cast."""
    if variant not in LAB_VARIANTS:
        raise ValueError(f"unknown lab variant {variant!r} (have {LAB_VARIANTS})")
    dt, C = x.dtype, x.shape[-1]
    z = x
    if variant not in ("matmul", "matmul_gelu"):
        xf = x.float()
        if variant == "mxu_stats":
            col = torch.full((C, 1), 1.0 / C, device=x.device)
            mu, m2 = xf @ col, (xf * xf) @ col
        else:
            mu, m2 = xf.mean(-1, keepdim=True), (xf * xf).mean(-1, keepdim=True)
        z = ((xf - mu) * torch.rsqrt(m2 - mu * mu + eps) * g.float() + b.float()).to(dt)
    u = F.linear(z.float(), w1.float(), b1.float())
    if variant not in ("matmul", "ln_matmul"):
        u = F.gelu(u)
    return F.linear(u.to(dt).float(), w2.float(), b2.float()).to(dt)


def mlp_bf16_reference(x, w1, w2):
    """Plain version of `_mlp_bf16_kernel`: x W1^T in fp32 rounded to x's
    dtype, then W2^T in fp32, one cast; no biases, no GELU."""
    h = F.linear(x.float(), w1.float()).to(x.dtype)
    return F.linear(h.float(), w2.float()).to(x.dtype)


def quantize_weight_lab(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 lab's host quantisation (`tools/bench_int8.py::main`) of an
    nn.Linear weight [out, in]: per output channel s = max|w| / 127 (no
    floor), codes round(w / s) half to even -> (int8 codes, fp32 s)."""
    wf = w.detach().float()
    s = wf.abs().amax(1) / 127.0
    return torch.round(wf / s[:, None]).to(torch.int8), s


def _quant_rows_lab(v: torch.Tensor):
    """The int8 lab's `_quant_rows`: scale = max(amax, 1e-6) * (1/127) per
    row, codes round(v / scale) half to even (kept as exact floats)."""
    scale = v.abs().amax(-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    return torch.round(v / scale), scale


def mlp_int8w_reference(x, w1q, s1, w2q, s2):
    """Plain version of `_mlp_int8w_kernel`, in its order of operations: x
    quantised per row, exact int32 products with the W1 codes, uf =
    fp32(products) * sx * s1, uf requantised per row over the whole hidden
    width, exact products with the W2 codes, y = fp32(products) * sh * s2,
    one cast to x's dtype. No biases, no GELU."""
    q, sx = _quant_rows_lab(x.float())
    uf = _int_products(q, w1q) * sx * s1
    qh, sh = _quant_rows_lab(uf)
    return (_int_products(qh, w2q) * sh * s2).to(x.dtype)


def gemm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of `_gemm`: int8 a @ b summed exactly (float64 holds
    every partial sum) and cut to int8 by wrap-around (the low byte, as
    the TPU's astype(int8) of the int32 sum); floating a @ b in fp32 with
    one cast to a's dtype."""
    if a.dtype == torch.int8:
        s = (a.double() @ b.double()).long()
        return ((s + 128) % 256 - 128).to(torch.int8)
    return (a.float() @ b.float()).to(a.dtype)


def _check_lab_mlp(name, x, *tensors):
    kernels.check_operands(name, x, *tensors)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the lab kernel is compiled for bf16, got {x.dtype}")
    C = x.shape[-1]
    if C != LAB_C:
        raise ValueError(f"{name}: C={C}; the lab kernel is compiled for C={LAB_C}")
    if any(t.data_ptr() % 32 for t in (x, *tensors)):
        raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    return x.numel() // C


def _launch_lab(name, code, x, g, b, w1, b1, w2, b2, eps):
    H = w1.shape[0]
    if tuple(w1.shape) != (H, LAB_C) or tuple(w2.shape) != (LAB_C, H) or H % 64:
        raise ValueError(f"{name}: weights {tuple(w1.shape)}, {tuple(w2.shape)}; need "
                         f"[H, {LAB_C}] and [{LAB_C}, H] with H % 64 == 0")
    M = _check_lab_mlp(name, x, *(t for t in (g, b, w1, b1, w2, b2) if t is not None))
    y = torch.empty_like(x)
    if M:
        err = kernels.lib().mspi_ln_mlp_lab(
            x.data_ptr(), kernels.ptr(g), kernels.ptr(b), w1.data_ptr(), kernels.ptr(b1),
            w2.data_ptr(), kernels.ptr(b2), y.data_ptr(), M, LAB_C, H, float(eps), code,
            kernels.stream_handle(x))
        kernels.check(err, name)
        kernels.launches[name] += 1
    return y


def ln_mlp_lab(x, g, b, w1, b1, w2, b2, variant: str, eps: float = EPS) -> torch.Tensor:
    """Row 20: one body of the LN+MLP lab on x [..., 96] bf16 with K2's
    operands (w1 [H, 96], w2 [96, H] in nn.Linear layout); forward only."""
    if not kernels.dispatch_device(x, g, b, w1, b1, w2, b2):
        return ln_mlp_lab_reference(x, g, b, w1, b1, w2, b2, variant, eps)
    if variant not in LAB_VARIANTS:
        raise ValueError(f"unknown lab variant {variant!r} (have {LAB_VARIANTS})")
    return _launch_lab(f"lab_{variant}", LAB_VARIANTS.index(variant), x, g, b, w1, b1, w2, b2,
                       eps)


def mlp_bf16(x, w1, w2) -> torch.Tensor:
    """Row 21's `_mlp_bf16_kernel`: (x W1^T -> bf16) W2^T -> bf16 on x
    [..., 96] bf16; no biases, no GELU."""
    if not kernels.dispatch_device(x, w1, w2):
        return mlp_bf16_reference(x, w1, w2)
    return _launch_lab("mlp_bf16", _MLP_BF16_CODE, x, None, None, w1, None, w2, None, 0.0)


def mlp_int8w(x, w1q, s1, w2q, s2) -> torch.Tensor:
    """Row 21's `_mlp_int8w_kernel` on x [..., 96] bf16 with the int8 codes
    w1q [H, 96], w2q [96, H] and their fp32 per-channel scales s1 [H], s2
    [96] (`quantize_weight_lab`); the output in x's dtype."""
    if not kernels.dispatch_device(x, w1q, s1, w2q, s2):
        return mlp_int8w_reference(x, w1q, s1, w2q, s2)
    name = "mlp_int8w"
    if x.dtype != torch.bfloat16 or x.shape[-1] != LAB_C:
        raise ValueError(f"{name}: the lab kernel is compiled for bf16 [..., {LAB_C}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    H = w1q.shape[0]
    if (w1q.dtype != torch.int8 or w2q.dtype != torch.int8 or tuple(w1q.shape) != (H, LAB_C)
            or tuple(w2q.shape) != (LAB_C, H) or H % 64):
        raise ValueError(f"{name}: int8 codes [H, {LAB_C}] and [{LAB_C}, H] with H % 64 == 0 "
                         f"needed, got {w1q.dtype} {tuple(w1q.shape)}, {tuple(w2q.shape)}")
    for t, n in ((s1, H), (s2, LAB_C)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: scales must be fp32 [{n}], got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (x, w1q, s1, w2q, s2)):
        raise ValueError(f"{name}: operands must be contiguous")
    if w1q.data_ptr() % 16 or w2q.data_ptr() % 16:
        raise ValueError(f"{name}: weight codes must be 16-byte aligned")
    y = torch.empty_like(x)
    M = x.numel() // LAB_C
    if M:
        err = kernels.lib().mspi_mlp_int8_lab(x.data_ptr(), w1q.data_ptr(), s1.data_ptr(),
                                              w2q.data_ptr(), s2.data_ptr(), y.data_ptr(), M,
                                              LAB_C, H, kernels.stream_handle(x))
        kernels.check(err, name)
        kernels.launches[name] += 1
    return y


def gemm_int8_block_m(M: int, N: int, sms: int) -> int:
    """Rows of c per block of the int8 GEMM (`csrc/gemm_lab.cu`): 128 (two
    consumer warpgroups sharing each b box) unless 128 x 128 tiles would
    leave SMs idle, then 64."""
    return 64 if (M // 128) * (N // 128) < sms else 128


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row 21's `_gemm`: a [M, K] @ b [K, N], both bf16 (fp32 accumulate,
    bf16 out) or both int8 (s32 accumulate, int8 out by wrap-around).
    M and N multiples of 128; K a multiple of 32 (bf16) or 64 (int8).
    int8: the kernel reads b^T, made inside the call."""
    if not kernels.dispatch_device(a, b):
        return gemm_reference(a, b)
    name = {torch.bfloat16: "gemm_bf16", torch.int8: "gemm_int8"}.get(a.dtype)
    if name is None or b.dtype != a.dtype:
        raise TypeError(f"gemm: bf16 or int8 operands of one dtype, got {a.dtype}, {b.dtype}")
    (M, K), (K2, N) = a.shape, b.shape
    k_step = 64 if a.dtype == torch.int8 else 32
    if K2 != K or M % 128 or N % 128 or K % k_step:
        raise ValueError(f"{name}: [{M}, {K}] @ [{K2}, {N}]; the kernel takes M, N multiples "
                         f"of 128 and K a multiple of {k_step}")
    if not (a.is_contiguous() and b.is_contiguous()) or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")
    c = torch.empty((M, N), device=a.device, dtype=a.dtype)
    bt, block_m, code = None, 0, kernels.DTYPE_CODES[torch.bfloat16]
    if a.dtype == torch.int8:
        bt = torch.empty((N, K), device=a.device, dtype=torch.int8)  # b^T, K-major
        block_m, code = gemm_int8_block_m(M, N, kernels.num_sms(a)), _INT8_CODE
    err = kernels.lib().mspi_gemm_lab(a.data_ptr(), b.data_ptr(), c.data_ptr(), kernels.ptr(bt),
                                      M, N, K, code, block_m, kernels.stream_handle(a))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return c
