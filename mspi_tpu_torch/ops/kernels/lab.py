"""The kernel labs' kernels (TPU rows 20 and 21) and their plain versions.

Counterparts of the Pallas bodies of the JAX package's kernel labs, which
`mspi_tpu_torch/tools/bench_lnmlp.py` and `bench_int8.py` time (row 19,
the 7x7 depthwise conv of `bench_dwconv.py`, is `dwconv.dwconv2d`). None of
them is on a model's path: `ln_mlp.py` stays the production module.

- `ln_mlp_lab(x, g, b, w1, b1, w2, b2, variant)`: row 20,
  `tools/bench_lnmlp.py::_call` with one of its five bodies, as K2's bf16
  `wgmma` + TMA body (`csrc/ln_mlp_sm90.cuh`) compiled in a variant
  (`csrc/lnmlp_lab.cuh`; bf16, at K2's widths but 320, `LAB_WIDTHS`, in the form
  `lab_sm90_form` mirrors, any H % 64 == 0): `matmul` (`_k_matmul`: no LN,
  no GELU), `matmul_gelu` (`_k_matmul_gelu`), `ln_matmul` (`_k_ln_matmul`:
  no GELU), `pipe2` (`_k_pipe`, k = 2: K2's own schedule at the width, up
  to C = 192 a hidden chunk's GELU in slices beside the next chunk's fc1
  products), `pipe4` (k = 4: the GELU in twice as many slices, where the
  form slices it) and `mxu_stats` (`_k_mxu_stats`: the LN row sums as
  `wgmma` products). The LN is the labs' `_ln_f32` (var = E[x^2] - mu^2);
  the GELU is K2's exact erf (the TPU bodies' degree-16 fit is within 2e-7
  of it).
- row 21, `tools/bench_int8.py`: `gemm(a, b)` (`_gemm`; `csrc/gemm_lab.cu`)
  in bf16 and int8 (the s32 sum cut to int8 by wrap-around, as the TPU's
  astype does; int8 `wgmma` reads b K-major, so the call makes b^T in a
  scratch tensor first, with 64- or 128-row tiles, `gemm_int8_block_m`);
  `mlp_bf16(x, w1, w2)` (`_mlp_bf16_kernel`: K2's body with LN, biases and
  GELU compiled out, at `LAB_WIDTHS`) and `mlp_int8w(x, w1q, s1, w2q, s2)`
  (`_mlp_int8w_kernel`: row 12's s8 `wgmma` + TMA body in its lab variant,
  LN, biases and GELU compiled out, the lab's divide-form quantisation and
  one pass 2, `csrc/mlp_int8_lab.cu`, at `INT8_LAB_WIDTHS` in the form
  `mlp_int8w_form` names, any H % 64 == 0), with the lab's host weight
  quantisation `quantize_weight_lab`.

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
from mspi_tpu_torch.ops.kernels.ln_mlp import (INT8_LAB_C, _int_products, int8_sm90_form,
                                               sm90_form)

LAB_VARIANTS = ("matmul", "matmul_gelu", "ln_matmul", "pipe2", "pipe4", "mxu_stats")
_MLP_BF16_CODE = len(LAB_VARIANTS)  # the K2-body variant code of mlp_bf16 (csrc/lnmlp_lab.cuh)
LAB_C = 96  # the labs' default width (ConvNeXt stage 0)
# row 20's bodies and mlp_bf16: K2's widths up to PR 16, a translation unit
# each (`csrc/lnmlp_lab_c<C>.cu`); K2's C = 320 (UniFormer-B) has no lab body
LAB_WIDTHS = (96, 192, 384, 512, 768)
# mlp_int8w: its own 96 and row 12's widths but 320 (row 12's C = 320 form has no lab body)
INT8_LAB_WIDTHS = (INT8_LAB_C, 256, 384, 512, 768)
LAB_HC = 64  # every lab body takes H % 64 == 0
EPS = 1e-6  # the lab's LayerNorm eps
_INT8_CODE = 2  # mspi_gemm_lab's dtype code for int8
SM90_SMEM = 232448  # a block's shared memory on the H100
SM90_STATIC = 256  # the sm90 body's static shared memory (its barriers), rounded up


def lab_sm90_form(variant: str, C: int = LAB_C) -> Tuple[int, int, int, bool, int]:
    """The launch form of a row-20 body or `mlp_bf16` at width C, as
    `csrc/ln_mlp_sm90.cuh`'s `Form<C, LN>` and the variant choose it (as
    `ln_mlp.sm90_form` mirrors K2's, whose rows, y columns and parts it
    takes): (rows per block, W1 ring slots, shared memory bytes, two u
    register sets, GELU slices). Shared memory holds the z tile (C / 64
    boxes of 64 k, the block's rows), two W2 slots [y columns, 64], 1024
    bytes of alignment, for `mxu_stats` a [8, 64] box of ones (X 1's B),
    and W1 slots [64, 64] up to 4. Up to C = 192 K2's form overlaps a
    chunk's GELU with the next chunk's fc1 in one slice a W1 box (u in two
    register sets): every body keeps that schedule, `pipe4` slices twice
    as finely (4 at C = 96, 6 at 192); above, one u and no slices. Widths
    outside `LAB_WIDTHS` are refused."""
    if variant not in LAB_VARIANTS + ("mlp_bf16",):
        raise ValueError(f"unknown lab body {variant!r} (have {LAB_VARIANTS + ('mlp_bf16',)})")
    if C not in LAB_WIDTHS:
        raise ValueError(f"C={C}: the lab bodies are compiled for C in {LAB_WIDTHS}")
    rows, cn, _, pipelined = sm90_form(C)
    kb = -(-C // 64)  # 64-k boxes of z and of a W1 chunk
    fixed = kb * rows * 128 + 2 * cn * 128 + (1024 if variant == "mxu_stats" else 0) + 1024
    slots = min(4, (SM90_SMEM - SM90_STATIC - fixed) // (64 * 128))
    slices = (2 * kb if variant == "pipe4" else kb) if pipelined else 0
    return rows, slots, fixed + slots * 64 * 128, slices > 0, slices


def mlp_int8w_form(C: int, H: int) -> Tuple[int, int, int, int, int]:
    """`mlp_int8w`'s launch form at width C and hidden width H: row 12's
    form at C (`ln_mlp.int8_sm90_form`; C = 96 its three-consumer lab form)
    on a persistent grid. H % 64 == 0: where H % 128 == 64 the last step's
    64 units take a W2 box that TMA fills with zeros past H. Other widths
    and H are refused."""
    if C not in INT8_LAB_WIDTHS:
        raise ValueError(f"C={C}: mlp_int8w is compiled for C in {INT8_LAB_WIDTHS}")
    if H <= 0 or H % LAB_HC:
        raise ValueError(f"H={H}: mlp_int8w needs H % {LAB_HC} == 0")
    return int8_sm90_form(C)


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
    if C not in LAB_WIDTHS:
        raise ValueError(f"{name}: C={C}; the lab kernel is compiled for C in {LAB_WIDTHS}")
    if any(t.data_ptr() % 32 for t in (x, *tensors)):
        raise ValueError(f"{name}: bf16 operands must be 32-byte aligned")
    return x.numel() // C


def _launch_lab(name, code, x, g, b, w1, b1, w2, b2, eps):
    H, C = w1.shape[0], x.shape[-1]
    if tuple(w1.shape) != (H, C) or tuple(w2.shape) != (C, H) or H % LAB_HC:
        raise ValueError(f"{name}: weights {tuple(w1.shape)}, {tuple(w2.shape)}; need "
                         f"[H, {C}] and [{C}, H] with H % {LAB_HC} == 0")
    M = _check_lab_mlp(name, x, *(t for t in (g, b, w1, b1, w2, b2) if t is not None))
    y = torch.empty_like(x)
    if M:
        err = kernels.lib().mspi_ln_mlp_lab(
            x.data_ptr(), kernels.ptr(g), kernels.ptr(b), w1.data_ptr(), kernels.ptr(b1),
            w2.data_ptr(), kernels.ptr(b2), y.data_ptr(), M, C, H, float(eps), code,
            kernels.stream_handle(x))
        kernels.check(err, name)
        kernels.launches[name] += 1
    return y


def ln_mlp_lab(x, g, b, w1, b1, w2, b2, variant: str, eps: float = EPS) -> torch.Tensor:
    """Row 20: one body of the LN+MLP lab on x [..., C] bf16 (C in
    LAB_WIDTHS) with K2's operands (w1 [H, C], w2 [C, H] in nn.Linear
    layout); forward only."""
    if not kernels.dispatch_device(x, g, b, w1, b1, w2, b2):
        return ln_mlp_lab_reference(x, g, b, w1, b1, w2, b2, variant, eps)
    if variant not in LAB_VARIANTS:
        raise ValueError(f"unknown lab variant {variant!r} (have {LAB_VARIANTS})")
    return _launch_lab(f"lab_{variant}", LAB_VARIANTS.index(variant), x, g, b, w1, b1, w2, b2,
                       eps)


def mlp_bf16(x, w1, w2) -> torch.Tensor:
    """Row 21's `_mlp_bf16_kernel`: (x W1^T -> bf16) W2^T -> bf16 on x
    [..., C] bf16 (C in LAB_WIDTHS); no biases, no GELU."""
    if not kernels.dispatch_device(x, w1, w2):
        return mlp_bf16_reference(x, w1, w2)
    return _launch_lab("mlp_bf16", _MLP_BF16_CODE, x, None, None, w1, None, w2, None, 0.0)


def mlp_int8w(x, w1q, s1, w2q, s2) -> torch.Tensor:
    """Row 21's `_mlp_int8w_kernel` on x [..., C] bf16 (C in
    INT8_LAB_WIDTHS) with the int8 codes w1q [H, C], w2q [C, H] (H % 64 ==
    0) and their fp32 per-channel scales s1 [H], s2 [C]
    (`quantize_weight_lab`); the output in x's dtype."""
    if not kernels.dispatch_device(x, w1q, s1, w2q, s2):
        return mlp_int8w_reference(x, w1q, s1, w2q, s2)
    name = "mlp_int8w"
    C, H = x.shape[-1], w1q.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the lab kernel is compiled for bf16, got {x.dtype}")
    try:
        mlp_int8w_form(C, H)
    except ValueError as err:
        raise ValueError(f"{name}: {err}") from None
    if (w1q.dtype != torch.int8 or w2q.dtype != torch.int8 or tuple(w1q.shape) != (H, C)
            or tuple(w2q.shape) != (C, H)):
        raise ValueError(f"{name}: int8 codes [H, {C}] and [{C}, H] needed, got {w1q.dtype} "
                         f"{tuple(w1q.shape)}, {tuple(w2q.shape)}")
    for t, n in ((s1, H), (s2, C)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: scales must be fp32 [{n}], got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (x, w1q, s1, w2q, s2)):
        raise ValueError(f"{name}: operands must be contiguous")
    if w1q.data_ptr() % 16 or w2q.data_ptr() % 16:
        raise ValueError(f"{name}: weight codes must be 16-byte aligned")
    if any(t.data_ptr() % 8 for t in (x, s1, s2)):
        raise ValueError(f"{name}: x and the scales must be 8-byte aligned")
    y = torch.empty_like(x)
    M = x.numel() // C
    if M:
        err = kernels.lib().mspi_mlp_int8_lab(x.data_ptr(), w1q.data_ptr(), s1.data_ptr(),
                                              w2q.data_ptr(), s2.data_ptr(), y.data_ptr(), M,
                                              C, H, kernels.stream_handle(x))
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
