"""Int8 kernel lab (row 21) on the card: the raw GEMM rates in bf16 and
int8, and the two-matmul MLP with bf16 or int8 weights.

    python -m mspi_tpu_torch.tools.bench_int8 [variant ...] [--device cpu]

Counterpart of the JAX package's `tools/bench_int8.py`, at a square GEMM
[G, G] x [G, G] (MSPI_LAB_GEMM=G, default 1024) and the MLP geometry
[B, N, C], hidden H (MSPI_LAB_SHAPE=B,N,C,H, default 128,5376,96,384):

  gemm_bf16   `ops/kernels/lab.py::gemm` in bf16: wgmma fed by TMA, fp32
              accumulate, bf16 out (library: torch.matmul)
  gemm_int8   the same in int8: mma.sync s8 x s8 -> s32, int8 out by
              wrap-around, held exactly (library: torch._int_mm(a, b) cut
              to int8)
  mlp_bf16    x W1 -> bf16 -> W2 -> bf16, no bias, no GELU (K2's body)
  mlp_int8w   int8 weights with per-channel scales and per-row dynamic
              activation quantisation in the kernel, int32 accumulation,
              fp32 dequantisation between the matmuls (row 12's body),
              held to row 12's int8 tolerance
  int_mm      the library call torch._int_mm(a, b).to(int8) on the GEMM
              operands; the JAX lab's `xla_int8`

Weights are quantised on the host as the JAX lab does (s = max|w| / 127
per output channel). Env: MSPI_LAB_ITERS=50.
"""

from __future__ import annotations

import os
from typing import List

import torch

from mspi_tpu_torch import tools
from mspi_tpu_torch.ops.kernels.lab import (gemm, gemm_reference, mlp_bf16, mlp_bf16_reference,
                                            mlp_int8w, mlp_int8w_reference, quantize_weight_lab)

VARIANTS = ("gemm_bf16", "gemm_int8", "mlp_bf16", "mlp_int8w", "int_mm")
JAX_VARIANT = {**{v: v for v in VARIANTS[:4]}, "int_mm": "xla_int8"}  # the JAX lab's names


def int8_errors(out, ref):
    """Row 12's tolerance ((error, tolerance) pairs): RMS error <= 1e-3 of
    the reference's RMS and max abs error <= 0.02 x max|ref|, the plain
    version in the kernel's dtype (a code may flip on rare elements)."""
    d = out.double() - ref.double()
    rms = ref.double().pow(2).mean().sqrt().item()
    return [(d.pow(2).mean().sqrt().item(), 1e-3 * rms),
            (d.abs().max().item(), 0.02 * ref.abs().max().item())]


def main(argv=None) -> List[tools.Result]:
    args = tools.parse_args(argv, __doc__, VARIANTS)
    tools.device_line(args.device)
    B, N, C, H = (int(v) for v in os.environ.get("MSPI_LAB_SHAPE", "128,5376,96,384").split(","))
    G = int(os.environ.get("MSPI_LAB_GEMM", "1024"))
    dev = args.device
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen, device=dev)).to(torch.bfloat16)

    def randint8(*s):
        return torch.randint(-127, 128, s, generator=gen, device=dev, dtype=torch.int8)

    a_bf, b_bf = randn(G, G), randn(G, G)
    a_q, b_q = randint8(G, G), randint8(G, G)
    x, w1, w2 = randn(B, N, C), randn(H, C, scale=0.1), randn(C, H, scale=0.1)
    (w1q, s1), (w2q, s2) = quantize_weight_lab(w1), quantize_weight_lab(w2)
    print(f"# gemm {G}^3 | mlp B={B} N={N} C={C} H={H} | H100 peaks bf16 989 TFLOP/s, "
          f"int8 1979 TOP/s, HBM 3.35 TB/s", flush=True)
    gemm_ops, mlp_ops = 2.0 * G ** 3, 4.0 * B * N * C * H
    int_mm = lambda: torch._int_mm(a_q, b_q).to(torch.int8)  # noqa: E731
    cases = {  # name: (kernel fn, plain fn in fp32 or the kernel's integers, bytes, ops, peak)
        "gemm_bf16": (lambda: gemm(a_bf, b_bf), lambda: gemm_reference(a_bf.float(), b_bf.float()),
                      tools.nbytes(a_bf, b_bf, a_bf), gemm_ops, "bf16"),
        "gemm_int8": (lambda: gemm(a_q, b_q), lambda: gemm_reference(a_q, b_q),
                      tools.nbytes(a_q, b_q, a_q), gemm_ops, "int8"),
        "mlp_bf16": (lambda: mlp_bf16(x, w1, w2),
                     lambda: mlp_bf16_reference(x.float(), w1.float(), w2.float()),
                     tools.nbytes(x, w1, w2, x), mlp_ops, "bf16"),
        "mlp_int8w": (lambda: mlp_int8w(x, w1q, s1, w2q, s2),
                      lambda: mlp_int8w_reference(x, w1q, s1, w2q, s2),
                      tools.nbytes(x, w1q, s1, w2q, s2, x), mlp_ops, "int8"),
        "int_mm": (int_mm, lambda: gemm_reference(a_q, b_q), tools.nbytes(a_q, b_q, a_q),
                   gemm_ops, "int8"),
    }
    library = {"gemm_bf16": lambda: torch.matmul(a_bf, b_bf), "gemm_int8": int_mm}
    results = []
    for name in args.names:
        fn, plain, n_bytes, ops, peak = cases[name]
        out, ref = fn(), plain()
        if name == "mlp_int8w":
            errs = int8_errors(out, ref)
        elif out.dtype == torch.int8:  # exact
            errs = [((out.int() - ref.int()).abs().max().item(), 0.0)]
        else:
            errs = [((out.float() - ref).abs().max().item(), tools.bf16_tolerance(ref))]
        is_kernel = name != "int_mm"
        bound_ms, bound_by = tools.bound(n_bytes, ops, peak)
        r = tools.Result(name, name if is_kernel else None, max(e for e, _ in errs),
                         errs[-1][1] if is_kernel else None,
                         all(e <= t for e, t in errs) if is_kernel else None, bound_ms, bound_by,
                         ops, "TOP/s" if peak == "int8" else "TFLOP/s")
        del out, ref
        if dev == "cuda":
            r.ms = tools.time_ms(fn, tools.iters())
            if is_kernel:
                r.plain_ms = tools.time_ms(plain, 3, 1)
                if name in library:
                    r.library_ms = tools.time_ms(library[name], tools.iters())
        tools.report(r)
        results.append(r)
    return tools.check(results)


if __name__ == "__main__":
    main()
