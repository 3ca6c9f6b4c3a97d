"""Kernel lab for the fused LN+MLP (K2 and row 20) on the card: where does
K2's time go?

    python -m mspi_tpu_torch.tools.bench_lnmlp [variant ...] [--device cpu]

Counterpart of the JAX package's `tools/bench_lnmlp.py`, on its geometry
[B, N, C] with hidden width H (MSPI_LAB_SHAPE=B,N,C,H, default the
ConvNeXt stage-0 shape 128,5376,96,384; bf16 storage, fp32 accumulation,
eps 1e-6). Decomposition ladder, the kernel variants being K2's bf16
wgmma + TMA body compiled without parts of it
(`ops/kernels/lab.py::ln_mlp_lab`):

  unfused      the library chain F.layer_norm -> F.linear -> F.gelu ->
               F.linear, each a launch of its own; the JAX lab's `xla`
  prod         the production kernel K2 (`ln_mlp`)
  matmul       the two matmuls with biases only (no LN, no GELU): the
               tensor-core floor
  matmul_gelu  the two matmuls and the erf GELU (no LN)
  ln_matmul    the LN and the two matmuls (no GELU)
  pipe2        the full LN+MLP (the labs' one-pass LN) on K2's own
               schedule: a hidden chunk's GELU in 2 slices, one beside each
               W1 box of the next chunk's fc1 products, so that tensor
               cores and FP32 pipes overlap; beside `prod`, the price of
               the one-pass LN
  pipe4        the same with the GELU in 4 slices beside 4 commit groups
  mxu_stats    the full LN+MLP with the LN row sums taken on the tensor
               cores (X 1 and the diagonal of X X^T)

Every variant is held against the plain version of the TPU body it
stands for, in fp32 on the same bf16 inputs (`unfused` and `prod` against
the full LN+MLP, without a tolerance gate). Env: MSPI_LAB_ITERS=50.
"""

from __future__ import annotations

import os
from typing import List

import torch
import torch.nn.functional as F

from mspi_tpu_torch import tools
from mspi_tpu_torch.ops.kernels.lab import EPS, LAB_VARIANTS, ln_mlp_lab, ln_mlp_lab_reference
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp

VARIANTS = ("unfused", "prod") + LAB_VARIANTS
JAX_VARIANT = {"unfused": "xla", **{v: v for v in VARIANTS[1:]}}  # the JAX lab's names


def shape():
    return tuple(int(v) for v in os.environ.get("MSPI_LAB_SHAPE", "128,5376,96,384").split(","))


def main(argv=None) -> List[tools.Result]:
    args = tools.parse_args(argv, __doc__, VARIANTS)
    tools.device_line(args.device)
    B, N, C, H = shape()
    dev = args.device
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*s, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*s, generator=gen, device=dev)).to(torch.bfloat16)

    x = randn(B, N, C)
    ops = (randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1), randn(H, C, scale=0.1),
           randn(H, scale=0.1), randn(C, H, scale=0.1), randn(C, scale=0.1))
    flops = 4.0 * B * N * C * H
    bound_ms, bound_by = tools.bound(tools.nbytes(x, *ops, x), flops, "bf16")
    print(f"# shape B={B} N={N} C={C} H={H} | bound {bound_ms:.3f} ms ({bound_by}); "
          f"H100 peaks bf16 989 TFLOP/s, HBM 3.35 TB/s", flush=True)
    g, be, w1, b1, w2, b2 = ops
    fns = {"unfused": lambda: F.linear(F.gelu(F.linear(F.layer_norm(x, (C,), g, be, EPS), w1,
                                                       b1)), w2, b2),
           "prod": lambda: ln_mlp(x, *ops, EPS)}
    for v in LAB_VARIANTS:
        fns[v] = lambda v=v: ln_mlp_lab(x, *ops, v)
    xf, opsf = x.float(), tuple(t.float() for t in ops)
    results = []
    with torch.no_grad():
        for name in args.names:
            ref = ln_mlp_lab_reference(xf, *opsf, "pipe2" if name in ("unfused", "prod") else name)
            err = (fns[name]().float() - ref).abs().max().item()
            is_lab = name in LAB_VARIANTS
            tol = tools.bf16_tolerance(ref) if is_lab else None
            r = tools.Result(name, f"lab_{name}" if is_lab else None, err, tol,
                             err <= tol if is_lab else None, bound_ms, bound_by, flops, "TFLOP/s")
            del ref
            if dev == "cuda":
                r.ms = tools.time_ms(fns[name], tools.iters())
                if is_lab:
                    r.plain_ms = tools.time_ms(
                        lambda n=name: ln_mlp_lab_reference(x, *ops, n), 3, 1)
            tools.report(r)
            results.append(r)
    return tools.check(results)


if __name__ == "__main__":
    main()
