"""Kernel lab for the ConvNeXt 7x7 depthwise conv (row 19) on the card.

    python -m mspi_tpu_torch.tools.bench_dwconv [stage ...] [--batch N] [--device cpu]

Counterpart of the JAX package's `tools/bench_dwconv.py`: per stage shape
[B, H, W, C] of the flagship ConvNeXt-T prior (s0-s3; 7x7, stride 1, pad
3, bf16, plus a bias), two variants:

  dwconv2d  row 19, the hand-written kernel (`ops/kernels/dwconv.py::dwconv2d`,
            `csrc/dwconv2d.cu`); the JAX lab's `pallas`
  conv2d    the library call F.conv2d(groups=C) on the channels-last tensor
            (cuDNN); the JAX lab's `xla`

Both are held against the plain version (`dwconv2d_reference`, the TPU
kernel's 49 shifted multiply-adds) in fp32; only the kernel is held to the
bf16 tolerance. `--batch` replaces the stages' batch of 128.
Env: MSPI_LAB_ITERS=50 (timed repeats).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from mspi_tpu_torch import tools
from mspi_tpu_torch.ops.kernels.dwconv import dwconv2d, dwconv2d_reference

# flagship ConvNeXt-T stage shapes at 224x384, batch 8 x 16 frames
STAGES = {
    "s0": (128, 56, 96, 96),
    "s1": (128, 28, 48, 192),
    "s2": (128, 14, 24, 384),
    "s3": (128, 7, 12, 768),
}
K = 7
VARIANTS = ("conv2d", "dwconv2d")
JAX_VARIANT = {"conv2d": "xla", "dwconv2d": "pallas"}  # the JAX lab's name of each


def conv2d_library(x, k, b):
    """The library call: F.conv2d with groups=C on x [B,H,W,C] seen as a
    channels-last NCHW tensor; the result seen as [B,H,W,C] again."""
    w = k.permute(2, 0, 1).unsqueeze(1)  # [C, 1, 7, 7]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=K // 2, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def run_stage(name: str, batch: int, device: str) -> List[tools.Result]:
    B, H, W, C = STAGES[name]
    B = batch or B
    gen = torch.Generator(device).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    x, k, b = randn(B, H, W, C), randn(K, K, C, scale=0.1), randn(C, scale=0.1)
    flops = 2.0 * K * K * B * H * W * C
    bound_ms, bound_by = tools.bound(tools.nbytes(x, k, b, x), flops, "fp32")
    print(f"# {name}: [{B},{H},{W},{C}] {flops / 1e9:.2f} GFLOP | bound {bound_ms:.3f} ms "
          f"({bound_by})", flush=True)
    ref = dwconv2d_reference(x.float(), k.float(), b.float())
    fns = {"dwconv2d": lambda: dwconv2d(x, k, b), "conv2d": lambda: conv2d_library(x, k, b)}
    results = []
    with torch.no_grad():
        for variant in VARIANTS:
            err = (fns[variant]().float() - ref).abs().max().item()
            is_kernel = variant == "dwconv2d"
            tol = tools.bf16_tolerance(ref) if is_kernel else None
            r = tools.Result(f"{variant}:{name}", "dwconv2d" if is_kernel else None, err, tol,
                             err <= tol if is_kernel else None, bound_ms, bound_by, flops,
                             "TFLOP/s")
            if device == "cuda":
                r.ms = tools.time_ms(fns[variant], tools.iters())
                if is_kernel:
                    r.plain_ms = tools.time_ms(lambda: dwconv2d_reference(x, k, b), 3, 1)
                    r.library_ms = tools.time_ms(fns["conv2d"], tools.iters())
            tools.report(r)
            results.append(r)
    return results


def main(argv=None) -> List[tools.Result]:
    def extra(p):
        p.add_argument("--batch", type=int, default=0, help="batch (default: the stage's 128)")
    args = tools.parse_args(argv, __doc__, list(STAGES), "stage", extra)
    tools.device_line(args.device)
    results = []
    for name in args.names:
        results += run_stage(name, args.batch, args.device)
    return tools.check(results)


if __name__ == "__main__":
    main()
