"""Times eight kernels of the PyTorch/CUDA port in bf16 (int8 for the int8
GEMM) at the models' (or the labs') shapes, from the `mspi_tpu_torch`
package of a given tree, so that two trees can be compared in turns on one
GPU.

    python tools/ab_torch_kernels.py [--root DIR] [--reps 5] [--only NAME,...]

Imports `mspi_tpu_torch` from DIR (default: this checkout; its kernels are
built into DIR/build on first use) and the shape tables and timing helper
from this checkout's `chip_smoke.py`, then times with CUDA events (median
of `--reps` single calls, after warm-up, as `chip_smoke.py` times):

- row 8 `attention_rel_packed` with the residual, MViTv2-S blocks 1-15 at
  batch 8, summed per forward (each shape weighted by its blocks);
- row 16, the window backward (`window_attention_backward`, from the
  forward's out and lse), VideoSwin-S's eight (stage, shifted) variants at
  batch 2, summed per training step;
- K4 `self_attention`, the SyncBlock shape (N 708, C 512, 4 heads) at
  batch 8 and 2, beside SDPA on the same operands;
- row 21's bf16 GEMM (`lab.gemm`) at 1024^3, the lab's shape, and at
  4096^3, beside `torch.matmul`;
- row 5, the K1 backward (`attention_rel_backward`, from the forward's out
  and lse), MViTv2-S's 16 blocks at batch 2, summed per training step
  (each shape weighted by its blocks), beside SDPA with rel E^T as its
  float mask, forward + backward; `attention_rel_bwd_r66`: the same at the
  three blocks of 288x640 whose rel width is 66 (`chip_smoke.MVIT_R66`,
  summed once each; trees before the wide form refuse R > 64);
- row 19 (`dwconv.dwconv2d`) at the lab's four ConvNeXt stages
  (`tools.bench_dwconv.STAGES`), summed, beside grouped `F.conv2d`;
- row 18 (`dwconv.dwconv3d`) at MViTv2-S's 17 stride-1 pools
  (`chip_smoke.DWCONV_SHAPES`) at batch 8, summed per forward, and its dx
  (the kernel on dy with the flipped taps) at batch 2, summed per training
  step, each beside grouped `F.conv3d` on the NCDHW-contiguous operand;
- row 21's int8 GEMM (`lab.gemm` on int8) at 1024^3 and 4096^3, beside
  `torch._int_mm` cut to int8 (as the lab times it).

For K4, the GEMMs, rows 5, 18 and 19 and their library calls it also
prints the device time per call: torch.profiler's CUDA kernel time over
`--reps` x 4 calls, divided by the calls (rows 5, 18 and 19: summed like
the CUDA-event times). A single call's CUDA-event time includes the host's
launch path between its events; the device time does not. `--only` times a
subset: names from `SECTIONS`.

Prints the card's name and power limit, one line per shape, and one JSON
line of the sums. Run it for each tree in turns (parent, change, change,
parent) inside one call; the kernels are held against their plain versions
by `chip_smoke.py`, not here.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

CHECKOUT = Path(__file__).resolve().parents[1]
SECTIONS = ("attention_rel_packed", "window_attention_bwd", "self_attention", "gemm_bf16",
            "attention_rel_bwd", "attention_rel_bwd_r66", "dwconv2d", "dwconv3d", "gemm_int8")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHECKOUT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(CHECKOUT),
                        help="tree whose mspi_tpu_torch package is timed")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--only", default=",".join(SECTIONS),
                        help=f"comma-separated subset of {SECTIONS}")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if only - set(SECTIONS):
        parser.error(f"unknown sections {sorted(only - set(SECTIONS))}; have {SECTIONS}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_kernels: needs an NVIDIA GPU")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.ops.kernels import pooled_attention as PA
    from mspi_tpu_torch.ops.kernels import window_attention as WA

    if Path(kernels.__file__).resolve().parents[3] != root:
        raise SystemExit(f"mspi_tpu_torch imported from {kernels.__file__}, not {root}")
    cs = _smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; tree {root}", flush=True)
    kernels.lib()
    time_ms = lambda fn: cs.time_ms(fn, warmup=2, reps=args.reps)  # noqa: E731
    sums = {}

    randn = cs.randn_on(torch.Generator().manual_seed(21))
    scale = cs.MVIT_D ** -0.5
    for label, blocks, heads, nq, k_shape in (
            cs.MVIT_BLOCKS[1:] if "attention_rel_packed" in only else ()):
        q, k, v, rel = (t.bfloat16() for t in cs.packed_inputs(randn, cs.BATCH, heads, nq,
                                                                 k_shape))
        with torch.no_grad():
            ms = time_ms(lambda: PA.attention_rel_packed(q, k, v, rel, k_shape, heads, scale,
                                                         True))
        sums["attention_rel_packed"] = sums.get("attention_rel_packed", 0.0) + blocks * ms
        print(f"attention_rel_packed {label} x{blocks}: {ms:.4f} ms", flush=True)
        del q, k, v, rel

    randn = cs.randn_on(torch.Generator().manual_seed(11))
    B = cs.TRAIN_BATCH
    for label, blocks, nw, heads, C, grid, shift in (
            cs.SWIN_SHAPES if "window_attention_bwd" in only else ()):
        inputs = [t.bfloat16() for t in cs.window_inputs(randn, B, nw, heads, C, grid, shift)]
        qkv, bias = inputs[:2]
        mask = inputs[2] if grid is not None else None
        n = nw if grid is not None else 1
        dout = randn(B * nw, cs.SWIN_N, C).bfloat16()
        out, lse = WA._window_attention_fwd(qkv, bias, mask, heads, n, with_lse=True)
        ms = time_ms(lambda: WA.window_attention_backward(qkv, bias, mask, out, lse, heads, n,
                                                          dout))
        sums["window_attention_bwd"] = sums.get("window_attention_bwd", 0.0) + blocks * ms
        print(f"window_attention_bwd {label} x{blocks}: {ms:.4f} ms", flush=True)
        del inputs, qkv, bias, mask, dout, out, lse

    def device_us(fn, calls):
        """CUDA kernel time per call of fn(), in microseconds: the largest of
        three profiles (a profile now and then reports no kernels)."""
        fn()
        torch.cuda.synchronize()
        totals = []
        for _ in range(3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            totals.append(sum(e.self_device_time_total for e in prof.key_averages()))
        return max(totals) / calls

    device = {}

    def timed(name, fn, library):
        with torch.no_grad():
            sums[name] = time_ms(fn)
            sums[name + ":library"] = time_ms(library)
            device[name] = device_us(fn, 4 * args.reps)
            device[name + ":library"] = device_us(library, 4 * args.reps)
        print(f"{name}: {sums[name]:.4f} ms (device {device[name]:.2f} us); library "
              f"{sums[name + ':library']:.4f} ms (device {device[name + ':library']:.2f} us)",
              flush=True)

    for B in (cs.BATCH, cs.TRAIN_BATCH) if "self_attention" in only else ():
        q, kv = randn(B, 708, 512).bfloat16(), randn(B, 708, 1024).bfloat16()
        qh, kh, vh = (cs.heads_major(t, 4) for t in (q, kv[..., :512], kv[..., 512:]))
        timed(f"self_attention:b{B}", lambda: PA.self_attention(q, kv, 4),
              lambda: cs.sdpa(qh, kh, vh))
        del q, kv, qh, kh, vh

    from mspi_tpu_torch.ops.kernels.lab import gemm
    for G in (1024, 4096) if "gemm_bf16" in only else ():
        a, b = randn(G, G).bfloat16(), randn(G, G).bfloat16()
        timed(f"gemm_bf16:{G}", lambda: gemm(a, b), lambda: torch.matmul(a, b))
        del a, b

    def summed(name, label, weight, fn, library, calls):
        """fn and library at one shape into the weighted sums of both times."""
        ms, lib_ms = time_ms(fn), time_ms(library)
        us, lib_us = device_us(fn, calls), device_us(library, calls)
        for key, value in ((name, ms), (name + ":library", lib_ms)):
            sums[key] = sums.get(key, 0.0) + weight * value
        for key, value in ((name, us), (name + ":library", lib_us)):
            device[key] = device.get(key, 0.0) + weight * value
        print(f"{name} {label} x{weight}: {ms:.4f} ms (device {us:.2f} us); library "
              f"{lib_ms:.4f} ms (device {lib_us:.2f} us)", flush=True)

    randn, B = cs.randn_on(torch.Generator().manual_seed(11)), cs.TRAIN_BATCH
    rel_tables = (("attention_rel_bwd", cs.MVIT_BLOCKS),
                  ("attention_rel_bwd_r66", [(lb, 1, *rest) for lb, _, *rest in cs.MVIT_R66]))
    for name, label, blocks, heads, nq, k_shape in (
            (name, *shape) for name, table in rel_tables if name in only for shape in table):
        nk, r = math.prod(k_shape), sum(k_shape)
        q, dout = (randn(B, heads, nq, cs.MVIT_D).bfloat16() for _ in range(2))
        k, v = (randn(B, heads, nk, cs.MVIT_D).bfloat16() for _ in range(2))
        rel = randn(B, heads, nq, r).bfloat16()
        out, lse = PA._attention_rel_fwd(q, k, v, rel, k_shape, scale, with_lse=True)
        mask = cs.rel_mask(rel, k_shape)
        summed(name, label, blocks,
               lambda: PA.attention_rel_backward(q, k, v, rel, out, lse, k_shape, scale, dout),
               cs.library_grad(lambda *a: cs.sdpa(*a, scale), (q, k, v, mask), dout), args.reps)
        del q, k, v, rel, dout, out, lse, mask

    from mspi_tpu_torch.ops.kernels.dwconv import dwconv2d
    from mspi_tpu_torch.tools.bench_dwconv import STAGES, conv2d_library
    for label, (N, H, W, C) in STAGES.items() if "dwconv2d" in only else ():
        x = randn(N, H, W, C).bfloat16()
        k, b = randn(7, 7, C, scale=0.1).bfloat16(), randn(C, scale=0.1).bfloat16()
        with torch.no_grad():
            summed("dwconv2d", label, 1, lambda: dwconv2d(x, k, b),
                   lambda: conv2d_library(x, k, b), 4 * args.reps)
        del x, k, b

    from mspi_tpu_torch.ops.kernels import dwconv as DW

    # row 18 per head as the pools run it: forwards at batch 8, dx at batch 2
    for batch, tag in ((cs.BATCH, "dwconv3d"), (cs.TRAIN_BATCH, "dwconv3d_dx")):
        for label, pools, heads, thw in cs.DWCONV_SHAPES if "dwconv3d" in only else ():
            x = randn(batch * heads, *thw, cs.MVIT_D).bfloat16()
            w = randn(cs.MVIT_D, 1, 3, 3, 3, scale=0.2).bfloat16()
            if tag == "dwconv3d_dx":  # dy with the flipped taps, as the backward runs it
                w = w.flip(2, 3, 4).contiguous()
            with torch.no_grad():
                summed(tag, label, pools, lambda: DW._dwconv3d_fwd(x, w),
                       cs.conv3d_library(x, w), 4 * args.reps)
            del x, w

    gen8 = torch.Generator().manual_seed(5)

    def randint8(*shape):
        return torch.randint(-127, 128, shape, generator=gen8, dtype=torch.int8).cuda()
    for G in (1024, 4096) if "gemm_int8" in only else ():
        a, b = randint8(G, G), randint8(G, G)
        timed(f"gemm_int8:{G}", lambda: gemm(a, b),
              lambda: torch._int_mm(a, b).to(torch.int8))
        del a, b
    line = {"tree": str(root), "device": smi, "per_forward_or_step_ms": sums,
            "device_us_per_call": device,
            "launches": {k: v for k, v in kernels.launches.items() if v}}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
    sys.exit(0)
