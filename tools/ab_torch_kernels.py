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
  `torch._int_mm` cut to int8 (as the lab times it);
- row 7's K4 part, the SyncBlock backward (`self_attention_backward`, from
  the forward's out and lse) at batch 2, beside SDPA forward + backward;
- K2 (`ln_mlp`) at `chip_smoke.LN_MLP_SHAPES` at batch 8, summed per
  MViTv2-S forward and per VideoSwin-S forward (`ln_mlp:swin`), each shape
  weighted by its blocks, and K3's call site (`ln_mlp_prior`) at
  `PRIOR_SHAPES` (16 frames per clip), summed per forward, and row 10
  (`ln_mlp_prior_res`) there too; beside each the unfused chain
  `F.layer_norm` -> `F.linear` -> `F.gelu` -> `F.linear` (row 10: then
  `torch.addcmul` with the shortcut) as a yardstick (no one PyTorch call
  computes the function), and each shape's share of the bf16 peak by
  device time; with `ln_mlp`, row 13 (`fused_mlp`) at K2's shapes, summed
  once each;
- row 9, the K2 backward (`ln_mlp_backward`), at `chip_smoke.LN_MLP_SHAPES`
  at batch 2, summed per MViTv2-S training step and per VideoSwin-S step
  (`ln_mlp_bwd:swin`), each shape weighted by its blocks, beside the unfused
  chain `F.layer_norm` -> `F.linear` -> `F.gelu` -> `F.linear`, forward +
  autograd backward (a yardstick: no one PyTorch call computes the
  function), with each shape's share of the bf16 peak (10 M C H flops) and
  the device time of each of its kernels at one shape per width;
- row 7 head-major (`attention_backward`, row 6's backward on the augmented
  lanes, from the forward's out and lse), MViTv2-S's 16 blocks at batch 2,
  summed per relk0 training step, beside SDPA forward + backward (scale 1),
  with the device time of each pass at blocks 0 and 4-13;
- row 6 (`attention`, the forward on the augmented lanes,
  `attention_aug`), MViTv2-S's 16 blocks at batch 8, summed per forward,
  beside SDPA (scale 1) on the same operands, with device times and the
  device time of each kernel at blocks 0 and 4-13; `attention_aug_wide`:
  the same at the wide widths, the three blocks of 256x448 (Da 148,
  `chip_smoke.MVIT_WIDE`) and of 288x640 (Da 162, `chip_smoke.MVIT_R66`)
  at batch 2, summed once each (a tree without the wide form refuses
  them: printed, not summed); `attention_bwd_aug_wide`: row 7 head-major
  at those six shapes, batch 2;
- row 12 (`ln_mlp_int8`, bf16 x) at `chip_smoke.INT8_SHAPES` at batch 8,
  summed per MViTv2-S serving forward and per VideoSwin-S int8 forward
  (`ln_mlp_int8:swin`), each shape weighted by its blocks, with device
  times and each shape's share of the int8 peak (4 M C H operations at
  1979 TOP/s); and its flips: the outputs more than 1e-3 x RMS off the
  plain version on the same inputs (a flipped int8 code; what
  `chip_smoke.int8_errors` counts), in fp32 and bf16, into the JSON line
  (`int8_flips`) for the trees to be compared;
- `bwd_seeds` (no timing): the bf16 window backward (rows 16-17) at the
  eight VideoSwin-S variants over 32 draws of its inputs (seeds 1000-1031,
  `chip_smoke.window_inputs` at batch 2), each gradient's error over its
  bf16 tolerance (3 x 2^-8 of its max|ref|, `chip_smoke.tolerance`) against
  (a) the plain fp32 version, (b) this checkout's
  `window_attention_backward_rounded_reference` (the TPU kernel's
  roundings, delta = rowsum(P dP)) and (c) the same with delta =
  rowsum(dO O) from the forward's bf16 O; (b) and (c) against (a) too; and
  over the same draws the bf16 K1 backward (row 5, MViTv2-S's 7 block
  shapes) and K4's (the SyncBlock shape) against their plain versions;
- `lab_lnmlp`: the eight LN+MLP lab bodies (row 20's six, `lab.ln_mlp_lab`;
  row 21's `mlp_bf16` and `mlp_int8w`) at the labs' default shape
  (`tools.bench_lnmlp.shape()`, [128 x 5376, 96], H 384, bf16, the labs'
  scales and seed) beside K2 (`prod`) and the unfused chain on the same
  operands, by events and device time; each output's SHA-256 into the JSON
  line (`digests`), and `mlp_int8w`'s flips against its plain version (as
  `ln_mlp_int8`'s are counted, `int8_flips`);
- `mlp_digests` (no timing): the SHA-256 of the bf16 outputs of K2 at
  `chip_smoke.LN_MLP_SHAPES` and of row 13 there, of K3 and row 10 at
  `PRIOR_SHAPES` (batch 2, one clip of 16 frames), and of row 12 at
  `INT8_SHAPES` (batch 2, fp32 and bf16 x), into `digests`: two trees'
  lines show whether the production bodies are bit-identical;
- `aug_digests` (no timing): the same for row 6's output and row 7
  head-major's three gradients in bf16 at `chip_smoke.MVIT_BLOCKS` (Da 123
  and 142) and every `AUG_CHECKS` shape up to Da 256 (the compile-time
  forms: 148, 162, 109, 114, 180, 184, 256), batch 2;
- `form_digests` (no timing): the same for K4's output and its backward's
  gradients (row 7's K4 part) at the SyncBlock shape (D = 128) and at C =
  384 (D = 96), and row 9's seven gradients at `LN_MLP_SHAPES`, batch 2,
  bf16;
- `aug_pairs`: rows 6 and 7 head-major in bf16 at Da 256 (the widest
  compile-time form), 320 and 400 (the wide form) on one geometry, batch 2,
  2 heads, Nq 4096 and Nk 8064-11520 (`AUG_PAIRS`), by device time, each as
  ps per (query, key) pair beside SDPA (forward, or forward + backward);
  a tree without the wide form refuses Da 320 and 400 (printed);
- `self_attention_uni`: K4 and its backward (row 7's K4 part) in bf16 at
  UniFormer-B's two shapes (`chip_smoke.UNI_SELF_SHAPES`, head dim 64),
  forward at batch 8 and backward at batch 2, each summed per UniFormer-B
  forward or step (weighted by its blocks) beside SDPA (forward, or forward
  + backward), by events and device time;
- `ptxas` (no timing): every kernel's registers as the tree's build
  reported them (`-Xptxas=-v`), into the JSON line (`ptxas`), so that two
  trees' lines show which kernels' register counts moved;
- `layernorm_tokens`: row 11 at `chip_smoke.LN_SHAPES` (the ConvNeXt
  prior's stem and downsample LayerNorms of a serving forward, batch 8 x 16
  frames), summed per forward, beside `F.layer_norm` on the same operands,
  by events and device time, with the sum's share of its bound (each input
  read once and the output written once at 3.35 TB/s);
- `gelu_floor` (no timing): the issue floor of the bf16 LN+MLP body's
  GELU from SASS. Two probe kernels are compiled with nvcc for sm_90a into
  DIR/build/gelu_floor/, each thread taking 32 fp32 values as the body
  holds one 64-unit chunk of u and adding b1; the `gelu` probe applies the
  tree's `ln_mlp.cuh` `gelu_erf` (the exact erff) before packing pairs to
  bf16 as the body repacks h, the `plain` probe packs u + b1 as it is.
  `cuobjdump -sass` lists both; their difference over 32 is what one
  hidden element's GELU costs a thread. An SM issues one warp instruction
  per clock on each of its four sub-partitions (128 thread instructions a
  clock), so the floor at a shape is M H x that cost over 132 SMs x 128 x
  the card's top SM clock (`nvidia-smi`'s clocks.max.sm), printed beside
  the tensor-core bound 16 M C^2 / 989 TFLOP/s at the K2 and K3 shapes
  and summed per MViTv2-S forward, each shape weighted by its blocks.

For K4 and its backward, the GEMMs, rows 5, 18 and 19, K2, K3 and their
library calls (or chains) it also
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
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

CHECKOUT = Path(__file__).resolve().parents[1]
SECTIONS = ("attention_rel_packed", "window_attention_bwd", "self_attention", "gemm_bf16",
            "attention_rel_bwd", "attention_rel_bwd_r66", "dwconv2d", "dwconv3d", "gemm_int8",
            "self_attention_bwd", "ln_mlp", "ln_mlp_prior", "gelu_floor", "ln_mlp_bwd",
            "attention_bwd_aug", "bwd_seeds", "attention_aug", "attention_aug_wide",
            "attention_bwd_aug_wide", "ln_mlp_int8", "lab_lnmlp", "mlp_digests",
            "layernorm_tokens", "aug_digests", "form_digests", "ptxas", "aug_pairs",
            "self_attention_uni")
SEEDS = 32  # bwd_seeds: input draws per shape
# aug_pairs: label, Nq, key grid (R = kt + kh + kw, Da = 96 + R); 2 heads, batch 2
AUG_PAIRS = (("Da 256", 4096, (4, 16, 140)), ("Da 320", 4096, (2, 30, 192)),
             ("Da 400", 4096, (2, 14, 288)))
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core peak, FLOP/s
SMS, ISSUE_LANES = 132, 128  # H100 SXM: SMs, thread instructions issued per SM per clock
GELU_PROBE = r"""
#include "ln_mlp.cuh"
namespace mspi {
__global__ void probe_%(name)s(const float* __restrict__ u, const float* __restrict__ b1,
                               uint32_t* __restrict__ h) {
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = u[threadIdx.x + 128 * i] + b1[i & 15];
  uint32_t o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = pack_bf16(%(f)s(v[2 * i]), %(f)s(v[2 * i + 1]));
#pragma unroll
  for (int i = 0; i < 16; ++i) h[threadIdx.x + 128 * i] = o[i];
}
}  // namespace mspi
"""


def _cuda_tool(name: str) -> str:
    import shutil

    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise SystemExit(f"ab_torch_kernels: {name} not found (gelu_floor needs the CUDA toolkit)")
    return path


def sass_count(root: Path, name: str, fn: str) -> int:
    """Instructions in the SASS of the GELU probe `name` applying `fn` (NOP
    padding and the EXIT/BRA tail excluded)."""
    import re

    out = root / "build" / "gelu_floor"
    out.mkdir(parents=True, exist_ok=True)
    src, cubin = out / f"{name}.cu", out / f"{name}.cubin"
    src.write_text(GELU_PROBE % {"name": name, "f": fn})
    subprocess.run([_cuda_tool("nvcc"), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(root / "mspi_tpu_torch" / "csrc"),
                    "-o", str(cubin), str(src)], check=True)
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass)
    return sum(op.split(".")[0] not in ("NOP", "EXIT", "BRA") for op in ops)


def gelu_floor(cs, root: Path) -> dict:
    """The `gelu_floor` section: the GELU's SASS cost per hidden element and
    its floor beside the tensor-core bound at the K2 and K3 shapes."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    gelu, plain = sass_count(root, "gelu", "gelu_erf"), sass_count(root, "plain", "")
    per_elem = (gelu - plain) / 32
    rate = SMS * ISSUE_LANES * mhz * 1e6  # thread instructions per second
    print(f"gelu_floor: max SM clock {mhz:g} MHz; probe SASS gelu {gelu}, plain {plain} "
          f"instructions -> {per_elem:.2f} per hidden element", flush=True)
    shapes = [(label, cs.BATCH * tokens, C, blocks)
              for label, tokens, C, _, blocks, _ in cs.LN_MLP_SHAPES]
    shapes += [(label, cs.BATCH * 16 * tokens, C, blocks)
               for label, tokens, C, blocks in cs.PRIOR_SHAPES]
    sums = {"gelu_ms": 0.0, "tensor_ms": 0.0}
    for label, M, C, blocks in shapes:
        gelu_us = M * 4 * C * per_elem / rate * 1e6
        tensor_us = 16.0 * M * C * C / PEAK_BF16 * 1e6
        sums["gelu_ms"] += blocks * gelu_us / 1e3
        sums["tensor_ms"] += blocks * tensor_us / 1e3
        print(f"gelu_floor {label} [{M}, {C}] x{blocks}: GELU floor {gelu_us:.2f} us, tensor "
              f"bound {tensor_us:.2f} us ({gelu_us / tensor_us:.2f}x)", flush=True)
    return {"instructions_per_element": per_elem, "per_mvit_forward": sums}


def bwd_seeds(cs, PA, WA, root: Path) -> dict:
    """The `bwd_seeds` section: the largest error over tolerance of each
    bf16 backward gradient over SEEDS draws of its inputs, per shape and
    reference (see the module docstring)."""
    spec = importlib.util.spec_from_file_location(
        "checkout_window_attention",
        CHECKOUT / "mspi_tpu_torch" / "ops" / "kernels" / "window_attention.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)  # the rounded reference of this checkout, any tree's kernel
    B, worst = cs.TRAIN_BATCH, {}

    def note(key, names, got, want):
        for name, g, w in zip(names, got, want):
            w = w.float()
            r = (g.float() - w).abs().max().item() / cs.tolerance(torch.bfloat16, w, floor=0.0)
            worst[f"{key}:{name}"] = max(worst.get(f"{key}:{name}", 0.0), r)

    for seed in range(1000, 1000 + SEEDS):
        randn = cs.randn_on(torch.Generator().manual_seed(seed))
        for label, _, nw, heads, C, grid, shift in cs.SWIN_SHAPES:
            inputs = [t.bfloat16() for t in cs.window_inputs(randn, B, nw, heads, C, grid, shift)]
            qkv, bias = inputs[:2]
            mask = inputs[2] if grid is not None else None
            n = nw if grid is not None else 1
            dout = randn(B * nw, cs.SWIN_N, C).bfloat16()
            out, lse = WA._window_attention_fwd(qkv, bias, mask, heads, n, with_lse=True)
            got = WA.window_attention_backward(qkv, bias, mask, out, lse, heads, n, dout)
            f32 = [None if t is None else t.float() for t in (qkv, bias, mask)]
            a = WA.window_attention_backward_reference(*f32, heads, n, dout.float())
            b = ref.window_attention_backward_rounded_reference(qkv, bias, mask, heads, n, dout)
            c = ref.window_attention_backward_rounded_reference(qkv, bias, mask, heads, n, dout,
                                                                out)

            def parts(grads):
                dqkv, dbias = grads
                return dqkv[..., :C], dqkv[..., C:2 * C], dqkv[..., 2 * C:], dbias
            names = ("dq", "dk", "dv", "dbias")
            for key, g, w in (("kernel-a", got, a), ("kernel-b", got, b), ("kernel-c", got, c),
                              ("b-a", b, a), ("c-a", c, a)):
                note(f"window {label} {key}", names, parts(g), parts(w))
            del inputs, qkv, bias, mask, dout, out, lse, got, a, b, c
        for label, _, heads, nq, k_shape in cs.MVIT_BLOCKS:  # row 5
            nk, r, D = math.prod(k_shape), sum(k_shape), cs.MVIT_D
            q, k, v, rel, dout = (randn(*shape).bfloat16() for shape in (
                (B, heads, nq, D), (B, heads, nk, D), (B, heads, nk, D), (B, heads, nq, r),
                (B, heads, nq, D)))
            out, lse = PA._attention_rel_fwd(q, k, v, rel, k_shape, D ** -0.5, with_lse=True)
            got = PA.attention_rel_backward(q, k, v, rel, out, lse, k_shape, D ** -0.5, dout)
            want = PA.attention_rel_backward_reference(*(t.float() for t in (q, k, v, rel)),
                                                       k_shape, D ** -0.5, dout.float())
            note(f"rel {label} kernel-a", ("dq", "dk", "dv", "drel"), got, want)
            del q, k, v, rel, dout, out, lse, got, want
        q, kv, dout = (randn(B, 708, n).bfloat16() for n in (512, 1024, 512))  # K4
        out, lse = PA._self_attention_fwd(q, kv, 4, with_lse=True)
        got = cs.split_kv(PA.self_attention_backward(q, kv, out, lse, 4, dout), 512)
        want = cs.split_kv(PA.self_attention_backward_reference(q.float(), kv.float(), 4,
                                                                dout.float()), 512)
        note("self sync kernel-a", ("dq", "dk", "dv"), got, want)
        del q, kv, dout, out, lse, got, want
    for key, r in sorted(worst.items()):
        print(f"bwd_seeds {key}: worst err/tol {r:.3f} over {SEEDS} seeds", flush=True)
    return worst


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

    def breakdown(fn, calls):
        """Device us per call of fn() by kernel name, largest first: the
        profile with the largest total of three, as `device_us` takes it."""
        fn()
        torch.cuda.synchronize()
        best = []
        for _ in range(3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / calls) for e in prof.key_averages()
                    if e.self_device_time_total > 0]
            if sum(us for _, us in rows) > sum(us for _, us in best):
                best = rows
        return sorted(best, key=lambda r: -r[1])

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
    randn, B = cs.randn_on(torch.Generator().manual_seed(11)), cs.TRAIN_BATCH
    if "self_attention_bwd" in only:  # row 7's K4 part: N 708, C 512, 4 heads
        q, kv, dout = (randn(B, 708, n).bfloat16() for n in (512, 1024, 512))
        out, lse = PA._self_attention_fwd(q, kv, 4, with_lse=True)
        qh, kh, vh, doh = (cs.heads_major(t, 4) for t in (q, kv[..., :512], kv[..., 512:], dout))
        fn = lambda: PA.self_attention_backward(q, kv, out, lse, 4, dout)  # noqa: E731
        lib = cs.library_grad(cs.sdpa, (qh, kh, vh), doh)
        summed("self_attention_bwd", f"b{B}", 1, fn, lib, 4 * args.reps)
        for tag, f in (("kernel", fn), ("library", lib)):
            print(f"self_attention_bwd {tag} by kernel: " + "; ".join(
                f"{name[:60]} {us:.2f} us" for name, us in breakdown(f, 4 * args.reps)[:6]),
                flush=True)
        del q, kv, dout, out, lse, qh, kh, vh, doh

    import torch.nn.functional as F
    from mspi_tpu_torch.ops.kernels import ln_mlp as K2

    def chain(x, g, b, w1, b1, w2, b2, eps):
        C = x.shape[-1]
        return lambda: F.linear(F.gelu(F.linear(F.layer_norm(x, (C,), g, b, eps), w1, b1)),
                                w2, b2)

    def mlp_section(name, kernel, shapes):
        """K2, K3 or row 10 at each (label, rows, C, eps, weights) into the
        sums of each weight's key, beside the unfused chain (row 10's with
        the folded residual)."""
        randn = cs.randn_on(torch.Generator().manual_seed(1))
        for label, M, C, eps, weights in shapes:
            xs = [t.bfloat16() for t in cs.mlp_inputs(randn, M, C)]
            with torch.no_grad():
                fn, lib = (lambda: kernel(*xs, eps)), chain(*xs, eps)
                if name == "ln_mlp_prior_res":  # shortcut + gamma * mlp(LN(x))
                    sc, gm = randn(M, C).bfloat16(), (0.2 + randn(C, scale=0.05)).bfloat16()
                    fn = lambda: kernel(xs[0], sc, gm, *xs[1:], eps)  # noqa: E731
                    lib = (lambda f: lambda: torch.addcmul(sc, gm, f()))(chain(*xs, eps))
                ms, lib_ms = time_ms(fn), time_ms(lib)
                us, lib_us = device_us(fn, 2 * args.reps), device_us(lib, 2 * args.reps)
            for key, weight in weights.items():
                for k, v in ((key, ms), (key + ":chain", lib_ms)):
                    sums[k] = sums.get(k, 0.0) + weight * v
                for k, v in ((key, us), (key + ":chain", lib_us)):
                    device[k] = device.get(k, 0.0) + weight * v
            flops = 16.0 * M * C * C
            print(f"{name} {label} [{M}, {C}] x{weights}: {ms:.4f} ms (device {us:.2f} us, "
                  f"{flops / (us * 1e-6) / PEAK_BF16:.1%} of the bf16 peak); chain "
                  f"{lib_ms:.4f} ms (device {lib_us:.2f} us)", flush=True)
            del xs

    if "ln_mlp" in only:
        mlp_section("ln_mlp", K2.ln_mlp,
                    [(label, cs.BATCH * tokens, C, eps, {"ln_mlp": mvit, "ln_mlp:swin": swin})
                     for label, tokens, C, eps, mvit, swin in cs.LN_MLP_SHAPES])
    if "ln_mlp_prior" in only:
        for name in ("ln_mlp_prior", "ln_mlp_prior_res"):  # K3 and row 10
            mlp_section(name, getattr(K2, name),
                        [(label, cs.BATCH * 16 * tokens, C, 1e-6, {name: blocks})
                         for label, tokens, C, blocks in cs.PRIOR_SHAPES])
    if "ln_mlp" in only:  # row 13, the MLP without its LayerNorm, at K2's shapes
        randn = cs.randn_on(torch.Generator().manual_seed(41))
        for label, tokens, C, *_ in cs.LN_MLP_SHAPES:
            x, _, _, w1, b1, w2, b2 = (t.bfloat16() for t in cs.mlp_inputs(
                randn, cs.BATCH * tokens, C))
            with torch.no_grad():
                fn = lambda: K2.fused_mlp(x, w1, b1, w2, b2)  # noqa: E731
                ms, us = time_ms(fn), device_us(fn, 2 * args.reps)
            sums["mlp"] = sums.get("mlp", 0.0) + ms
            device["mlp"] = device.get("mlp", 0.0) + us
            print(f"mlp {label}: {ms:.4f} ms (device {us:.2f} us)", flush=True)
            del x, w1, b1, w2, b2
    if "ln_mlp_bwd" in only:
        randn = cs.randn_on(torch.Generator().manual_seed(11))
        for label, tokens, C, eps, mvit, swin in cs.LN_MLP_SHAPES:
            M = cs.TRAIN_BATCH * tokens
            xs = [t.bfloat16() for t in cs.mlp_inputs(randn, M, C) + [randn(M, C)]]
            fn = lambda: K2.ln_mlp_backward(*xs[:7], eps, xs[7])  # noqa: E731
            chain_fn = cs.library_grad(
                lambda x, g, b, w1, b1, w2, b2: F.linear(F.gelu(F.linear(
                    F.layer_norm(x, (C,), g, b, eps), w1, b1)), w2, b2), xs[:7], xs[7])
            ms, lib_ms = time_ms(fn), time_ms(chain_fn)
            us, lib_us = device_us(fn, 2 * args.reps), device_us(chain_fn, 2 * args.reps)
            for key, weight in (("ln_mlp_bwd", mvit), ("ln_mlp_bwd:swin", swin)):
                for k, v in ((key, ms), (key + ":chain", lib_ms)):
                    sums[k] = sums.get(k, 0.0) + weight * v
                for k, v in ((key, us), (key + ":chain", lib_us)):
                    device[k] = device.get(k, 0.0) + weight * v
            flops = 10.0 * M * C * 4 * C
            print(f"ln_mlp_bwd {label} [{M}, {C}] x{mvit} (Swin x{swin}): {ms:.4f} ms (device "
                  f"{us:.2f} us, {flops / (us * 1e-6) / PEAK_BF16:.1%} of the bf16 peak); chain "
                  f"{lib_ms:.4f} ms (device {lib_us:.2f} us)", flush=True)
            if label in ("mvit-s1", "mvit-s2", "mvit-s3", "mvit-s4", "sync"):
                print(f"ln_mlp_bwd {label} by kernel: " + "; ".join(
                    f"{name[:60]} {k_us:.2f} us" for name, k_us in breakdown(fn, 2 * args.reps)),
                    flush=True)
            del xs
    if "attention_bwd_aug" in only:  # row 7 head-major, per relk0 step
        randn, B = cs.randn_on(torch.Generator().manual_seed(31)), cs.TRAIN_BATCH
        for label, blocks, heads, nq, k_shape in cs.MVIT_BLOCKS:
            q, k, v = (t.bfloat16() for t in cs.aug_inputs(randn, B, heads, nq, k_shape))
            dout = randn(B, heads, nq, cs.MVIT_D).bfloat16()
            out, lse = PA._attention_fwd(q, k, v, with_lse=True)
            fn = lambda: PA.attention_backward(q, k, v, out, lse, dout)  # noqa: E731
            lib = cs.library_grad(lambda *a: cs.sdpa(*a, scale=1.0), (q, k, v), dout)
            summed("attention_bwd_aug", f"{label} Da {q.shape[-1]}", blocks, fn, lib, args.reps)
            if label in ("blk0", "blk4-13"):
                print(f"attention_bwd_aug {label} by kernel: " + "; ".join(
                    f"{name[:60]} {k_us:.2f} us" for name, k_us in breakdown(fn, args.reps)),
                    flush=True)
            del q, k, v, dout, out, lse
    randn = cs.randn_on(torch.Generator().manual_seed(21))
    aug_tables = (("attention_aug", [(cs.BATCH, *shape) for shape in cs.MVIT_BLOCKS]),
                  ("attention_aug_wide", [(cs.TRAIN_BATCH, lb, 1, *rest) for lb, _, *rest in
                                          cs.MVIT_WIDE + cs.MVIT_R66]))
    for name, batch, label, blocks, heads, nq, k_shape in (
            (name, *shape) for name, table in aug_tables if name in only for shape in table):
        q, k, v = (t.bfloat16() for t in cs.aug_inputs(randn, batch, heads, nq, k_shape))
        try:
            with torch.no_grad():
                PA.attention(q, k, v)
        except (RuntimeError, ValueError) as err:  # a tree without the wide form
            print(f"{name} {label} Da {q.shape[-1]}: refused ({err})", flush=True)
            continue
        fn = lambda: PA.attention(q, k, v)  # noqa: E731
        with torch.no_grad():
            summed(name, f"{label} Da {q.shape[-1]}", blocks, fn,
                   lambda: cs.sdpa(q, k, v, scale=1.0), 4 * args.reps)
            if label in ("blk0", "blk4-13"):
                print(f"{name} {label} by kernel: " + "; ".join(
                    f"{kn[:60]} {k_us:.2f} us" for kn, k_us in breakdown(fn, args.reps)),
                    flush=True)
        del q, k, v
    if "attention_bwd_aug_wide" in only:  # row 7 head-major at the wide widths
        randn, B = cs.randn_on(torch.Generator().manual_seed(31)), cs.TRAIN_BATCH
        for label, _, heads, nq, k_shape in cs.MVIT_WIDE + cs.MVIT_R66:
            q, k, v = (t.bfloat16() for t in cs.aug_inputs(randn, B, heads, nq, k_shape))
            dout = randn(B, heads, nq, cs.MVIT_D).bfloat16()
            try:
                out, lse = PA._attention_fwd(q, k, v, with_lse=True)
                PA.attention_backward(q, k, v, out, lse, dout)
            except (RuntimeError, ValueError) as err:
                print(f"attention_bwd_aug_wide {label}: refused ({err})", flush=True)
                continue
            fn = lambda: PA.attention_backward(q, k, v, out, lse, dout)  # noqa: E731
            lib = cs.library_grad(lambda *a: cs.sdpa(*a, scale=1.0), (q, k, v), dout)
            summed("attention_bwd_aug_wide", f"{label} Da {q.shape[-1]}", 1, fn, lib, args.reps)
            del q, k, v, dout, out, lse
    if "aug_pairs" in only:  # rows 6 and 7 per (query, key) pair, Da 256 against the wide form
        randn, B, H = cs.randn_on(torch.Generator().manual_seed(33)), cs.TRAIN_BATCH, 2
        for label, nq, k_shape in AUG_PAIRS:
            q, k, v = (t.bfloat16() for t in cs.aug_inputs(randn, B, H, nq, k_shape))
            dout = randn(B, H, nq, cs.MVIT_D).bfloat16()
            pairs = B * H * nq * math.prod(k_shape)
            try:
                out, lse = PA._attention_fwd(q, k, v, with_lse=True)
            except (RuntimeError, ValueError) as err:  # a tree without the wide form
                print(f"aug_pairs {label}: refused ({err})", flush=True)
                continue
            for name, fn, lib in (
                    ("attention", lambda: PA.attention(q, k, v),
                     lambda: cs.sdpa(q, k, v, scale=1.0)),
                    ("attention_bwd", lambda: PA.attention_backward(q, k, v, out, lse, dout),
                     cs.library_grad(lambda *a: cs.sdpa(*a, scale=1.0), (q, k, v), dout))):
                with torch.set_grad_enabled(name == "attention_bwd"):  # the library's backward
                    us, lib_us = device_us(fn, 2 * args.reps), device_us(lib, 2 * args.reps)
                key = f"aug_pairs:{name}:{label}"
                device[key], device[key + ":library"] = us, lib_us
                print(f"{key} [{B}, {H}, {nq}, Nk {math.prod(k_shape)}]: device {us:.1f} us = "
                      f"{us * 1e6 / pairs:.2f} ps a pair; SDPA {lib_us:.1f} us = "
                      f"{lib_us * 1e6 / pairs:.2f} ps", flush=True)
            del q, k, v, dout, out, lse
    if "self_attention_uni" in only:  # K4 and its backward per UniFormer-B forward / step
        randn = cs.randn_on(torch.Generator().manual_seed(51))
        for label, blocks, N, C, heads in cs.UNI_SELF_SHAPES:
            q, kv = randn(cs.BATCH, N, C).bfloat16(), randn(cs.BATCH, N, 2 * C).bfloat16()
            qh, kh, vh = (cs.heads_major(t, heads) for t in (q, kv[..., :C], kv[..., C:]))
            with torch.no_grad():
                summed("self_attention_uni", label, blocks,
                       lambda: PA.self_attention(q, kv, heads), lambda: cs.sdpa(qh, kh, vh),
                       4 * args.reps)
            B = cs.TRAIN_BATCH
            q, kv, dout = (randn(B, N, c).bfloat16() for c in (C, 2 * C, C))
            out, lse = PA._self_attention_fwd(q, kv, heads, with_lse=True)
            qh, kh, vh, doh = (cs.heads_major(t, heads) for t in (q, kv[..., :C], kv[..., C:],
                                                                   dout))
            summed("self_attention_bwd_uni", label, blocks,
                   lambda: PA.self_attention_backward(q, kv, out, lse, heads, dout),
                   cs.library_grad(cs.sdpa, (qh, kh, vh), doh), 4 * args.reps)
            del q, kv, dout, out, lse, qh, kh, vh, doh
    flips = {}
    if "ln_mlp_int8" in only:  # row 12 per serving forward, and its flipped codes
        from mspi_tpu_torch.ops.kernels import ln_mlp as K2
        randn = cs.randn_on(torch.Generator().manual_seed(1))
        for label, tokens, C, mvit, swin in cs.INT8_SHAPES:
            M, H = cs.BATCH * tokens, 4 * C
            g, b, w1, b1, w2, b2 = (t.float() for t in cs.mlp_inputs(randn, 1, C)[1:])
            w1q, s1 = K2.quantize_weight(w1)
            w2q, s2 = K2.quantize_weight(w2)
            ops = (g, b, w1q, s1, b1, w2q, s2, b2)
            x32 = randn(M, C)
            with torch.no_grad():
                for x in (x32, x32.bfloat16()):
                    d = (K2.ln_mlp_int8(x, *ops, 1e-6).double()
                         - K2.ln_mlp_int8_reference(x, *ops, 1e-6).double())
                    rms = K2.ln_mlp_int8_reference(x, *ops, 1e-6).double().pow(2).mean().sqrt()
                    flips[f"{label}:{str(x.dtype)[6:]}"] = int((d.abs() > 1e-3 * rms).sum())
                x = x32.bfloat16()
                fn = lambda: K2.ln_mlp_int8(x, *ops, 1e-6)  # noqa: E731
                ms, us = time_ms(fn), device_us(fn, 4 * args.reps)
            for key, weight in (("ln_mlp_int8", mvit), ("ln_mlp_int8:swin", swin)):
                sums[key] = sums.get(key, 0.0) + weight * ms
                device[key] = device.get(key, 0.0) + weight * us
            print(f"ln_mlp_int8 {label} [{M}, {C}] x{mvit} (Swin x{swin}): {ms:.4f} ms (device "
                  f"{us:.2f} us, {4.0 * M * C * H / (us * 1e-6) / 1979e12:.1%} of the int8 "
                  f"peak); flips fp32 {flips[label + ':float32']} bf16 "
                  f"{flips[label + ':bfloat16']}", flush=True)
            if label == "s3":
                print(f"ln_mlp_int8 {label} by kernel: " + "; ".join(
                    f"{kn[:60]} {k_us:.2f} us" for kn, k_us in breakdown(fn, args.reps)),
                    flush=True)
            del x32, x
    digests = {}

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    if "lab_lnmlp" in only:  # rows 20-21's LN+MLP bodies at the labs' shape
        from mspi_tpu_torch.ops.kernels import lab
        from mspi_tpu_torch.tools import bench_lnmlp
        Bl, Nl, Cl, Hl = bench_lnmlp.shape()
        gen = torch.Generator("cuda").manual_seed(0)

        def lab_randn(*shape, scale=1.0, shift=0.0):
            return (shift + scale * torch.randn(*shape, generator=gen, device="cuda")).bfloat16()
        x = lab_randn(Bl * Nl, Cl)
        ops = (lab_randn(Cl, scale=0.1, shift=1.0), lab_randn(Cl, scale=0.1),
               lab_randn(Hl, Cl, scale=0.1), lab_randn(Hl, scale=0.1),
               lab_randn(Cl, Hl, scale=0.1), lab_randn(Cl, scale=0.1))
        (w1q, s1), (w2q, s2) = lab.quantize_weight_lab(ops[2]), lab.quantize_weight_lab(ops[4])
        bodies = {"unfused": chain(x, *ops, lab.EPS), "prod": lambda: K2.ln_mlp(x, *ops, lab.EPS),
                  **{v: (lambda v=v: lab.ln_mlp_lab(x, *ops, v)) for v in lab.LAB_VARIANTS},
                  "mlp_bf16": lambda: lab.mlp_bf16(x, ops[2], ops[4]),
                  "mlp_int8w": lambda: lab.mlp_int8w(x, w1q, s1, w2q, s2)}
        with torch.no_grad():
            for name, fn in bodies.items():
                key = f"lab_lnmlp:{name}"
                out = fn()
                digests[key] = digest(out)
                if name == "mlp_int8w":
                    ref = lab.mlp_int8w_reference(x, w1q, s1, w2q, s2).double()
                    d = out.double() - ref
                    flips[key] = int((d.abs() > 1e-3 * ref.pow(2).mean().sqrt()).sum())
                    del ref, d
                del out
                sums[key], device[key] = time_ms(fn), device_us(fn, 4 * args.reps)
                print(f"{key} [{Bl * Nl}, {Cl}] H {Hl}: {sums[key]:.4f} ms (device "
                      f"{device[key]:.2f} us)" + (f"; flips {flips[key]}" if key in flips
                                                   else ""), flush=True)
        del x, ops, w1q, w2q
    if "layernorm_tokens" in only:  # row 11 per serving forward
        import torch.nn.functional as F

        from mspi_tpu_torch.ops.kernels.layernorm import layernorm_tokens
        randn = cs.randn_on(torch.Generator().manual_seed(3))
        n_bytes = 0
        for label, tokens, C in cs.LN_SHAPES:
            M = cs.BATCH * 16 * tokens
            x = (randn(M, C) + 0.5).bfloat16()
            g, b = (1 + randn(C, scale=0.1)).bfloat16(), randn(C, scale=0.1).bfloat16()
            n_bytes += cs.nbytes(x, g, b, x)
            with torch.no_grad():
                summed("layernorm_tokens", f"{label} [{M}, {C}]", 1,
                       lambda: layernorm_tokens(x, g, b, 1e-6),
                       lambda: F.layer_norm(x, (C,), g, b, 1e-6), 4 * args.reps)
            del x
        bound_us = n_bytes / cs.HBM_BYTES_PER_S * 1e6
        print(f"layernorm_tokens per serving forward: device {device['layernorm_tokens']:.2f} us "
              f"against a bound of {bound_us:.2f} us ({bound_us / device['layernorm_tokens']:.1%}"
              f"); F.layer_norm {device['layernorm_tokens:library']:.2f} us", flush=True)
    if "aug_digests" in only:  # rows 6 and 7 at the compile-time forms' widths, bit for bit
        randn, B = cs.randn_on(torch.Generator().manual_seed(41)), cs.TRAIN_BATCH
        for label, _, heads, nq, k_shape in cs.MVIT_BLOCKS + tuple(
                shape for shape in cs.AUG_CHECKS if cs.MVIT_D + sum(shape[4]) <= 256):
            q, k, v = (t.bfloat16() for t in cs.aug_inputs(randn, B, heads, nq, k_shape))
            dout = randn(B, heads, nq, cs.MVIT_D).bfloat16()
            out, lse = PA._attention_fwd(q, k, v, with_lse=True)
            key = f"{label} Da {q.shape[-1]}"
            digests[f"attention:{key}"] = digest(out)
            for name, grad in zip(("dq", "dk", "dv"),
                                  PA.attention_backward(q, k, v, out, lse, dout)):
                digests[f"attention_bwd:{key}:{name}"] = digest(grad)
            del q, k, v, dout, out, lse
        print(f"aug_digests: {len(digests)} outputs hashed", flush=True)
    if "mlp_digests" in only:  # K2, row 13, K3, row 10 and row 12 outputs, bit for bit
        randn = cs.randn_on(torch.Generator().manual_seed(1))
        with torch.no_grad():
            for label, tokens, C, eps, *_ in cs.LN_MLP_SHAPES:
                xs = [t.bfloat16() for t in cs.mlp_inputs(randn, cs.TRAIN_BATCH * tokens, C)]
                digests[f"ln_mlp:{label}"] = digest(K2.ln_mlp(*xs, eps))
                digests[f"mlp:{label}"] = digest(K2.fused_mlp(xs[0], *xs[3:]))
            for label, tokens, C, _ in cs.PRIOR_SHAPES:
                xs = [t.bfloat16() for t in cs.mlp_inputs(randn, 16 * tokens, C)]
                sc, gm = randn(16 * tokens, C).bfloat16(), (0.2 + randn(C, scale=0.05)).bfloat16()
                digests[f"ln_mlp_prior:{label}"] = digest(K2.ln_mlp_prior(*xs, 1e-6))
                digests[f"ln_mlp_prior_res:{label}"] = digest(
                    K2.ln_mlp_prior_res(xs[0], sc, gm, *xs[1:], 1e-6))
            for label, tokens, C, *_ in cs.INT8_SHAPES:
                g, b, w1, b1, w2, b2 = (t.float() for t in cs.mlp_inputs(randn, 1, C)[1:])
                (w1q, s1), (w2q, s2) = K2.quantize_weight(w1), K2.quantize_weight(w2)
                x32 = randn(cs.TRAIN_BATCH * tokens, C)
                for x in (x32, x32.bfloat16()):
                    digests[f"ln_mlp_int8:{label}:{str(x.dtype)[6:]}"] = digest(
                        K2.ln_mlp_int8(x, g, b, w1q, s1, b1, w2q, s2, b2, 1e-6))
        print(f"mlp_digests: {len(digests)} outputs hashed", flush=True)
    if "form_digests" in only:  # K4 and its backward at D 128 and 96, row 9, bit for bit
        randn, B = cs.randn_on(torch.Generator().manual_seed(43)), cs.TRAIN_BATCH
        for label, C in (("sync", 512), ("sync-d96", 384)):
            q, kv, dout = (randn(B, 708, c).bfloat16() for c in (C, 2 * C, C))
            out, lse = PA._self_attention_fwd(q, kv, 4, with_lse=True)
            digests[f"self_attention:{label}"] = digest(out)
            for name, grad in zip(("dq", "dkv"),
                                  PA.self_attention_backward(q, kv, out, lse, 4, dout)):
                digests[f"attention_bwd:{label}:{name}"] = digest(grad)
            del q, kv, dout, out, lse
        for label, tokens, C, eps, *_ in cs.LN_MLP_SHAPES:
            M = B * tokens
            xs = [t.bfloat16() for t in cs.mlp_inputs(randn, M, C) + [randn(M, C)]]
            for name, grad in zip(("dx", "dg", "db", "dw1", "db1", "dw2", "db2"),
                                  K2.ln_mlp_backward(*xs[:7], eps, xs[7])):
                digests[f"ln_mlp_bwd:{label}:{name}"] = digest(grad)
            del xs
        print(f"form_digests: {len(digests)} outputs hashed", flush=True)
    seeds = bwd_seeds(cs, PA, WA, root) if "bwd_seeds" in only else None
    floor = gelu_floor(cs, root) if "gelu_floor" in only else None
    line = {"tree": str(root), "device": smi, "per_forward_or_step_ms": sums,
            "device_us_per_call": device,
            "launches": {k: v for k, v in kernels.launches.items() if v}}
    if floor is not None:
        line["gelu_floor"] = floor
    if "ptxas" in only:
        line["ptxas"] = {entry: regs for entry, (regs, _, _) in kernels.ptxas_report("").items()}
    if flips:
        line["int8_flips"] = flips
    if digests:
        line["digests"] = digests
    if seeds is not None:
        line["bwd_seeds"] = seeds
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
    sys.exit(0)
