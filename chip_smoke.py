"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,backward,...]

Runs the port's phases in order, one line each, and exits non-zero on the
first failure (there is no CPU path):

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: compiles every kernel in mspi_tpu_torch/csrc with nvcc (sm_90a),
   one process per source;
3. kernels: each forward kernel against its plain PyTorch version at the
   inference shapes (batch 8) of the MViTv2-S and VideoSwin-S models, in
   fp32 and bf16, with CUDA-event times of both and of the library call
   that computes the same function; K4 also at the training shape (batch
   2) with the row log-sum-exp that its backward reads;
4. main path: `predict_video` of the bf16 MViTv2-S AudioVisualSaliencyModel
   at 224x384 (seeded random weights) on 31 synthetic frames and a 16 kHz
   waveform; checks the maps and each kernel's launch count;
5. parity: one window in fp32 on the card (kernels) against the CPU (plain
   versions), by the correlation of the log-density maps;
6. backward: each backward kernel against its plain version at the
   training shapes (batch 2) of both models, fp32 and bf16, with times;
   the bf16 K1 backward (row 5) and window backward (row 16) run twice at
   each of their shapes and must give bit-identical gradients; row 5 also
   at the rel widths of 256x448 (R = 52) and 288x640 (R = 66, its wide
   form), checked and timed beside SDPA, out of the sums;
7. training path: `make_train_step` on the MViTv2-S model at 224x384,
   batch 2, bf16 compute with fp32 weights, STEPS steps on synthetic
   batches; checks finite loss and gradient norm, trainable weights moved,
   frozen weights and statistics bit-identical, and the launch counts;
8. training parity: one fp32 step on the card against the same step on the
   CPU (plain versions) from the same weights, batch and drop-path draws:
   loss, each aux value and the cosine of the gradient vectors;
9-12. swin_main, swin_parity, swin_training, swin_train_parity: phases 4,
   5, 7 and 8 on the VideoSwin-S model;
13. int8_main: phase 4 on the MViTv2-S model with the serving options
   (quant="int8", prior_fold_res, prior_ln_t), whose path runs the int8
   LN+MLP, residual-folded prior MLP and LayerNorm kernels; the int8 and
   float bf16 forwards timed in turns, and how many int8 codes the bf16
   model's weights change against the fp32 weights';
14. int8_parity: that model in fp32 on the card against the CPU's plain
   versions (CC), and against the card's float model (the cost of int8);
15. swin_int8_main: phase 4 on the VideoSwin-S model with quant="int8";
16. layout_kernels: the kernels of MViT's layout options against their
   plain versions, fp32 and bf16, at batch 8: the augmented-lane attention
   (row 6) at the 16 blocks' shapes, the packed rel-pos attention (row 8,
   with the residual) at blocks 1-15 and at the rel width 52 of 256x448
   (checked only), the depthwise conv3d (row 18) at the 17 stride-1 pools
   (and, checked only, on the packed layout and at ragged shapes, each
   bf16 tile, a part channel group and C off the 8-channel vector); times
   summed per forward (each shape weighted by its blocks);
17. layout_backward: at batch 2, row 7's head-major backward of row 6 at
   the 16 blocks, row 8's backward (K1's after a layout change, its bf16
   run twice, bit-identical) at blocks 1-15 and at R = 52 and 66, and row
   18's dx beside grouped `F.conv3d` on the flipped taps;
18. layout_main: phase 4 on MViTv2-S with attn_packed and dwconv (row 8 in
   blocks 1-15, K1 in block 0, row 18 in the 17 stride-1 pools), timed in
   turns against the default model;
19. layout_parity: that model in fp32, card against the CPU (CC) and
   against the card's default model;
20. relk0_training, relk0_train_parity: phases 7 and 8 on MViTv2-S with
   attn_relk=False and dwconv (rows 6, 7 and 18 with its dx);
21. mlp_kernels: the fused MLP without LayerNorm (row 13) against its plain
   version at K2's six shapes (batch 8), its backward (row 14) at batch 2,
   fp32 and bf16; then its path: one `maybe_fused_mlp` forward and
   backward through the port's MViT `Mlp` (C 96), exactly one launch of
   each;
22. lab: the three kernel labs (`mspi_tpu_torch.tools.bench_dwconv`,
   `bench_lnmlp`, `bench_int8`) in this process at their default shapes:
   rows 19, 20 (five bodies) and 21 (GEMM in bf16 and int8, the bf16 and
   int8 MLP bodies), each held against its plain version and timed beside
   its library call; the labs' launches are this phase's path. Before
   them the bf16 GEMM is held against its plain version at two non-square
   shapes (one with K % 64 == 32, a half last k tile), the int8 GEMM
   exactly at three with K % 128 == 64 (a half last box), in both tile
   heights, and at 4096^3, and row 19 in fp32 and bf16 at four ragged shapes
   (H and W off both its tile widths; C = 40, a part channel group, and C
   = 1, off the 16-byte vector).

Each path (4, 7, 9, 11, 13, 15, 18, 20, 21, 22) sets the launch counts to 0
just before it and reads them just after; the kernels' record sums them.
The last two lines are the kernels' JSON record and the device JSON record.
`--phases` runs a subset (2 always runs; the records then cover only what
ran and no device record is printed).
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "attention_rel": ("mspi_tpu_torch/csrc/attention_rel.cu",
                      "mspi_tpu/ops/pallas/pooled_attention.py:622"),
    "ln_mlp": ("mspi_tpu_torch/csrc/ln_mlp.cu", "mspi_tpu/ops/pallas/mlp.py:495"),
    "ln_mlp_prior": ("mspi_tpu_torch/csrc/ln_mlp.cu", "mspi_tpu/ops/pallas/mlp.py:751"),
    "self_attention": ("mspi_tpu_torch/csrc/self_attention.cu",
                       "mspi_tpu/ops/pallas/pooled_attention.py:761"),
    # bf16 (timed); fp32 runs attention_bwd.cu's FMA passes
    "attention_rel_bwd": ("mspi_tpu_torch/csrc/attention_rel_bwd_sm90.cu",
                          "mspi_tpu/ops/pallas/pooled_attention.py:385"),
    "attention_bwd": ("mspi_tpu_torch/csrc/attention_bwd.cu",
                      "mspi_tpu/ops/pallas/pooled_attention.py:172"),
    "ln_mlp_bwd": ("mspi_tpu_torch/csrc/ln_mlp_bwd.cu", "mspi_tpu/ops/pallas/mlp.py:445"),
    "window_attention": ("mspi_tpu_torch/csrc/window_attention.cu",
                         "mspi_tpu/ops/pallas/attention.py:423"),
    # rows 16 (:233, stages 1-2) and 17 (:332, stages 3-4): one kernel here
    # (bf16; fp32 runs attention_bwd.cu's FMA passes)
    "window_attention_bwd": ("mspi_tpu_torch/csrc/window_attention_bwd.cu",
                             "mspi_tpu/ops/pallas/attention.py:233"),
    "ln_mlp_int8": ("mspi_tpu_torch/csrc/ln_mlp_int8.cu", "mspi_tpu/ops/pallas/mlp.py:985"),
    "ln_mlp_prior_res": ("mspi_tpu_torch/csrc/ln_mlp.cu", "mspi_tpu/ops/pallas/mlp.py:778"),
    "layernorm_tokens": ("mspi_tpu_torch/csrc/layernorm.cu", "mspi_tpu/ops/pallas/mlp.py:880"),
    "attention": ("mspi_tpu_torch/csrc/attention.cu",
                  "mspi_tpu/ops/pallas/pooled_attention.py:782"),
    "attention_rel_packed": ("mspi_tpu_torch/csrc/attention_rel.cu",
                             "mspi_tpu/ops/pallas/pooled_attention.py:593"),
    "dwconv3d": ("mspi_tpu_torch/csrc/dwconv.cu", "mspi_tpu/ops/pallas/dwconv.py:160"),
    "mlp": ("mspi_tpu_torch/csrc/ln_mlp.cu", "mspi_tpu/ops/pallas/mlp.py:280"),
    "mlp_bwd": ("mspi_tpu_torch/csrc/ln_mlp_bwd.cu", "mspi_tpu/ops/pallas/mlp.py:232"),
    "dwconv2d": ("mspi_tpu_torch/csrc/dwconv2d.cu", "tools/bench_dwconv.py:81"),
    # row 20: tools/bench_lnmlp.py::_call (:61) with each of its bodies
    "lab_matmul": ("mspi_tpu_torch/csrc/lnmlp_lab.cu", "tools/bench_lnmlp.py:78"),
    "lab_matmul_gelu": ("mspi_tpu_torch/csrc/lnmlp_lab.cu", "tools/bench_lnmlp.py:86"),
    "lab_ln_matmul": ("mspi_tpu_torch/csrc/lnmlp_lab.cu", "tools/bench_lnmlp.py:96"),
    "lab_pipe2": ("mspi_tpu_torch/csrc/lnmlp_lab.cu", "tools/bench_lnmlp.py:107"),
    "lab_pipe4": ("mspi_tpu_torch/csrc/lnmlp_lab.cu", "tools/bench_lnmlp.py:107"),
    "lab_mxu_stats": ("mspi_tpu_torch/csrc/lnmlp_lab.cu", "tools/bench_lnmlp.py:134"),
    # row 21: tools/bench_int8.py::_gemm and _mlp_call (:98) with its two bodies
    "gemm_bf16": ("mspi_tpu_torch/csrc/gemm_lab.cu", "tools/bench_int8.py:53"),
    "gemm_int8": ("mspi_tpu_torch/csrc/gemm_lab.cu", "tools/bench_int8.py:53"),
    "mlp_bf16": ("mspi_tpu_torch/csrc/lnmlp_lab.cu", "tools/bench_int8.py:67"),
    "mlp_int8w": ("mspi_tpu_torch/csrc/ln_mlp_int8.cu", "tools/bench_int8.py:83"),
}
LAB_KERNELS = ("dwconv2d", "lab_matmul", "lab_matmul_gelu", "lab_ln_matmul", "lab_pipe2",
               "lab_pipe4", "lab_mxu_stats", "gemm_bf16", "gemm_int8", "mlp_bf16", "mlp_int8w")
SERVING = {"quant": "int8", "prior_fold_res": True, "prior_ln_t": True}
LAYOUT = {"attn_packed": True, "dwconv": True}
RELK0 = {"attn_relk": False, "dwconv": True}
# launches per forward of each model (ln_mlp: backbone blocks + 3 SyncBlock
# + 4 decoder blocks; ln_mlp_prior: the ConvNeXt prior's 18 blocks). With
# quant="int8" the blocks with C >= 256 (MViT 3-15, Swin stages 3-4, the 3
# SyncBlock blocks) run ln_mlp_int8; prior_fold_res moves the prior's 18
# blocks to ln_mlp_prior_res, prior_ln_t its stem + 3 downsample norms to
# layernorm_tokens.
PER_FORWARD = {
    "mvitv2s": {"attention_rel": 16, "ln_mlp": 23, "ln_mlp_prior": 18, "self_attention": 3},
    "videoswins": {"window_attention": 24, "ln_mlp": 31, "ln_mlp_prior": 18,
                   "self_attention": 3},
    "mvitv2s+serving": {"attention_rel": 16, "ln_mlp": 7, "ln_mlp_int8": 16,
                        "ln_mlp_prior_res": 18, "layernorm_tokens": 4, "self_attention": 3},
    "videoswins+int8": {"window_attention": 24, "ln_mlp": 8, "ln_mlp_int8": 23,
                        "ln_mlp_prior": 18, "self_attention": 3},
    # attn_packed: blocks 1-15 (more than one head) run row 8, block 0 K1;
    # dwconv: the 17 stride-1 pools (pool_q of the 13 blocks without a q
    # stride, pool_k / pool_v of blocks 14-15) run row 18
    "mvitv2s+layout": {"attention_rel_packed": 15, "attention_rel": 1, "dwconv3d": 17,
                       "ln_mlp": 23, "ln_mlp_prior": 18, "self_attention": 3},
    # attn_relk=False: every block runs row 6
    "mvitv2s+relk0": {"attention": 16, "dwconv3d": 17, "ln_mlp": 23, "ln_mlp_prior": 18,
                      "self_attention": 3},
}
# launches per training step
PER_STEP = {
    "mvitv2s": {**PER_FORWARD["mvitv2s"], "attention_rel_bwd": 16, "ln_mlp_bwd": 23,
                "attention_bwd": 3},
    "videoswins": {**PER_FORWARD["videoswins"], "window_attention_bwd": 24, "ln_mlp_bwd": 31,
                   "attention_bwd": 3},
    # row 7 head-major for the 16 blocks + K4's 3; row 18's dx per pool
    "mvitv2s+relk0": {**PER_FORWARD["mvitv2s+relk0"], "attention_bwd": 16 + 3,
                      "dwconv3d": 17 + 17, "ln_mlp_bwd": 23},
}
PATH_PHASES = {  # phase -> (path kind, PER_FORWARD key: the encoder and its options)
    "main": ("main", "mvitv2s"), "parity": ("parity", "mvitv2s"),
    "training": ("training", "mvitv2s"), "train_parity": ("train_parity", "mvitv2s"),
    "swin_main": ("main", "videoswins"), "swin_parity": ("parity", "videoswins"),
    "swin_training": ("training", "videoswins"),
    "swin_train_parity": ("train_parity", "videoswins"),
    "int8_main": ("main", "mvitv2s+serving"),
    "int8_parity": ("options_parity", "mvitv2s+serving"),
    "swin_int8_main": ("main", "videoswins+int8"),
    "layout_main": ("main", "mvitv2s+layout"),
    "layout_parity": ("options_parity", "mvitv2s+layout"),
    "relk0_training": ("training", "mvitv2s+relk0"),
    "relk0_train_parity": ("train_parity", "mvitv2s+relk0"),
}
OPTIONS = {"mvitv2s+serving": SERVING, "videoswins+int8": {"quant": "int8"},
           "mvitv2s+layout": LAYOUT, "mvitv2s+relk0": RELK0}
PHASES = ("kernels", "main", "parity", "backward", "training", "train_parity", "swin_main",
          "swin_parity", "swin_training", "swin_train_parity", "int8_main", "int8_parity",
          "swin_int8_main", "layout_kernels", "layout_backward", "layout_main",
          "layout_parity", "relk0_training", "relk0_train_parity", "mlp_kernels", "lab")
BATCH = 8
TRAIN_BATCH = 2
STEPS = 5
RES = (224, 384)
SPECTRO = (257, 111)
N_FRAMES, FPS, SAMPLE_RATE = 31, 30.0, 16000
# published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12  # int8 tensor cores
HBM_BYTES_PER_S = 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tolerance(dtype: torch.dtype, ref: torch.Tensor, floor: float = 1.0) -> float:
    """fp32: 1e-4 relative to the output scale (only the summation order
    differs). bf16: three bf16 steps (2^-8 each) relative to the output
    scale -- inputs, the rounded intermediates and the output are bf16,
    the reference is fp32 on the same bf16-rounded inputs. The scale is
    max|ref|, at least `floor`."""
    scale = max(floor, ref.abs().max().item())
    return (1e-4 if dtype == torch.float32 else 3 * 2.0 ** -8) * scale


def new_record() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": None, "library_ms": None, "_bytes_ms": 0.0, "_ops_ms": 0.0}


def add_bound(rec, dtype, n_bytes: float, flops: float, peak: float = None,
              weight: float = 1.0) -> None:
    """The least time of the work on the card: the larger of its bytes (each
    input read once, each output written once) over HBM's rate and its
    operations over the peak of their type (by default the dtype's matrix
    peak). Recorded for the bf16 runs, whose times the record sums, with
    the shape's weight."""
    if dtype != torch.bfloat16 or not weight:
        return
    t_bytes = weight * n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = weight * flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    rec["bound_ms"] += max(t_bytes, t_ops)
    rec["_bytes_ms"] += t_bytes
    rec["_ops_ms"] += t_ops
    rec["bound_by"] = "bytes" if rec["_bytes_ms"] > rec["_ops_ms"] else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(records, name, label, dtype, errs_tols, ms, plain_ms, library_ms=None,
           weight: float = 1.0):
    """Log one check and fold it into the kernel's record: the error always,
    the bf16 times times `weight` (the shape's launches per forward or
    step; 0 for a check whose times stay out of the sums)."""
    err = max(e for e, _ in errs_tols)
    ok = all(math.isfinite(e) and e <= t for e, t in errs_tols)
    # each output against its own tolerance (0: exact)
    worst = max(e / t if t else (0.0 if e == 0 else math.inf) for e, t in errs_tols)
    lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
    times = "" if weight == 1 else f" (x{weight:g} in the sums)"
    log("kernels", f"{name} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                   f"(worst err/tol {worst:.3f}) "
                   f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms{lib}{times} "
                   f"{'ok' if ok else 'FAIL'}")
    rec = records[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if dtype == torch.bfloat16 and weight:
        rec["ms"] += weight * ms
        rec["plain_ms"] += weight * plain_ms
        if library_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + weight * library_ms
    if not ok:
        raise AssertionError(f"{name} {label} {dtype}: error {err} above tolerance")


def check_kernel(records, name, label, kernel_fn, plain_fn, inputs, dtype, library_fn=None,
                 compare=None, weight: float = 1.0):
    """Run one forward kernel at one shape against its plain version; record
    the error and the times. By default the plain version runs in fp32 on
    the same dtype-rounded inputs, held to `tolerance`; `compare(out, xs)`
    replaces that with its own (error, tolerance) pairs."""
    xs = [t.to(dtype) if t.is_floating_point() else t for t in inputs]
    out = kernel_fn(*xs)
    torch.cuda.synchronize()
    if compare is None:
        ref = plain_fn(*(t.float() if t.is_floating_point() else t for t in xs))
        errs = [((out.float() - ref).abs().max().item(), tolerance(dtype, ref))]
    else:
        errs = compare(out, xs)
    ms = time_ms(lambda: kernel_fn(*xs))
    plain_ms = time_ms(lambda: plain_fn(*xs))
    lib_ms = None
    if library_fn is not None and dtype == torch.bfloat16:
        with torch.no_grad():
            lib_ms = time_ms(library_fn(*xs))
    record(records, name, label, dtype, errs, ms, plain_ms, lib_ms, weight)
    return xs, out


def randn_on(gen):
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()
    return randn


def mlp_inputs(randn, M, C):
    H = 4 * C
    return [randn(M, C), 1 + randn(C, scale=0.1), randn(C, scale=0.1),
            randn(H, C, scale=C ** -0.5), randn(H, scale=0.1),
            randn(C, H, scale=H ** -0.5), randn(C, scale=0.1)]


def self_attention_lse(q, kv, heads):
    """The row log-sum-exp [B * heads, N] of K4's scaled scores, in fp32."""
    B, N, C = q.shape
    D = C // heads
    qh, kh = (t.reshape(B, N, heads, D).transpose(1, 2) for t in (q, kv[..., :C]))
    return torch.logsumexp(qh @ kh.transpose(-1, -2) * D ** -0.5, dim=-1).reshape(B * heads, N)


def rel_mask(rel, k_shape):
    """rel E^T: the bias as the dense float mask a library call takes."""
    from mspi_tpu_torch.ops.kernels.pooled_attention import key_expansion

    E = torch.from_numpy(key_expansion(k_shape)).to(rel.device, rel.dtype)
    return rel @ E.T


def heads_major(t, heads):
    B, N, C = t.shape
    return t.reshape(B, N, heads, C // heads).transpose(1, 2).contiguous()


def sdpa(q, k, v, mask=None, scale=None):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


# MViTv2-S's 16 blocks at 224x384 per clip as unique shapes: label, blocks
# of the shape, heads, Nq and the pooled key grid (Nk = kt*kh*kw, R =
# kt+kh+kw; D = 96): K1's shapes, and rows 6 and 8's; each shape's times
# count once per block (blocks 4-13 share one shape)
MVIT_BLOCKS = (("blk0", 1, 1, 43008, (8, 7, 12)), ("blk1", 1, 2, 10752, (8, 14, 24)),
               ("blk2", 1, 2, 10752, (8, 7, 12)), ("blk3", 1, 4, 2688, (8, 14, 24)),
               ("blk4-13", 10, 4, 2688, (8, 7, 12)), ("blk14", 1, 8, 672, (8, 14, 24)),
               ("blk15", 1, 8, 672, (8, 7, 12)))
# The blocks whose rel width R = kt+kh+kw passes 48 at the training CLI's
# `--resolution 256 448` (keys pooled to (8, 16, 28): R = 52), in the same
# form; checked against the plain versions, times out of the sums (0 blocks)
MVIT_WIDE_RES = (256, 448)
MVIT_WIDE = (("blk1@256x448", 0, 2, 14336, (8, 16, 28)), ("blk3@256x448", 0, 4, 3584, (8, 16, 28)),
             ("blk14@256x448", 0, 8, 896, (8, 16, 28)))
# The blocks whose rel width passes 64 at `--resolution 288 640` (keys pooled
# to (8, 18, 40): R = 66), where the bf16 K1 backward runs its wide form
# (`pooled_attention.rel_bwd_form`); backward checks only, times out of the
# sums (0 blocks)
MVIT_R66_RES = (288, 640)
MVIT_R66 = (("blk1@288x640", 0, 2, 23040, (8, 18, 40)), ("blk3@288x640", 0, 4, 5760, (8, 18, 40)),
            ("blk14@288x640", 0, 8, 1440, (8, 18, 40)))
# K2 shapes per clip: label, tokens, C, eps
LN_MLP_SHAPES = (("mvit-s1", 43008, 96, 1e-6), ("mvit-s2", 10752, 192, 1e-6),
                 ("mvit-s3", 2688, 384, 1e-6), ("mvit-s4", 672, 768, 1e-6),
                 ("sync", 708, 512, 1e-5), ("decoder0", 21504, 192, 1e-5))


# VideoSwin-S window attention per clip (N = 8*7*7 = 392, D = 32) at the
# 24 blocks (depths 2, 2, 18, 2; the odd blocks shifted) as the eight
# (stage, shifted) variants: label, blocks of the variant, windows per clip,
# heads, C, and the shift mask's padded grid and shift (None: unshifted, no
# mask). At 16x224x384 the stages see (8, 56, 96), (8, 28, 48), (8, 14, 24)
# and (8, 7, 12) tokens: W pads to a multiple of 7, and where D or H fits in
# one window (`get_window_size`) the window is clamped and its shift is 0.
SWIN_SHAPES = (("s1", 1, 112, 3, 96, None, None),
               ("s1-shift", 1, 112, 3, 96, (8, 56, 98), (0, 3, 3)),
               ("s2", 1, 28, 6, 192, None, None),
               ("s2-shift", 1, 28, 6, 192, (8, 28, 49), (0, 3, 3)),
               ("s3", 9, 8, 12, 384, None, None),
               ("s3-shift", 9, 8, 12, 384, (8, 14, 28), (0, 3, 3)),
               ("s4", 1, 2, 24, 768, None, None),
               ("s4-shift", 1, 2, 24, 768, (8, 7, 14), (0, 0, 3)))
SWIN_N, SWIN_D = 392, 32


def window_inputs(randn, batch, nw, heads, C, grid, shift):
    """[qkv, bias] (+ the stage's real shift mask) for `batch` clips."""
    from mspi_tpu_torch.models.videoswin import _attn_mask

    inputs = [randn(batch * nw, SWIN_N, 3 * C), randn(heads, SWIN_N, SWIN_N, scale=0.5)]
    if grid is not None:
        mask = torch.from_numpy(_attn_mask(*grid, (8, 7, 7), shift)).cuda()
        if mask.shape[0] != nw:
            raise AssertionError(f"mask of {mask.shape[0]} windows, expected {nw}")
        inputs.append(mask)
    return inputs


def window_library_operands(qkv, bias, mask, heads, nw):
    """q, k, v and the float mask (bias + shift mask) for one SDPA call: the
    windows of a clip folded into the head axis, [B_/nW, nW*H, N, D], so the
    mask [1, nW*H, N, N] broadcasts over the clips."""
    from mspi_tpu_torch.ops.kernels.window_attention import _split

    B = qkv.shape[0]
    q, k, v = (t.reshape(B // nw, nw * heads, SWIN_N, SWIN_D).contiguous()
               for t in _split(qkv, heads))
    m = bias[None] if mask is None else bias[None] + mask[:, None]
    return q, k, v, m.reshape(1, nw * heads, SWIN_N, SWIN_N).contiguous()


def phase_kernels(records) -> None:
    from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_prior, ln_mlp_reference
    from mspi_tpu_torch.ops.kernels.pooled_attention import (
        _self_attention_fwd, attention_rel, attention_rel_reference, self_attention,
        self_attention_reference)

    randn = randn_on(torch.Generator().manual_seed(1))
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS + MVIT_WIDE:
        nk, r = math.prod(k_shape), sum(k_shape)
        inputs = [randn(BATCH, heads, nq, 96), randn(BATCH, heads, nk, 96),
                  randn(BATCH, heads, nk, 96), randn(BATCH, heads, nq, r)]
        for dtype in (torch.float32, torch.bfloat16):
            def library(q, k, v, rel, ks=k_shape):
                mask = rel_mask(rel, ks)
                return lambda: sdpa(q, k, v, mask, 96 ** -0.5)
            xs, out = check_kernel(
                records, "attention_rel", label,
                lambda q, k, v, rel, ks=k_shape: attention_rel(q, k, v, rel, ks, 96 ** -0.5),
                lambda q, k, v, rel, ks=k_shape: attention_rel_reference(
                    q, k, v, rel, ks, 96 ** -0.5),
                inputs, dtype, library, weight=blocks)
            add_bound(records["attention_rel"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * heads * nq * nk * 96, weight=blocks)
        del inputs, xs, out
    for label, tokens, C, eps in LN_MLP_SHAPES:
        inputs = mlp_inputs(randn, BATCH * tokens, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "ln_mlp", label, lambda *a, e=eps: ln_mlp(*a, e),
                                   lambda *a, e=eps: ln_mlp_reference(*a, e), inputs, dtype)
            add_bound(records["ln_mlp"], dtype, nbytes(*xs, out), 4.0 * BATCH * tokens * C * 4 * C)
    # K3's call site: the prior's four stages, 16 frames per clip
    for label, tokens, C in (("prior-s0", 5376, 96), ("prior-s1", 1344, 192),
                             ("prior-s2", 336, 384), ("prior-s3", 84, 768)):
        inputs = mlp_inputs(randn, BATCH * 16 * tokens, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "ln_mlp_prior", label,
                                   lambda *a: ln_mlp_prior(*a, 1e-6),
                                   lambda *a: ln_mlp_reference(*a, 1e-6), inputs, dtype)
            add_bound(records["ln_mlp_prior"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * 16 * tokens * C * 4 * C)
    # K4: SyncBlock, N = 672 + 36
    inputs = [randn(BATCH, 708, 512), randn(BATCH, 708, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        def library(q, kv):
            qh, kh, vh = (heads_major(t, 4) for t in (q, kv[..., :512], kv[..., 512:]))
            return lambda: sdpa(qh, kh, vh)
        xs, out = check_kernel(records, "self_attention", "sync",
                               lambda q, kv: self_attention(q, kv, 4),
                               lambda q, kv: self_attention_reference(q, kv, 4), inputs, dtype,
                               library)
        add_bound(records["self_attention"], dtype, nbytes(*xs, out),
                  4.0 * BATCH * 4 * 708 * 708 * 128)
    # K4 at the training shape, with the lse (natural log, fp32) that row 7's
    # backward reads; the times stay out of the sums
    inputs = [randn(TRAIN_BATCH, 708, 512), randn(TRAIN_BATCH, 708, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        def with_lse(out_lse, xs):
            out, lse = out_lse
            q, kv = (t.float() for t in xs)
            ref = self_attention_reference(q, kv, 4)
            ref_lse = self_attention_lse(q, kv, 4)
            return [((out.float() - ref).abs().max().item(), tolerance(dtype, ref)),
                    ((lse - ref_lse).abs().max().item(), tolerance(dtype, ref_lse))]
        check_kernel(records, "self_attention", "sync-train-lse",
                     lambda q, kv: _self_attention_fwd(q, kv, 4, with_lse=True),
                     lambda q, kv: self_attention_reference(q, kv, 4), inputs, dtype,
                     compare=with_lse, weight=0)
    # row 15: the eight VideoSwin variants, shifted blocks with their mask
    from mspi_tpu_torch.ops.kernels.window_attention import (window_attention,
                                                             window_attention_reference)

    for label, blocks, nw, heads, C, grid, shift in SWIN_SHAPES:
        inputs = window_inputs(randn, BATCH, nw, heads, C, grid, shift)
        n = nw if grid is not None else 1
        for dtype in (torch.float32, torch.bfloat16):
            def library(qkv, bias, *mask, h=heads, w=n):
                q, k, v, m = window_library_operands(qkv, bias, mask[0] if mask else None, h, w)
                return lambda: sdpa(q, k, v, m, SWIN_D ** -0.5)
            xs, out = check_kernel(
                records, "window_attention", label,
                lambda qkv, bias, *m, h=heads, w=n: window_attention(
                    qkv, bias, m[0] if m else None, h, w),
                lambda qkv, bias, *m, h=heads, w=n: window_attention_reference(
                    qkv, bias, m[0] if m else None, h, w),
                inputs, dtype, library, weight=blocks)
            add_bound(records["window_attention"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * nw * heads * SWIN_N * SWIN_N * SWIN_D, weight=blocks)
        del inputs, xs, out
    serving_kernels(records, randn)


# Row 12 shapes per clip (MViTv2-S; VideoSwin-S's stage 3 and 4 have the
# same token counts): label, tokens, C
INT8_SHAPES = (("mvit-s3", 2688, 384), ("mvit-s4", 672, 768), ("sync", 708, 512))
# The prior's stages per frame (16 frames per clip): label, tokens, C
PRIOR_SHAPES = (("prior-s0", 5376, 96), ("prior-s1", 1344, 192), ("prior-s2", 336, 384),
                ("prior-s3", 84, 768))
# Row 11 call sites per frame: stem.1 and stages_{1,2,3}.downsample.0
LN_SHAPES = (("stem", 5376, 96), ("ds1", 5376, 96), ("ds2", 1344, 192), ("ds3", 336, 384))


def int8_errors(out, ref):
    """Row 12's tolerance: RMS error <= 1e-3 of the output's RMS and max abs
    error <= 0.02 x max|ref|. Kernel and plain version compute the same
    int8 codes, except where the LayerNorm sums or the square root round
    across a code's boundary: one code flips on rare elements."""
    d = (out.double() - ref.double())
    rms = ref.double().pow(2).mean().sqrt().item()
    flips = (d.abs() > 1e-3 * rms).sum().item()
    log("kernels", f"  int8: {flips} of {d.numel()} outputs off by more than 1e-3 x RMS "
                   f"(a flipped code)")
    return [(d.pow(2).mean().sqrt().item(), 1e-3 * rms),
            (d.abs().max().item(), 0.02 * ref.abs().max().item())]


def serving_kernels(records, randn) -> None:
    """Rows 10, 11 and 12 at the serving path's shapes, fp32 and bf16."""
    import torch.nn.functional as F

    from mspi_tpu_torch.ops.kernels import ln_mlp as K2
    from mspi_tpu_torch.ops.kernels.layernorm import layernorm_tokens, layernorm_tokens_reference

    for label, tokens, C in INT8_SHAPES:
        M, H = BATCH * tokens, 4 * C
        g, b, w1, b1, w2, b2 = (t.float() for t in mlp_inputs(randn, 1, C)[1:])
        w1q, s1 = K2.quantize_weight(w1)
        w2q, s2 = K2.quantize_weight(w2)
        ops = (g, b, w1q, s1, b1, w2q, s2, b2)
        x32 = randn(M, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(
                records, "ln_mlp_int8", label, lambda x: K2.ln_mlp_int8(x, *ops, 1e-6),
                lambda x: K2.ln_mlp_int8_reference(x, *ops, 1e-6), [x32], dtype,
                compare=lambda out, xs: int8_errors(
                    out, K2.ln_mlp_int8_reference(xs[0], *ops, 1e-6)))
            add_bound(records["ln_mlp_int8"], dtype, nbytes(*xs, out, *ops),
                      4.0 * M * C * H, PEAK_INT8_OPS)
        del x32, xs, out
    for label, tokens, C in PRIOR_SHAPES:
        M = BATCH * 16 * tokens
        inputs = mlp_inputs(randn, M, C)
        inputs[1:1] = [randn(M, C), 0.2 + randn(C, scale=0.05)]  # shortcut, gamma
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "ln_mlp_prior_res", label,
                                   lambda *a: K2.ln_mlp_prior_res(*a, 1e-6),
                                   lambda *a: K2.ln_mlp_prior_res_reference(*a, 1e-6),
                                   inputs, dtype)
            add_bound(records["ln_mlp_prior_res"], dtype, nbytes(*xs, out),
                      4.0 * M * C * 4 * C)
        del inputs, xs, out
    for label, tokens, C in LN_SHAPES:
        M = BATCH * 16 * tokens
        inputs = [randn(M, C) + 0.5, 1 + randn(C, scale=0.1), randn(C, scale=0.1)]
        for dtype in (torch.float32, torch.bfloat16):
            def library(x, g, b, c=C):
                return lambda: F.layer_norm(x, (c,), g, b, 1e-6)
            xs, out = check_kernel(records, "layernorm_tokens", label,
                                   lambda x, g, b: layernorm_tokens(x, g, b, 1e-6),
                                   lambda x, g, b: layernorm_tokens_reference(x, g, b, 1e-6),
                                   inputs, dtype, library)
            add_bound(records["layernorm_tokens"], dtype, nbytes(*xs, out), 8.0 * M * C,
                      PEAK_FLOPS[torch.float32])
        del inputs, xs, out


def compare_grads(names, got, want, dtype):
    """Per-gradient (error, tolerance) pairs, each against its own scale
    max|ref| with no floor, so a sub-unit gradient is held to its own size;
    logs each gradient's error and scale."""
    out, parts = [], []
    for name, g, w in zip(names, got, want):
        w = w.float()
        err, scale = (g.float() - w).abs().max().item(), w.abs().max().item()
        out.append((err, tolerance(dtype, w, floor=0.0)))
        parts.append(f"{name} {err:.1e}/{scale:.1e}")
    log("kernels", f"  {str(dtype)[6:]} err/scale: " + " ".join(parts))
    return out


def split_kv(grads, C):
    """(dq, dkv) -> (dq, dk, dv): the two lanes of dkv have their own scales."""
    dq, dkv = grads
    return dq, dkv[..., :C], dkv[..., C:]


def check_repeatable(name, label, bwd, got) -> None:
    """One writer per element and a fixed summation order: a second run of
    the bf16 backward gives bit-identical gradients."""
    again = bwd()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    log("kernels", f"  {name} {label} bf16: a second run "
                   f"{'bit-identical' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError(f"{name} {label}: two runs differ")


def library_grad(fn, inputs, dout):
    """fwd + bwd of one library call on leaf copies of `inputs`."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]

    def run():
        torch.autograd.grad(fn(*leaves), leaves, dout)
    return run


def phase_backward(records) -> None:
    from mspi_tpu_torch.ops.kernels import ln_mlp as K2
    from mspi_tpu_torch.ops.kernels import pooled_attention as PA

    randn = randn_on(torch.Generator().manual_seed(11))
    B = TRAIN_BATCH
    rec = records["attention_rel_bwd"]
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS + MVIT_WIDE + MVIT_R66:
        nk, r = math.prod(k_shape), sum(k_shape)
        scale = 96 ** -0.5
        inputs = [randn(B, heads, nq, 96), randn(B, heads, nk, 96), randn(B, heads, nk, 96),
                  randn(B, heads, nq, r), randn(B, heads, nq, 96)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rel, dout = (t.to(dtype) for t in inputs)
            out, lse = PA._attention_rel_fwd(q, k, v, rel, k_shape, scale, with_lse=True)
            bwd = lambda: PA.attention_rel_backward(q, k, v, rel, out, lse, k_shape, scale, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.attention_rel_backward_reference(*(t.float() for t in (q, k, v, rel)),
                                                       k_shape, scale, dout.float())
            errs = compare_grads(("dq", "dk", "dv", "drel"), got, want, dtype)
            if dtype == torch.bfloat16:
                check_repeatable("attention_rel_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.attention_rel_backward_reference(
                q, k, v, rel, k_shape, scale, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                mask = rel_mask(rel, k_shape)
                lib_ms = time_ms(library_grad(lambda *a: sdpa(*a, scale), (q, k, v, mask), dout))
                del mask
            record(records, "attention_rel_bwd", label, dtype, errs, ms, plain_ms, lib_ms,
                   weight=blocks)
            add_bound(rec, dtype, nbytes(q, k, v, rel, out, lse, dout, *got),
                      10.0 * B * heads * nq * nk * 96, weight=blocks)
            del got, want, out, lse
    # the bias-free backward at the SyncBlock shape: N = 672 + 36, C 512, 4 heads
    N, C, heads = 708, 512, 4
    inputs = [randn(B, N, C), randn(B, N, 2 * C), randn(B, N, C)]
    for dtype in (torch.float32, torch.bfloat16):
        q, kv, dout = (t.to(dtype) for t in inputs)
        out, lse = PA._self_attention_fwd(q, kv, heads, with_lse=True)
        bwd = lambda: PA.self_attention_backward(q, kv, out, lse, heads, dout)
        got = bwd()
        torch.cuda.synchronize()
        want = PA.self_attention_backward_reference(q.float(), kv.float(), heads, dout.float())
        errs = compare_grads(("dq", "dk", "dv"), split_kv(got, C), split_kv(want, C), dtype)
        ms = time_ms(bwd)
        plain_ms = time_ms(lambda: PA.self_attention_backward_reference(q, kv, heads, dout))
        lib_ms = None
        if dtype == torch.bfloat16:
            qh, kh, vh, doh = (heads_major(t, heads) for t in
                               (q, kv[..., :C], kv[..., C:], dout))
            lib_ms = time_ms(library_grad(sdpa, (qh, kh, vh), doh))
        record(records, "attention_bwd", "sync", dtype, errs, ms, plain_ms, lib_ms)
        add_bound(records["attention_bwd"], dtype, nbytes(q, kv, out, lse, dout, *got),
                  10.0 * B * heads * N * N * (C // heads))
    for label, tokens, C, eps in LN_MLP_SHAPES:
        M = B * tokens
        inputs = mlp_inputs(randn, M, C) + [randn(M, C)]
        for dtype in (torch.float32, torch.bfloat16):
            xs = [t.to(dtype) for t in inputs]
            bwd = lambda: K2.ln_mlp_backward(*xs[:7], eps, xs[7])
            got = bwd()
            torch.cuda.synchronize()
            want = K2.ln_mlp_backward_reference(*(t.float() for t in xs[:7]), eps,
                                                xs[7].float())
            errs = compare_grads(("dx", "dg", "db", "dw1", "db1", "dw2", "db2"), got, want,
                                 dtype)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: K2.ln_mlp_backward_reference(*xs[:7], eps, xs[7]))
            record(records, "ln_mlp_bwd", label, dtype, errs, ms, plain_ms)
            add_bound(records["ln_mlp_bwd"], dtype, nbytes(*xs, *got), 10.0 * M * C * 4 * C)
    # rows 16/17: the window backward at the eight VideoSwin variants
    from mspi_tpu_torch.ops.kernels import window_attention as WA

    for label, blocks, nw, heads, C, grid, shift in SWIN_SHAPES:
        inputs = window_inputs(randn, B, nw, heads, C, grid, shift)
        dout32 = randn(B * nw, SWIN_N, C)
        n = nw if grid is not None else 1
        for dtype in (torch.float32, torch.bfloat16):
            qkv, bias = (t.to(dtype) for t in inputs[:2])
            mask = inputs[2].to(dtype) if grid is not None else None
            dout = dout32.to(dtype)
            out, lse = WA._window_attention_fwd(qkv, bias, mask, heads, n, with_lse=True)
            bwd = lambda: WA.window_attention_backward(qkv, bias, mask, out, lse, heads, n, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = WA.window_attention_backward_reference(
                qkv.float(), bias.float(), None if mask is None else mask.float(), heads, n,
                dout.float())

            def parts(g):  # dq, dk, dv lanes and dbias, each to its own scale
                dqkv, dbias = g
                return dqkv[..., :C], dqkv[..., C:2 * C], dqkv[..., 2 * C:], dbias
            errs = compare_grads(("dq", "dk", "dv", "dbias"), parts(got), parts(want), dtype)
            if dtype == torch.bfloat16:
                check_repeatable("window_attention_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: WA.window_attention_backward_reference(
                qkv, bias, mask, heads, n, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                q, k, v, m = window_library_operands(qkv, bias, mask, heads, n)
                doh = dout.reshape(B * nw, SWIN_N, heads, SWIN_D).transpose(1, 2).reshape(
                    q.shape).contiguous()
                lib_ms = time_ms(library_grad(lambda *a: sdpa(*a, SWIN_D ** -0.5),
                                              (q, k, v, m), doh))
                del q, k, v, m, doh
            record(records, "window_attention_bwd", label, dtype, errs, ms, plain_ms, lib_ms,
                   weight=blocks)
            add_bound(records["window_attention_bwd"], dtype,
                      nbytes(qkv, bias, *(() if mask is None else (mask,)), out, lse, dout,
                             *got),
                      10.0 * B * nw * heads * SWIN_N * SWIN_N * SWIN_D, weight=blocks)
            del got, want, out, lse


# its 17 stride-1 pools per clip: label, pools of the shape, heads, (T, H, W)
DWCONV_SHAPES = (("blk0-q", 1, 1, (8, 56, 96)), ("blk2-q", 1, 2, (8, 28, 48)),
                 ("blk4-13-q", 10, 4, (8, 14, 24)), ("blk14-kv", 2, 8, (8, 14, 24)),
                 ("blk15-qkv", 3, 8, (8, 7, 12)))
MVIT_D = 96
# Row 18 off the stage grids of 224x384, [N, T, H, W, C]: the stage grids of
# 288x640 (tiles 8 x 16, 8 x 16, 8 x 16, 14 x 12 by `dwconv.dwconv3d_tile`),
# each bf16 tile ragged in H and W, a part channel group (C = 40), T = 1 and
# 3, and C = 20 (off the 8-channel vector: the fp32-slab kernel in bf16)
DWCONV3D_RAGGED = (("288x640-s1", (2, 8, 72, 160, 96)), ("288x640-s2", (2, 8, 36, 80, 96)),
                   ("288x640-s3", (2, 8, 18, 40, 96)), ("288x640-s4", (2, 8, 9, 20, 96)),
                   ("8x16 ragged", (2, 8, 15, 25, 40)), ("14x12 ragged", (1, 5, 22, 19, 96)),
                   ("14x12 ragged T 3", (2, 3, 11, 25, 96)),
                   ("8x16 ragged T 1", (2, 1, 15, 19, 64)),
                   ("C 20", (1, 4, 11, 19, 20)))


def conv3d_library(x, w):
    """Grouped F.conv3d (stride 1, SAME) on the NCDHW-contiguous copy of
    channels-last x [N, T, H, W, C], made here: row 18's library call."""
    import torch.nn.functional as F

    x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
    return lambda: F.conv3d(x_ncdhw, w, None, 1, 1, 1, x.shape[-1])


def aug_inputs(randn, batch, heads, nq, k_shape):
    """q_aug [.., Nq, 96+R] (q*scale lanes, then rel lanes), k_aug (k, then
    the 0/1 expansion E of the key grid) and v [.., Nk, 96], as the model
    builds them."""
    from mspi_tpu_torch.ops.kernels.pooled_attention import key_expansion

    nk, r = math.prod(k_shape), sum(k_shape)
    E = torch.from_numpy(key_expansion(k_shape)).cuda()
    q_aug = torch.cat([randn(batch, heads, nq, MVIT_D, scale=MVIT_D ** -0.5),
                       randn(batch, heads, nq, r)], -1)
    k_aug = torch.cat([randn(batch, heads, nk, MVIT_D), E.expand(batch, heads, nk, r)], -1)
    return [q_aug, k_aug, randn(batch, heads, nk, MVIT_D)]


def packed_inputs(randn, batch, heads, nq, k_shape):
    """q, k, v [.., N, heads*96] and rel [.., Nq, heads*R], token-major."""
    nk, r, C = math.prod(k_shape), sum(k_shape), heads * MVIT_D
    return [randn(batch, nq, C), randn(batch, nk, C), randn(batch, nk, C),
            randn(batch, nq, heads * r)]


def phase_layout_kernels(records) -> None:
    """Rows 6, 8 and 18 at the MViTv2-S shapes, batch 8, fp32 and bf16; the
    bf16 times (kernel, plain, library, bound) summed per forward. Row 8 is
    also checked at the R = 52 shapes of 256x448 (`MVIT_WIDE`, rel rows in
    shared memory), row 18 on the packed layout and off its tiles
    (`DWCONV3D_RAGGED`), out of the sums."""
    from mspi_tpu_torch.ops.kernels import dwconv as DW
    from mspi_tpu_torch.ops.kernels import pooled_attention as PA

    randn = randn_on(torch.Generator().manual_seed(21))
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS:
        nk, r = math.prod(k_shape), sum(k_shape)
        inputs = aug_inputs(randn, BATCH, heads, nq, k_shape)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(
                records, "attention", f"{label} Da {MVIT_D + r}", PA.attention,
                PA.attention_reference, inputs, dtype,
                lambda q, k, v: (lambda: sdpa(q, k, v, scale=1.0)), weight=blocks)
            add_bound(records["attention"], dtype, nbytes(*xs, out),
                      2.0 * BATCH * heads * nq * nk * (MVIT_D + r + MVIT_D), weight=blocks)
        del inputs, xs, out
    # the blocks with heads > 1, and the R = 52 shapes (checked only)
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS[1:] + MVIT_WIDE:
        nk = math.prod(k_shape)
        inputs = packed_inputs(randn, BATCH, heads, nq, k_shape)
        scale = MVIT_D ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            def library(q, k, v, rel, ks=k_shape, h=heads):
                qh, kh, vh, rh = (heads_major(t, h) for t in (q, k, v, rel))
                mask = rel_mask(rh, ks)
                return lambda: sdpa(qh, kh, vh, mask, scale) + qh
            xs, out = check_kernel(
                records, "attention_rel_packed", label,
                lambda q, k, v, rel, ks=k_shape, h=heads: PA.attention_rel_packed(
                    q, k, v, rel, ks, h, scale, True),
                lambda q, k, v, rel, ks=k_shape, h=heads: PA.attention_rel_packed_reference(
                    q, k, v, rel, ks, h, scale, True),
                inputs, dtype, library, weight=blocks)
            add_bound(records["attention_rel_packed"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * heads * nq * nk * MVIT_D, weight=blocks)
        del inputs, xs, out
    # row 18 per head as the pools run it, once on the packed layout (all
    # heads' lanes, the kernel tiled over the heads), then off its tiles
    # (checked only)
    shapes = [(label, n, BATCH * heads, thw, MVIT_D) for label, n, heads, thw in DWCONV_SHAPES]
    shapes.append(("blk4-13-q packed", 0, BATCH, (8, 14, 24), 4 * MVIT_D))
    shapes += [(f"{label} [{N},{T},{H},{W},{C}]", 0, N, (T, H, W), C)
               for label, (N, T, H, W, C) in DWCONV3D_RAGGED]
    for label, pools, N, thw, C in shapes:
        inputs = [randn(N, *thw, C), randn(C, 1, 3, 3, 3, scale=0.2)]
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "dwconv3d", label, DW.dwconv3d,
                                   DW.dwconv3d_reference, inputs, dtype, conv3d_library,
                                   weight=pools)
            add_bound(records["dwconv3d"], dtype, nbytes(*xs, out), 2.0 * 27 * out.numel(),
                      PEAK_FLOPS[torch.float32], weight=pools)
        del inputs, xs, out


def phase_layout_backward(records) -> None:
    """Row 7 head-major (row 6's backward) at the 16 blocks, row 8's
    backward at blocks 1-15 and row 18's dx at the 17 pools, batch 2, fp32
    and bf16. Row 7's bf16 times sum per training step into attention_bwd;
    row 8's backward (K1's kernel after a layout change; not on a chip
    path) and row 18's dx are checked and logged only."""
    from mspi_tpu_torch.ops.kernels import dwconv as DW
    from mspi_tpu_torch.ops.kernels import pooled_attention as PA

    randn = randn_on(torch.Generator().manual_seed(31))
    B = TRAIN_BATCH
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS:
        nk, r = math.prod(k_shape), sum(k_shape)
        inputs = aug_inputs(randn, B, heads, nq, k_shape) + [randn(B, heads, nq, MVIT_D)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(dtype) for t in inputs)
            out, lse = PA._attention_fwd(q, k, v, with_lse=True)
            bwd = lambda: PA.attention_backward(q, k, v, out, lse, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.attention_backward_reference(q.float(), k.float(), v.float(),
                                                   dout.float())
            errs = compare_grads(("dq", "dk", "dv"), got, want, dtype)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.attention_backward_reference(q, k, v, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                lib_ms = time_ms(library_grad(lambda *a: sdpa(*a, scale=1.0), (q, k, v), dout))
            record(records, "attention_bwd", f"{label} Da {MVIT_D + r}", dtype, errs, ms,
                   plain_ms, lib_ms, weight=blocks)
            add_bound(records["attention_bwd"], dtype, nbytes(q, k, v, out, lse, dout, *got),
                      2.0 * B * heads * nq * nk * (3 * (MVIT_D + r) + 2 * MVIT_D),
                      weight=blocks)
            del got, want, out, lse
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS[1:] + MVIT_WIDE + MVIT_R66:
        scale = MVIT_D ** -0.5
        inputs = packed_inputs(randn, B, heads, nq, k_shape) + [randn(B, nq, heads * MVIT_D)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rel, dout = (t.to(dtype) for t in inputs)
            o, lse = PA._attention_rel_packed_fwd(q, k, v, rel, k_shape, heads, scale, False,
                                                  with_lse=True)
            bwd = lambda: PA.attention_rel_packed_backward(q, k, v, rel, o, lse, k_shape, heads,
                                                           scale, True, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.attention_rel_packed_backward_reference(
                *(t.float() for t in (q, k, v, rel)), k_shape, heads, scale, True, dout.float())
            errs = compare_grads(("dq", "dk", "dv", "drel"), got, want, dtype)
            if dtype == torch.bfloat16:
                check_repeatable("attention_rel_bwd", f"packed {label}", bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.attention_rel_packed_backward_reference(
                q, k, v, rel, k_shape, heads, scale, True, dout))
            record(records, "attention_rel_bwd", f"packed {label}", dtype, errs, ms, plain_ms,
                   weight=0)
            del got, want, o, lse
    for label, pools, heads, thw in DWCONV_SHAPES:
        C, N = MVIT_D, B * heads
        inputs = [randn(N, *thw, C), randn(C, 1, 3, 3, 3, scale=0.2), randn(N, *thw, C)]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = (t.to(dtype) for t in inputs)
            dx_fn = lambda: DW._dwconv3d_fwd(dy, w.flip(2, 3, 4).contiguous())
            dx = dx_fn()
            torch.cuda.synchronize()
            want = DW.dwconv3d_backward_reference(x.float(), w.float(), dy.float())[0]
            errs = compare_grads(("dx",), (dx,), (want,), dtype)
            ms = time_ms(dx_fn)
            plain_ms = time_ms(lambda: DW.dwconv3d_reference(dy, w.flip(2, 3, 4)))
            lib_ms = None
            if dtype == torch.bfloat16:  # grouped conv3d of dy with the flipped taps
                with torch.no_grad():
                    lib_ms = time_ms(conv3d_library(dy, w.flip(2, 3, 4).contiguous()))
            record(records, "dwconv3d", f"dx {label}", dtype, errs, ms, plain_ms, lib_ms,
                   weight=0)
            del dx, want


def phase_mlp_kernels(records) -> dict:
    """Rows 13 and 14 against their plain versions at K2's shapes (forward
    batch 8, backward batch 2), fp32 and bf16; then the path: one
    `maybe_fused_mlp` forward and backward of the port's MViT `Mlp` (C 96,
    fp32) at stage 1's tokens, batch 2, with exactly one launch of each."""
    import torch.nn.functional as F

    from mspi_tpu_torch.models.mvit import Mlp
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.ops.kernels import ln_mlp as K2

    randn = randn_on(torch.Generator().manual_seed(41))
    for label, tokens, C, _ in LN_MLP_SHAPES:
        M = BATCH * tokens
        x, _, _, w1, b1, w2, b2 = mlp_inputs(randn, M, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "mlp", label, K2.fused_mlp, K2.mlp_reference,
                                   [x, w1, b1, w2, b2], dtype)
            add_bound(records["mlp"], dtype, nbytes(*xs, out), 4.0 * M * C * 4 * C)
        del x, xs, out
    for label, tokens, C, _ in LN_MLP_SHAPES:
        M = TRAIN_BATCH * tokens
        x, _, _, w1, b1, w2, b2 = mlp_inputs(randn, M, C)
        inputs = [x, w1, b1, w2, b2, randn(M, C)]
        for dtype in (torch.float32, torch.bfloat16):
            xs = [t.to(dtype) for t in inputs]
            bwd = lambda: K2.mlp_backward(*xs)
            got = bwd()
            torch.cuda.synchronize()
            want = K2.mlp_backward_reference(*(t.float() for t in xs))
            errs = compare_grads(("dx", "dw1", "db1", "dw2", "db2"), got, want, dtype)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: K2.mlp_backward_reference(*xs))
            record(records, "mlp_bwd", label, dtype, errs, ms, plain_ms)
            add_bound(records["mlp_bwd"], dtype, nbytes(*xs, *got), 10.0 * M * C * 4 * C)
            del got, want

    torch.manual_seed(0)
    mlp = Mlp(96, 384, 96).cuda()
    x = torch.randn(TRAIN_BATCH, 43008, 96, generator=torch.Generator().manual_seed(42)).cuda()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(43)).cuda()
    x.requires_grad_(True)
    kernels.reset_launch_counts()
    y = K2.maybe_fused_mlp(mlp, x)
    y.backward(dy)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    want_counts = {name: int(name in ("mlp", "mlp_bwd")) for name in KERNELS}
    if counts != want_counts:
        raise AssertionError(f"maybe_fused_mlp launches {counts}, expected one mlp, one mlp_bwd")
    grads = [x.grad] + [p.grad for p in mlp.parameters()]
    ref = mlp.fc2(F.gelu(mlp.fc1(x.detach())))
    err = (y - ref).abs().max().item()
    if not (err <= tolerance(torch.float32, ref) and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError(f"maybe_fused_mlp: error {err} or non-finite gradients")
    log("mlp_kernels", f"maybe_fused_mlp on Mlp(96, 384) fp32 [{TRAIN_BATCH}, 43008, 96]: "
                       f"forward + backward, launches mlp 1 mlp_bwd 1, max_abs_err {err:.3e}, "
                       f"gradients finite")
    return counts


# row 19's ragged shapes [N, H, W, C]: H and W off its tiles (8 x 16 at W =
# 41 and 19, 8 x 32 with H off 8 at W = 64 and 32; the lab's stages fill
# whole 4 x 8 warp tiles), each tile width with a part channel group (C =
# 40) and C = 1
DWCONV2D_RAGGED = ((2, 13, 41, 40), (3, 9, 19, 1), (2, 13, 64, 40), (1, 11, 32, 1))


def phase_lab(records) -> dict:
    """The three kernel labs' `main` in this process at their default shapes
    (MSPI_LAB_ITERS repeats, 20 unless set); each kernel variant is held
    against its plain version inside the lab, and its times and bound fold
    into its record. The labs' launches are this phase's path."""
    import os

    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.ops.kernels.dwconv import dwconv2d, dwconv2d_reference
    from mspi_tpu_torch.ops.kernels.lab import gemm, gemm_reference
    from mspi_tpu_torch.tools import bench_dwconv, bench_int8, bench_lnmlp

    # the bf16 GEMM off the lab's square: 3 k tiles, and 2.5 (K % 64 == 32)
    randn = randn_on(torch.Generator().manual_seed(3))
    for M, K, N in ((256, 192, 384), (384, 160, 640)):
        check_kernel(records, "gemm_bf16", f"{M}x{K}x{N}", gemm, gemm_reference,
                     [randn(M, K), randn(K, N)], torch.bfloat16, weight=0)
    # the int8 GEMM exactly, wrap-around included: 1.5 and 2.5 k boxes of 128
    # (K % 128 == 64) in 64-row tiles, 2.5 in 128-row tiles (144 of them),
    # and 4096^3 (128-row tiles)
    gen8 = torch.Generator().manual_seed(4)

    def exact(out, xs):
        return [((out.int() - gemm_reference(*xs).int()).abs().max().item(), 0.0)]
    for M, K, N in ((256, 192, 384), (384, 320, 640), (2048, 320, 1152), (4096, 4096, 4096)):
        a, b = (torch.randint(-127, 128, shape, generator=gen8, dtype=torch.int8).cuda()
                for shape in ((M, K), (K, N)))
        check_kernel(records, "gemm_int8", f"{M}x{K}x{N}", gemm, gemm_reference, [a, b],
                     torch.int8, compare=exact, weight=0)
    # row 19 off its tiles: a part channel group (C = 40) by the 16-byte
    # copies, and C = 1 by the element loads
    for N, H, W, C in DWCONV2D_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(records, "dwconv2d", f"[{N},{H},{W},{C}]", dwconv2d,
                         dwconv2d_reference,
                         [randn(N, H, W, C), randn(7, 7, C, scale=0.1), randn(C, scale=0.1)],
                         dtype, weight=0)
    os.environ.setdefault("MSPI_LAB_ITERS", "20")
    kernels.reset_launch_counts()
    results = []
    for lab in (bench_dwconv, bench_lnmlp, bench_int8):
        log("lab", f"python -m {lab.__name__}")
        results += lab.main([])
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    for r in results:
        if r.kernel is None:
            continue
        rec = records[r.kernel]
        rec["max_abs_err"] = max(rec["max_abs_err"], r.max_abs_err)
        rec["ms"] += r.ms
        rec["plain_ms"] += r.plain_ms
        if r.library_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + r.library_ms
        rec["bound_ms"] += r.bound_ms
        rec["bound_by"] = r.bound_by
    missing = [name for name in LAB_KERNELS if not counts[name]]
    if missing:
        raise AssertionError(f"lab kernels not launched: {missing}")
    log("lab", f"launches {counts}")
    return counts


def synthetic_video(seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (N_FRAMES, *RES, 3), dtype=np.uint8)
    t = np.arange(int(2.5 * SAMPLE_RATE)) / SAMPLE_RATE
    audio = (0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 0.7 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    return frames, audio


def model_config(key: str):
    """The config of a PER_FORWARD key: a motion encoder, + its options."""
    from mspi_tpu_torch.config import get_config

    return get_config(key.split("+")[0], {"model": OPTIONS.get(key, {})})


def build_model(key: str, device: str, dtype: torch.dtype):
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel

    return AudioVisualSaliencyModel(model_config(key), device=device, dtype=dtype,
                                    generator=torch.Generator().manual_seed(0))


def phase_main_path(tag: str, key: str) -> dict:
    from mspi_tpu_torch.inference import predict_video, sliding_window_jobs
    from mspi_tpu_torch.ops import kernels

    model = build_model(key, "cuda", torch.bfloat16)
    frames, audio = synthetic_video(0)
    n_windows = len(sliding_window_jobs(N_FRAMES, 16))
    forwards = -(-n_windows // BATCH)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    maps = predict_video(model, frames, audio, FPS, window_batch=BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    log(tag, f"{key} predict_video: {n_windows} windows in {forwards} forwards of "
             f"{BATCH}, {wall:.2f} s wall (first call), launches {counts}")

    if maps.shape != (N_FRAMES, 480, 640) or maps.dtype != np.uint8:
        raise AssertionError(f"maps {maps.shape} {maps.dtype}, expected "
                             f"({N_FRAMES}, 480, 640) uint8")
    flat = maps.reshape(N_FRAMES, -1)
    if not ((flat.min(axis=1) == 0).all() and (flat.max(axis=1) == 255).all()):
        raise AssertionError("a map is constant or not min-max normalised "
                             "(non-finite log-density)")
    for name in KERNELS:
        want = forwards * PER_FORWARD[key].get(name, 0)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")

    clips = torch.from_numpy(np.stack([frames[i:i + 16] for i in range(BATCH)])).cuda()
    auds = torch.randn(BATCH, 257, 111, 1, generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        out, loss = model(clips, auds)
        if not (torch.isfinite(out).all() and torch.isfinite(loss)):
            raise AssertionError("non-finite model output")
        ms = time_ms(lambda: model(clips, auds), warmup=1, reps=3)
    log(tag, f"{key} forward bf16 batch {BATCH}: {ms:.1f} ms = "
             f"{BATCH * 1000 / ms:.2f} clips/s (CUDA events, median of 3); "
             f"map {N_FRAMES} x 480 x 640 uint8 ok")
    if key in OPTIONS:
        compare_with_float(tag, key, model, clips, auds)
    del model
    torch.cuda.empty_cache()
    return counts


def compare_with_float(tag: str, key: str, model, clips, auds) -> None:
    """The options' model against the float bf16 model of the same seed:
    forwards timed in turns (float, options, options, float), and how many
    int8 codes the bf16-rounded weights give otherwise than the fp32
    weights the models are drawn from."""
    from mspi_tpu_torch.ops.kernels.ln_mlp import quantize_weight

    flt = build_model(key.split("+")[0], "cuda", torch.bfloat16)
    with torch.no_grad():
        times = [time_ms(lambda m=m: m(clips, auds), warmup=1, reps=5)
                 for m in (flt, model, model, flt)]
    del flt
    log(tag, f"{key} vs float, bf16 batch {BATCH}, in turns: float {times[0]:.1f} / "
             f"{times[3]:.1f} ms, options {times[1]:.1f} / {times[2]:.1f} ms = "
             f"{BATCH * 1000 / statistics.mean(times[:4:3]):.2f} vs "
             f"{BATCH * 1000 / statistics.mean(times[1:3]):.2f} clips/s (CUDA events, "
             f"medians of 5)")
    if OPTIONS[key].get("quant") != "int8":
        return
    ref = build_model(key, "cpu", torch.float32)
    ref_mods = dict(ref.named_modules())
    differ = total = 0
    for name, m in model.named_modules():
        if hasattr(m, "int8_w1q"):
            for q, w in ((m.int8_w1q, ref_mods[name].fc1.weight),
                         (m.int8_w2q, ref_mods[name].fc2.weight)):
                differ += (q.cpu() != quantize_weight(w)[0]).sum().item()
                total += q.numel()
    log(tag, f"int8 codes of the bf16 model's weights: {differ} of {total} "
             f"({100.0 * differ / total:.3f}%) differ from the fp32 weights' codes")


def phase_options_parity(tag: str, key: str) -> None:
    """The options' model in fp32: card against the CPU's plain versions
    (CC >= 0.9999), and card against the card's model without the options
    (int8: CC >= 0.99, the cost of int8, recorded; the layout options
    compute the same function: CC >= 0.9999)."""
    frames, _ = synthetic_video(3)
    clip = torch.from_numpy(frames[None, :16].copy())
    aud = torch.randn(1, 257, 111, 1, generator=torch.Generator().manual_seed(4))
    outs = {}
    for name, k, device in (("card", key, "cuda"), ("cpu", key, "cpu"),
                            ("card float", key.split("+")[0], "cuda")):
        model = build_model(k, device, torch.float32)
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = model(clip.to(device), aud.to(device))
        outs[name] = out.cpu().double().flatten()
        log(tag, f"{k} fp32 forward on {device}: {time.perf_counter() - t0:.1f} s")
        del model
    float_need = 0.99 if OPTIONS[key].get("quant") == "int8" else 0.9999
    for other, need in (("cpu", 0.9999), ("card float", float_need)):
        a, b = outs["card"], outs[other]
        cc = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        log(tag, f"{key} log-density {RES[0]}x{RES[1]} card vs {other}: CC {cc:.8f} "
                 f"(need >= {need}), max abs diff {(a - b).abs().max().item():.3e}")
        if not cc >= need:
            raise AssertionError(f"card vs {other}: CC {cc} below {need}")


def phase_parity(tag: str, encoder: str) -> None:
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel

    cfg = get_config(encoder)
    frames, _ = synthetic_video(3)
    clip = torch.from_numpy(frames[None, :16].copy())
    aud = torch.randn(1, 257, 111, 1, generator=torch.Generator().manual_seed(4))
    outs = []
    for device in ("cuda", "cpu"):
        model = AudioVisualSaliencyModel(cfg, device=device, dtype=torch.float32,
                                         generator=torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = model(clip.to(device), aud.to(device))
        outs.append(out.cpu().double())
        log(tag, f"{encoder} fp32 forward on {device}: {time.perf_counter() - t0:.1f} s")
        del model
    a, b = (o.flatten() for o in outs)
    cc = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
    diff = (a - b).abs().max().item()
    log(tag, f"{encoder} log-density {RES[0]}x{RES[1]} card vs CPU: CC {cc:.8f} "
             f"(need >= 0.9999), max abs diff {diff:.3e}")
    if not cc >= 0.9999:
        raise AssertionError(f"end-to-end CC {cc} below 0.9999")


def _frozen_snapshot(model):
    from mspi_tpu_torch.train.engine import FROZEN_TOPLEVEL

    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.split(".", 1)[0] in FROZEN_TOPLEVEL}


def phase_training(tag: str, encoder: str) -> dict:
    """`encoder`: a PER_STEP key, a motion encoder and its options."""
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    cfg = model_config(encoder)
    model = AudioVisualSaliencyModel(cfg, device="cuda", dtype=torch.float32,
                                     generator=torch.Generator().manual_seed(0))
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg.train.gamma, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    batches = [engine.to_device(make_batch(rng, TRAIN_BATCH, 16, RES, SPECTRO), "cuda")
               for _ in range(STEPS)]
    frozen = _frozen_snapshot(model)
    before = [p.detach().clone() for p in engine.trainable_parameters(state)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    history, walls = [], []
    for batch in batches:
        t0 = time.perf_counter()
        history.append(step(state, batch, cfg.solver.lr))  # ends in a sync
        walls.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(walls[1:])
    log(tag, f"{encoder} {STEPS} steps bf16 batch {TRAIN_BATCH} {RES[0]}x{RES[1]}: first "
             f"{walls[0]:.2f} s, then median {steady * 1e3:.1f} ms = "
             f"{1 / steady:.3f} steps/s = {TRAIN_BATCH / steady:.2f} clips/s (host clock "
             f"around synced steps); peak memory {peak:.2f} GiB")
    for i, m in enumerate(history):
        log(tag, f"step {i}: " + " ".join(f"{k} {v:.5f}" for k, v in m.items()))
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in history):
        raise AssertionError("non-finite loss or gradient norm")
    for name in KERNELS:
        want = STEPS * PER_STEP[encoder].get(name, 0)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches in training, expected {want}")
    moved = sum(not torch.equal(a, p) for a, p in zip(before, engine.trainable_parameters(state)))
    log(tag, f"launches {counts}; {moved} of {len(before)} trainable tensors moved")
    if moved < len(before):
        raise AssertionError(f"only {moved} of {len(before)} trainable tensors changed")
    after = _frozen_snapshot(model)
    changed = [k for k in frozen if not torch.equal(frozen[k], after[k])]
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed[:5]}")
    log(tag, f"{len(frozen)} frozen tensors bit-identical")
    del model, state, batches
    torch.cuda.empty_cache()
    return counts


def phase_train_parity(tag: str, encoder: str) -> None:
    """`encoder`: a motion encoder, + its options."""
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    cfg = model_config(encoder)
    batch = make_batch(np.random.default_rng(6), TRAIN_BATCH, 16, RES, SPECTRO)
    results = []
    for device in ("cuda", "cpu"):
        model = AudioVisualSaliencyModel(cfg, device=device, dtype=torch.float32,
                                         generator=torch.Generator().manual_seed(0))
        state = engine.create_train_state(cfg, model, seed=9)
        step = engine.make_train_step(cfg.train.gamma)
        t0 = time.perf_counter()
        metrics = step(state, engine.to_device(batch, device), cfg.solver.lr)
        grads = torch.cat([p.grad.detach().double().flatten().cpu()
                           for p in engine.trainable_parameters(state)])
        log(tag, f"{encoder} fp32 step on {device}: {time.perf_counter() - t0:.1f} s; "
                 + " ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
        results.append((metrics, grads))
        del model, state
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    cos = (g_gpu @ g_cpu / (g_gpu.norm() * g_cpu.norm())).item()
    diffs = {k: abs(m_gpu[k] - m_cpu[k]) for k in m_cpu}
    log(tag, f"{encoder} {RES[0]}x{RES[1]} card vs CPU: gradient cosine {cos:.8f} "
             f"(need >= 0.9999); |diff| " + " ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    if not cos >= 0.9999:
        raise AssertionError(f"gradient cosine {cos} below 0.9999")
    for k in ("loss", "kl", "cc", "sim", "loss_va"):
        if not diffs[k] <= 1e-3 * max(1.0, abs(m_cpu[k])):
            raise AssertionError(f"{k}: card {m_gpu[k]} vs CPU {m_cpu[k]}")


# Entries the register-resident bodies must hold (mangled-name fragments):
# row 8's forward (kRelBiasRes = 3) in both rel forms, K4's (kNoBias = 0,
# D = 128), the bf16 window backward's three passes, the bf16 K1 backward's
# two passes in its three rel widths (RS = 2, 3, 4) and its wide form (R >
# 64), row 19 in both dtypes
# and tile widths, row 18's bf16 ring kernel in its two tiles (warp outputs
# OH x OW), and row 21's wgmma GEMMs (int8 at 64 and 128 rows per block)
SM90_ENTRIES = ("flash_attention_sm90_kernelILi96ELi3ELi3E",
                "flash_attention_sm90_kernelILi96ELi0ELi3E",
                "flash_attention_sm90_kernelILi128ELi0ELi0E", "window_bwd_dq_sm90_kernel",
                "window_bwd_dkv_sm90_kernel", "window_bwd_dbias_sm90_kernel",
                *(f"rel_bwd_{p}_sm90_kernelILi96ELi{rs}E" for p in ("dq", "dkv")
                  for rs in (2, 3, 4)),
                "rel_bwd_dq_wide_sm90_kernelILi96E", "rel_bwd_dkv_wide_sm90_kernelILi96E",
                *(f"dwconv2d_sm90_kernelI{t}Li{tw}E" for t in ("f", "13__nv_bfloat16")
                  for tw in (16, 32)),
                *(f"dwconv3d_sm90_kernelILi{oh}ELi{ow}E" for oh, ow in ((4, 8), (7, 6))),
                "gemm_bf16_sm90_kernel", "gemm_s8_sm90_kernelILi1E", "gemm_s8_sm90_kernelILi2E")


def check_ptxas() -> None:
    """The register-resident bodies (the sm90 flash forward of K1, K4, rows
    8 and 15, the bf16 window and K1 backwards' passes, rows 18 and 19 and
    the wgmma GEMMs): each instantiation's registers and spills as ptxas
    reported them; a spill fails the run, and so does a missing entry of
    SM90_ENTRIES or an instantiation of the WMMA body
    (`flash_attention_tc_kernel<DK, DV, BIAS>`) other than row 6's
    augmented lanes (bias mode 0, DK != DV)."""
    from mspi_tpu_torch.ops import kernels

    report = kernels.ptxas_report("sm90_kernel")
    missing = [e for e in SM90_ENTRIES if not any(e in name for name in report)]
    if missing:
        raise AssertionError(f"no ptxas entry for {missing}")
    for entry, (regs, st, ld) in sorted(report.items()):
        log("build", f"ptxas {entry}: {regs} registers, spill stores {st} B, loads {ld} B")
    spills = [entry for entry, (_, st, ld) in report.items() if st or ld]
    if spills:
        raise AssertionError(f"{sorted(spills)} spill registers")
    wmma = []
    for name in kernels.ptxas_report("flash_attention_tc_kernel"):
        dk, dv, bias = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", name).groups()
        if bias != "0" or dk == dv:
            wmma.append(name)
    if wmma:
        raise AssertionError(f"the WMMA body has instantiations other than row 6's: {wmma}")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES}")
    args = parser.parse_args()
    t_start = time.perf_counter()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this test "
                         "needs an NVIDIA GPU")
    from mspi_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    seconds = kernels.build()
    kernels.lib()
    log("build", f"nvcc sm_90a build of {len(list(kernels.CSRC_DIR.glob('*.cu')))} sources "
                 f"in {seconds:.1f} s -> {kernels.LIB_PATH.name}")
    check_ptxas()

    records = {name: new_record() for name in KERNELS}
    counts = {name: 0 for name in KERNELS}
    runners = {"main": phase_main_path, "parity": phase_parity, "training": phase_training,
               "train_parity": phase_train_parity, "options_parity": phase_options_parity}
    kernel_phases = {"kernels": phase_kernels, "backward": phase_backward,
                     "layout_kernels": phase_layout_kernels,
                     "layout_backward": phase_layout_backward}
    kernel_paths = {"mlp_kernels": phase_mlp_kernels, "lab": phase_lab}  # checks, then a path
    for phase in PHASES:
        if phase not in phases:
            continue
        if phase in kernel_phases:
            kernel_phases[phase](records)
        elif phase in kernel_paths:
            path_counts = kernel_paths[phase](records)
            counts = {k: counts[k] + path_counts[k] for k in KERNELS}
        else:
            path_kind, encoder = PATH_PHASES[phase]
            path_counts = runners[path_kind](phase, encoder)
            if path_counts is not None:  # a path: its launches count
                counts = {k: counts[k] + path_counts[k] for k in KERNELS}

    log("total", f"{time.perf_counter() - t_start:.1f} s since start, the build included")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name],
         **{k: v for k, v in records[name].items() if not k.startswith("_")}}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    if phases != set(PHASES):
        raise SystemExit(f"chip_smoke: ran only {sorted(phases)}; no device record")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
