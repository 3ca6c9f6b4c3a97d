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
   that computes the same function;
4. main path: `predict_video` of the bf16 MViTv2-S AudioVisualSaliencyModel
   at 224x384 (seeded random weights) on 31 synthetic frames and a 16 kHz
   waveform; checks the maps and each kernel's launch count;
5. parity: one window in fp32 on the card (kernels) against the CPU (plain
   versions), by the correlation of the log-density maps;
6. backward: each backward kernel against its plain version at the
   training shapes (batch 2) of both models, fp32 and bf16, with times;
7. training path: `make_train_step` on the MViTv2-S model at 224x384,
   batch 2, bf16 compute with fp32 weights, STEPS steps on synthetic
   batches; checks finite loss and gradient norm, trainable weights moved,
   frozen weights and statistics bit-identical, and the launch counts;
8. training parity: one fp32 step on the card against the same step on the
   CPU (plain versions) from the same weights, batch and drop-path draws:
   loss, each aux value and the cosine of the gradient vectors;
9-12. swin_main, swin_parity, swin_training, swin_train_parity: phases 4,
   5, 7 and 8 on the VideoSwin-S model.

Each path (4, 7, 9, 11) sets the launch counts to 0 just before it and
reads them just after; the kernels' record sums the four.
The last two lines are the kernels' JSON record and the device JSON record.
`--phases` runs a subset (2 always runs; the records then cover only what
ran and no device record is printed).
"""

from __future__ import annotations

import argparse
import json
import math
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
    "attention_rel_bwd": ("mspi_tpu_torch/csrc/attention_bwd.cu",
                          "mspi_tpu/ops/pallas/pooled_attention.py:385"),
    "attention_bwd": ("mspi_tpu_torch/csrc/attention_bwd.cu",
                      "mspi_tpu/ops/pallas/pooled_attention.py:172"),
    "ln_mlp_bwd": ("mspi_tpu_torch/csrc/ln_mlp_bwd.cu", "mspi_tpu/ops/pallas/mlp.py:445"),
    "window_attention": ("mspi_tpu_torch/csrc/window_attention.cu",
                         "mspi_tpu/ops/pallas/attention.py:423"),
    # rows 16 (:233, stages 1-2) and 17 (:332, stages 3-4): one kernel here
    "window_attention_bwd": ("mspi_tpu_torch/csrc/attention_bwd.cu",
                             "mspi_tpu/ops/pallas/attention.py:233"),
}
# launches per forward of each model (ln_mlp: backbone blocks + 3 SyncBlock
# + 4 decoder blocks; ln_mlp_prior: the ConvNeXt prior's 18 blocks)
PER_FORWARD = {
    "mvitv2s": {"attention_rel": 16, "ln_mlp": 23, "ln_mlp_prior": 18, "self_attention": 3},
    "videoswins": {"window_attention": 24, "ln_mlp": 31, "ln_mlp_prior": 18,
                   "self_attention": 3},
}
# launches per training step
PER_STEP = {
    "mvitv2s": {**PER_FORWARD["mvitv2s"], "attention_rel_bwd": 16, "ln_mlp_bwd": 23,
                "attention_bwd": 3},
    "videoswins": {**PER_FORWARD["videoswins"], "window_attention_bwd": 24, "ln_mlp_bwd": 31,
                   "attention_bwd": 3},
}
PATH_PHASES = {  # phase -> (path kind, motion encoder)
    "main": ("main", "mvitv2s"), "parity": ("parity", "mvitv2s"),
    "training": ("training", "mvitv2s"), "train_parity": ("train_parity", "mvitv2s"),
    "swin_main": ("main", "videoswins"), "swin_parity": ("parity", "videoswins"),
    "swin_training": ("training", "videoswins"),
    "swin_train_parity": ("train_parity", "videoswins"),
}
PHASES = ("kernels", "main", "parity", "backward", "training", "train_parity", "swin_main",
          "swin_parity", "swin_training", "swin_train_parity")
BATCH = 8
TRAIN_BATCH = 2
STEPS = 5
RES = (224, 384)
SPECTRO = (257, 111)
N_FRAMES, FPS, SAMPLE_RATE = 31, 30.0, 16000
# published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def add_bound(rec, dtype, n_bytes: float, flops: float) -> None:
    """The least time of the work on the card: the larger of its bytes (each
    input read once, each output written once) over HBM's rate and its
    flops over the dtype's peak. Recorded for the bf16 runs, whose times
    the record sums."""
    if dtype != torch.bfloat16:
        return
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec["bound_ms"] += max(t_bytes, t_ops)
    rec["_bytes_ms"] += t_bytes
    rec["_ops_ms"] += t_ops
    rec["bound_by"] = "bytes" if rec["_bytes_ms"] > rec["_ops_ms"] else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(records, name, label, dtype, errs_tols, ms, plain_ms, library_ms=None):
    err = max(e for e, _ in errs_tols)
    ok = all(math.isfinite(e) and e <= t for e, t in errs_tols)
    worst = max(e / t for e, t in errs_tols)  # each output against its own tolerance
    lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
    log("kernels", f"{name} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                   f"(worst err/tol {worst:.3f}) "
                   f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms{lib} {'ok' if ok else 'FAIL'}")
    rec = records[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if dtype == torch.bfloat16:
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        if library_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + library_ms
    if not ok:
        raise AssertionError(f"{name} {label} {dtype}: error {err} above tolerance")


def check_kernel(records, name, label, kernel_fn, plain_fn, inputs, dtype, library_fn=None):
    """Run one forward kernel at one shape against its plain version; record
    the error and the times."""
    xs = [t.to(dtype) for t in inputs]
    out = kernel_fn(*xs)
    torch.cuda.synchronize()
    ref = plain_fn(*(t.float() for t in xs))
    err = (out.float() - ref).abs().max().item()
    ms = time_ms(lambda: kernel_fn(*xs))
    plain_ms = time_ms(lambda: plain_fn(*xs))
    lib_ms = None
    if library_fn is not None and dtype == torch.bfloat16:
        with torch.no_grad():
            lib_ms = time_ms(library_fn(*xs))
    record(records, name, label, dtype, [(err, tolerance(dtype, ref))], ms, plain_ms, lib_ms)
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


# K1 shapes per clip: label, Nq, key grid, heads (D = 96)
ATTN_REL_SHAPES = (("blk0", 43008, (8, 7, 12), 1), ("blk1", 10752, (8, 14, 24), 2),
                   ("blk4", 2688, (8, 7, 12), 4))
# K2 shapes per clip: label, tokens, C, eps
LN_MLP_SHAPES = (("mvit-s1", 43008, 96, 1e-6), ("mvit-s2", 10752, 192, 1e-6),
                 ("mvit-s3", 2688, 384, 1e-6), ("mvit-s4", 672, 768, 1e-6),
                 ("sync", 708, 512, 1e-5), ("decoder0", 21504, 192, 1e-5))


# VideoSwin-S window attention per clip (N = 8*7*7 = 392, D = 32): label,
# windows per clip, heads, C, and the shift mask's padded grid and shift
# (None: an unshifted block, no mask)
SWIN_SHAPES = (("s1-shift", 112, 3, 96, (8, 56, 98), (0, 3, 3)),
               ("s2", 28, 6, 192, None, None),
               ("s3-shift", 8, 12, 384, (8, 14, 28), (0, 3, 3)),
               ("s4-shift", 2, 24, 768, (8, 7, 14), (0, 0, 3)))
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
        attention_rel, attention_rel_reference, self_attention, self_attention_reference)

    randn = randn_on(torch.Generator().manual_seed(1))
    for label, nq, k_shape, heads in ATTN_REL_SHAPES:
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
                inputs, dtype, library)
            add_bound(records["attention_rel"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * heads * nq * nk * 96)
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
    # row 15: the four VideoSwin stages, shifted blocks with their mask
    from mspi_tpu_torch.ops.kernels.window_attention import (window_attention,
                                                             window_attention_reference)

    for label, nw, heads, C, grid, shift in SWIN_SHAPES:
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
                inputs, dtype, library)
            add_bound(records["window_attention"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * nw * heads * SWIN_N * SWIN_N * SWIN_D)
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
    for label, nq, k_shape, heads in ATTN_REL_SHAPES:
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
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.attention_rel_backward_reference(
                q, k, v, rel, k_shape, scale, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                mask = rel_mask(rel, k_shape)
                lib_ms = time_ms(library_grad(lambda *a: sdpa(*a, scale), (q, k, v, mask), dout))
                del mask
            record(records, "attention_rel_bwd", label, dtype, errs, ms, plain_ms, lib_ms)
            add_bound(rec, dtype, nbytes(q, k, v, rel, out, lse, dout, *got),
                      10.0 * B * heads * nq * nk * 96)
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
    # rows 16/17: the window backward at the four VideoSwin stages
    from mspi_tpu_torch.ops.kernels import window_attention as WA

    for label, nw, heads, C, grid, shift in SWIN_SHAPES:
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
            record(records, "window_attention_bwd", label, dtype, errs, ms, plain_ms, lib_ms)
            add_bound(records["window_attention_bwd"], dtype,
                      nbytes(qkv, bias, *(() if mask is None else (mask,)), out, lse, dout,
                             *got),
                      10.0 * B * nw * heads * SWIN_N * SWIN_N * SWIN_D)
            del got, want, out, lse


def synthetic_video(seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (N_FRAMES, *RES, 3), dtype=np.uint8)
    t = np.arange(int(2.5 * SAMPLE_RATE)) / SAMPLE_RATE
    audio = (0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 0.7 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    return frames, audio


def phase_main_path(tag: str, encoder: str) -> dict:
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.inference import predict_video, sliding_window_jobs
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.ops import kernels

    cfg = get_config(encoder)
    model = AudioVisualSaliencyModel(cfg, device="cuda", dtype=torch.bfloat16,
                                     generator=torch.Generator().manual_seed(0))
    frames, audio = synthetic_video(0)
    n_windows = len(sliding_window_jobs(N_FRAMES, 16))
    forwards = -(-n_windows // BATCH)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    maps = predict_video(model, frames, audio, FPS, window_batch=BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    log(tag, f"{encoder} predict_video: {n_windows} windows in {forwards} forwards of "
             f"{BATCH}, {wall:.2f} s wall (first call), launches {counts}")

    if maps.shape != (N_FRAMES, 480, 640) or maps.dtype != np.uint8:
        raise AssertionError(f"maps {maps.shape} {maps.dtype}, expected "
                             f"({N_FRAMES}, 480, 640) uint8")
    flat = maps.reshape(N_FRAMES, -1)
    if not ((flat.min(axis=1) == 0).all() and (flat.max(axis=1) == 255).all()):
        raise AssertionError("a map is constant or not min-max normalised "
                             "(non-finite log-density)")
    for name in KERNELS:
        want = forwards * PER_FORWARD[encoder].get(name, 0)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")

    clips = torch.from_numpy(np.stack([frames[i:i + 16] for i in range(BATCH)])).cuda()
    auds = torch.randn(BATCH, 257, 111, 1, generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        out, loss = model(clips, auds)
        if not (torch.isfinite(out).all() and torch.isfinite(loss)):
            raise AssertionError("non-finite model output")
        ms = time_ms(lambda: model(clips, auds), warmup=1, reps=3)
    log(tag, f"{encoder} forward bf16 batch {BATCH}: {ms:.1f} ms = "
             f"{BATCH * 1000 / ms:.2f} clips/s (CUDA events, median of 3); "
             f"map {N_FRAMES} x 480 x 640 uint8 ok")
    del model
    torch.cuda.empty_cache()
    return counts


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
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    cfg = get_config(encoder)
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
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    cfg = get_config(encoder)
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


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES}")
    args = parser.parse_args()
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

    records = {name: new_record() for name in KERNELS}
    counts = {name: 0 for name in KERNELS}
    runners = {"main": phase_main_path, "parity": phase_parity, "training": phase_training,
               "train_parity": phase_train_parity}
    for phase in PHASES:
        if phase not in phases:
            continue
        if phase == "kernels":
            phase_kernels(records)
        elif phase == "backward":
            phase_backward(records)
        else:
            path_kind, encoder = PATH_PHASES[phase]
            path_counts = runners[path_kind](phase, encoder)
            if path_counts is not None:  # a path: its launches count
                counts = {k: counts[k] + path_counts[k] for k in KERNELS}

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
