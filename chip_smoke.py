"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the port's phases in order, one line each, and exits non-zero on the
first failure (there is no CPU path):

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: compiles every kernel in mspi_tpu_torch/csrc with nvcc (sm_90a);
3. kernels: each kernel against its plain PyTorch version at the flagship's
   shapes (batch 8), in fp32 and bf16, with CUDA-event times of both;
4. main path: `predict_video` of the bf16 MViTv2-S AudioVisualSaliencyModel
   at 224x384 (seeded random weights) on 31 synthetic frames and a 16 kHz
   waveform; checks the maps and each kernel's launch count;
5. parity: one window in fp32 on the card (kernels) against the CPU (plain
   versions), by the correlation of the log-density maps.

The last two lines are the kernels' JSON record and the device JSON record.
"""

from __future__ import annotations

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
}
# launches per forward of the flagship model
PER_FORWARD = {"attention_rel": 16, "ln_mlp": 23, "ln_mlp_prior": 18, "self_attention": 3}
BATCH = 8
RES = (224, 384)
N_FRAMES, FPS, SAMPLE_RATE = 31, 30.0, 16000


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


def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """fp32: 1e-4 relative to the output scale (only the summation order
    differs). bf16: three bf16 steps (2^-8 each) relative to the output
    scale -- inputs, the rounded intermediates and the output are bf16,
    the reference is fp32 on the same bf16-rounded inputs."""
    scale = max(1.0, ref.abs().max().item())
    return (1e-4 if dtype == torch.float32 else 3 * 2.0 ** -8) * scale


def check_kernel(records, name, label, kernel_fn, plain_fn, inputs, dtype):
    """Run one kernel at one shape against its plain version; record the
    error and both times."""
    xs = [t.to(dtype) for t in inputs]
    out = kernel_fn(*xs)
    torch.cuda.synchronize()
    ref = plain_fn(*(t.float() for t in xs))
    err = (out.float() - ref).abs().max().item()
    tol = tolerance(dtype, ref)
    ms = time_ms(lambda: kernel_fn(*xs))
    plain_ms = time_ms(lambda: plain_fn(*xs))
    ok = math.isfinite(err) and err <= tol
    log("kernels", f"{name} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {tol:.3e}) "
                   f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
    rec = records[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if dtype == torch.bfloat16:
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
    if not ok:
        raise AssertionError(f"{name} {label} {dtype}: error {err} above {tol}")


def phase_kernels(records) -> None:
    from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_prior, ln_mlp_reference
    from mspi_tpu_torch.ops.kernels.pooled_attention import (
        attention_rel, attention_rel_reference, self_attention, self_attention_reference)

    gen = torch.Generator().manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def mlp_inputs(M, C):
        H = 4 * C
        return [randn(M, C), 1 + randn(C, scale=0.1), randn(C, scale=0.1),
                randn(H, C, scale=C ** -0.5), randn(H, scale=0.1),
                randn(C, H, scale=H ** -0.5), randn(C, scale=0.1)]

    # K1: block 0, block 1, a stage-3 block (per clip: Nq, key grid, heads)
    for label, nq, k_shape, heads in (("blk0", 43008, (8, 7, 12), 1),
                                      ("blk1", 10752, (8, 14, 24), 2),
                                      ("blk4", 2688, (8, 7, 12), 4)):
        nk, r = math.prod(k_shape), sum(k_shape)
        inputs = [randn(BATCH, heads, nq, 96), randn(BATCH, heads, nk, 96),
                  randn(BATCH, heads, nk, 96), randn(BATCH, heads, nq, r)]
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(records, "attention_rel", label,
                         lambda q, k, v, rel, ks=k_shape: attention_rel(q, k, v, rel, ks, 96 ** -0.5),
                         lambda q, k, v, rel, ks=k_shape: attention_rel_reference(
                             q, k, v, rel, ks, 96 ** -0.5),
                         inputs, dtype)
    # K2: MViT stages (eps 1e-6), SyncBlock (1e-5), decoder level 0 (1e-5)
    for label, tokens, C, eps in (("mvit-s1", 43008, 96, 1e-6), ("mvit-s2", 10752, 192, 1e-6),
                                  ("mvit-s3", 2688, 384, 1e-6), ("mvit-s4", 672, 768, 1e-6),
                                  ("sync", 708, 512, 1e-5), ("decoder0", 21504, 192, 1e-5)):
        inputs = mlp_inputs(BATCH * tokens, C)
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(records, "ln_mlp", label,
                         lambda *a, e=eps: ln_mlp(*a, e),
                         lambda *a, e=eps: ln_mlp_reference(*a, e), inputs, dtype)
    # K3's call site: the prior's four stages, 16 frames per clip
    for label, tokens, C in (("prior-s0", 5376, 96), ("prior-s1", 1344, 192),
                             ("prior-s2", 336, 384), ("prior-s3", 84, 768)):
        inputs = mlp_inputs(BATCH * 16 * tokens, C)
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(records, "ln_mlp_prior", label,
                         lambda *a: ln_mlp_prior(*a, 1e-6),
                         lambda *a: ln_mlp_reference(*a, 1e-6), inputs, dtype)
    # K4: SyncBlock, N = 672 + 36
    inputs = [randn(BATCH, 708, 512), randn(BATCH, 708, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        check_kernel(records, "self_attention", "sync", lambda q, kv: self_attention(q, kv, 4),
                     lambda q, kv: self_attention_reference(q, kv, 4), inputs, dtype)


def synthetic_video(seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (N_FRAMES, *RES, 3), dtype=np.uint8)
    t = np.arange(int(2.5 * SAMPLE_RATE)) / SAMPLE_RATE
    audio = (0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 0.7 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    return frames, audio


def phase_main_path() -> dict:
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.inference import predict_video, sliding_window_jobs
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.ops import kernels

    cfg = get_config("mvitv2s")
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
    log("main", f"predict_video: {n_windows} windows in {forwards} forwards of {BATCH}, "
                f"{wall:.2f} s wall (first call), launches {counts}")

    if maps.shape != (N_FRAMES, 480, 640) or maps.dtype != np.uint8:
        raise AssertionError(f"maps {maps.shape} {maps.dtype}, expected "
                             f"({N_FRAMES}, 480, 640) uint8")
    flat = maps.reshape(N_FRAMES, -1)
    if not ((flat.min(axis=1) == 0).all() and (flat.max(axis=1) == 255).all()):
        raise AssertionError("a map is constant or not min-max normalised "
                             "(non-finite log-density)")
    for name, per in PER_FORWARD.items():
        if counts[name] != forwards * per:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{forwards} x {per}")

    clips = torch.from_numpy(np.stack([frames[i:i + 16] for i in range(BATCH)])).cuda()
    auds = torch.randn(BATCH, 257, 111, 1, generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        out, loss = model(clips, auds)
        if not (torch.isfinite(out).all() and torch.isfinite(loss)):
            raise AssertionError("non-finite model output")
        ms = time_ms(lambda: model(clips, auds), warmup=1, reps=3)
    log("main", f"forward bf16 batch {BATCH}: {ms:.1f} ms = {BATCH * 1000 / ms:.2f} clips/s "
                f"(CUDA events, median of 3); map {N_FRAMES} x 480 x 640 uint8 ok")
    del model
    torch.cuda.empty_cache()
    return counts


def phase_parity() -> None:
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel

    cfg = get_config("mvitv2s")
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
        log("parity", f"fp32 forward on {device}: {time.perf_counter() - t0:.1f} s")
        del model
    a, b = (o.flatten() for o in outs)
    cc = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
    diff = (a - b).abs().max().item()
    log("parity", f"log-density {RES[0]}x{RES[1]} card vs CPU: CC {cc:.8f} "
                  f"(need >= 0.9999), max abs diff {diff:.3e}")
    if not cc >= 0.9999:
        raise AssertionError(f"end-to-end CC {cc} below 0.9999")


def main() -> None:
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

    records = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in KERNELS}
    phase_kernels(records)
    counts = phase_main_path()
    phase_parity()

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **records[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
