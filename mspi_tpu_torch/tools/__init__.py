"""The port's tools. `python -m mspi_tpu_torch.tools.demo_net` (the saliency
demo over a frame directory) and `tools.visualize` (Grad-CAM of a zoo
classifier) are the counterparts of the repository's `tools/demo_net.py`
and `tools/visualize.py`. The kernel labs, `python -m
mspi_tpu_torch.tools.bench_dwconv`, `bench_lnmlp` and `bench_int8`, are the
counterparts of the JAX package's `tools/bench_*.py`, with their variant
names and environment.

Each lab runs on a CUDA card and raises without one, unless `--device cpu`
asks for the plain versions (the tests run them so; nothing is timed
there). On the card each variant is run, compared with its plain version
(in fp32 on the same rounded inputs, or in the kernel's own integers), and
timed: warm-up, then CUDA events around single calls, the median of
MSPI_LAB_ITERS repeats. Each line gives the kernel's ms, its rate, the
share of its bound that it reaches (the bound: the larger of its bytes,
each input read once and each output written once, over the H100's
3.35 TB/s, and its operations over the peak of their type) and max|err|.
The first line is `nvidia-smi`'s name and power limit of the card.

This module holds what the three labs share.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

# published H100 SXM peaks (dense): HBM3, bf16 and int8 tensor cores, fp32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def iters() -> int:
    return int(os.environ.get("MSPI_LAB_ITERS", "50"))


def parse_args(argv, doc: str, names: Sequence[str], what: str = "variant",
               extra: Optional[Callable[[argparse.ArgumentParser], None]] = None):
    """The labs' command line: a subset of `names` (default all) and
    --device; `extra` adds a lab's own options."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("names", nargs="*", metavar=what, help=f"subset of {list(names)} (default all)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu runs the plain versions and times nothing")
    if extra is not None:
        extra(p)
    args = p.parse_args(argv)
    unknown = [n for n in args.names if n not in names]
    if unknown:
        p.error(f"unknown {what} {unknown}; have {list(names)}")
    args.names = args.names or list(names)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the lab times kernels on a CUDA card; none is available "
                           "(--device cpu runs the plain versions)")
    return args


def device_line(device: str) -> None:
    """The card's name and power limit as nvidia-smi gives them."""
    if device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0], flush=True)
    else:
        print("cpu: plain versions only, nothing timed", flush=True)


def time_ms(fn: Callable[[], object], reps: int, warmup: int = 3) -> float:
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_tolerance(ref: torch.Tensor) -> float:
    """Three bf16 steps (2^-8 each) of the output scale max(1, max|ref|), the
    reference in fp32 on the same bf16-rounded inputs."""
    return 3 * 2.0 ** -8 * max(1.0, ref.abs().max().item())


@dataclass
class Result:
    """One variant of a lab: `kernel` is its launch-count key (None for a
    library call), `ok` whether its error is within `tol` (None where it is
    not held to one)."""
    variant: str
    kernel: Optional[str]
    max_abs_err: float
    tol: Optional[float]
    ok: Optional[bool]
    bound_ms: float
    bound_by: str
    ops: float
    unit: str
    ms: Optional[float] = None
    plain_ms: Optional[float] = None
    library_ms: Optional[float] = None


def bound(n_bytes: float, ops: float, peak: str):
    """(bound ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def report(r: Result) -> None:
    tol = "" if r.tol is None else f" (tol {r.tol:.2e}) {'ok' if r.ok else 'FAIL'}"
    if r.ms is None:
        timing = "ms not measured (cpu)"
    else:
        timing = (f"{r.ms:8.3f} ms {r.ops / r.ms * 1e-9:8.2f} {r.unit} "
                  f"{100 * r.bound_ms / r.ms:5.1f}% of its bound ({r.bound_by} "
                  f"{r.bound_ms:.3f} ms)")
        if r.plain_ms is not None:
            timing += f" plain {r.plain_ms:.3f} ms"
        if r.library_ms is not None:
            timing += f" library {r.library_ms:.3f} ms"
    print(f"{r.variant:12s} {timing}  max|err| {r.max_abs_err:.3e}{tol}", flush=True)


def check(results: List[Result]) -> List[Result]:
    failed = [r.variant for r in results if r.ok is False]
    if failed:
        raise AssertionError(f"error above tolerance: {failed}")
    return results
