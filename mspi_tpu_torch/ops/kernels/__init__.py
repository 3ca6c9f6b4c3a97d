"""Hand-written Hopper kernels: build, load, dispatch rule and launch counts.

Counterpart of `mspi_tpu/ops/pallas/`. Every CUDA source under
`mspi_tpu_torch/csrc/*.cu` is compiled for `sm_90a` by its own `nvcc`
process, all started together, and the objects are linked into
`build/mspi_tpu_torch/libmspi_kernels.so` at the repository root, at the
first CUDA launch (or by an explicit `build()`), and loaded with ctypes. The
library has a plain C interface: pointers from `tensor.data_ptr()`, PyTorch's
current stream, scalars as C ints and floats; each entry returns a
`cudaError_t` that the wrapper turns into an exception.

Dispatch rule of every public kernel function (`dispatch_device`): CUDA
tensors launch the kernel or raise; CPU tensors run the plain PyTorch version
that sits beside the kernel in the same module; any other device raises.
There is no switch and no fallback.

`launches` counts the kernel launches of each wrapper; a run resets it with
`reset_launch_counts()` and reads it afterwards to show which kernels its
path went through.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mspi_tpu_torch"
LIB_PATH = BUILD_DIR / "libmspi_kernels.so"
# -Xptxas=-v: each kernel's registers and spills into BUILD_DIR/nvcc.log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches: Dict[str, int] = {"attention_rel": 0, "ln_mlp": 0, "ln_mlp_prior": 0,
                            "self_attention": 0, "attention_rel_bwd": 0,
                            "attention_bwd": 0, "ln_mlp_bwd": 0, "window_attention": 0,
                            "window_attention_bwd": 0, "ln_mlp_int8": 0,
                            "ln_mlp_prior_res": 0, "layernorm_tokens": 0, "attention": 0,
                            "attention_rel_packed": 0, "dwconv3d": 0, "mlp": 0, "mlp_bwd": 0,
                            "dwconv2d": 0, "lab_matmul": 0, "lab_matmul_gelu": 0,
                            "lab_ln_matmul": 0, "lab_pipe2": 0, "lab_pipe4": 0,
                            "lab_mxu_stats": 0, "gemm_bf16": 0, "gemm_int8": 0, "mlp_bf16": 0,
                            "mlp_int8w": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # name: argtypes (all entries return int cudaError_t)
    "mspi_ln_mlp": [_P] * 10 + [_I, _I, _I, _F, _I, _P],
    "mspi_ln_mlp_int8": [_P] * 10 + [_I, _I, _I, _F, _I, _P],
    "mspi_layernorm": [_P] * 4 + [_I, _I, _F, _I, _P],
    "mspi_attention_rel": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _F, _I, _P],
    "mspi_self_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mspi_ln_mlp_bwd": [_P] * 16 + [_I, _I, _I, _F, _I, _I, _I, _P],
    "mspi_ln_mlp_bwd_rows": [_I, _I],
    "mspi_attention_rel_bwd": [_P] * 15 + [_I] * 10 + [_F, _I, _P],
    "mspi_self_attention_bwd": [_P] * 10 + [_I] * 6 + [_P],
    "mspi_window_attention": [_P] * 5 + [_I] * 6 + [_P],
    "mspi_window_attention_bwd": [_P] * 12 + [_I] * 7 + [_P],
    "mspi_attention": [_P] * 6 + [_I] * 7 + [_P],
    "mspi_attention_bwd": [_P] * 13 + [_I] * 8 + [_P],
    "mspi_attention_rel_packed": [_P] * 6 + [_I] * 9 + [_F, _I, _I, _P],
    "mspi_dwconv3d": [_P] * 3 + [_I] * 8 + [_P],
    "mspi_mlp": [_P] * 6 + [_I] * 4 + [_P],
    "mspi_mlp_bwd": [_P] * 13 + [_I] * 6 + [_P],
    "mspi_dwconv2d": [_P] * 4 + [_I] * 5 + [_P],
    "mspi_ln_mlp_lab": [_P] * 8 + [_I, _I, _I, _F, _I, _P],
    "mspi_mlp_int8_lab": [_P] * 6 + [_I] * 3 + [_P],
    "mspi_gemm_lab": [_P] * 4 + [_I] * 5 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the kernels build only where the "
                           "CUDA toolkit is installed")
    return nvcc


def build() -> float:
    """Compile every csrc/*.cu (one nvcc process per source, in parallel)
    and link LIB_PATH; returns the build's wall seconds. nvcc's output goes
    to BUILD_DIR/nvcc.log; a failed step raises with it. A library that is
    already loaded in this process stays loaded."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    failed, logs = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {obj.stem}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(f"{obj.stem}.cu: nvcc exit {proc.returncode}\n{out}")
    (BUILD_DIR / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = LIB_PATH.with_name(LIB_PATH.name + ".tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n"
                           f"{link.stdout}\n{link.stderr}")
    tmp.replace(LIB_PATH)
    return time.perf_counter() - t0


def ptxas_report(key: str) -> Dict[str, tuple]:
    """From the last build's nvcc.log: {mangled entry: (registers, spill
    store bytes, spill load bytes)} of each kernel whose name holds `key`."""
    report, entry = {}, None
    for line in (BUILD_DIR / "nvcc.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if key in m.group(1) else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[entry] = (0, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in report:
            report[entry] = (int(m.group(1)),) + report[entry][1:]
            entry = None
    return report


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC_DIR.iterdir())
    return LIB_PATH.stat().st_mtime < newest


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or older than csrc/."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        handle = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.mspi_error_string.argtypes = [ctypes.c_int]
        handle.mspi_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib().mspi_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer for a nullable C argument."""
    return None if t is None else t.data_ptr()


def num_sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def cast_for_autocast(*tensors: torch.Tensor):
    """Under CUDA autocast, every floating operand in the autocast dtype
    (torch.bfloat16 in training): the kernel wrappers take one dtype, and
    autocast leaves LayerNorm outputs and residual sums in fp32. The casts
    are ordinary autograd ops, so fp32 parameters get fp32 gradients.
    Without autocast the operands pass through unchanged."""
    if tensors[0].device.type != "cuda" or not torch.is_autocast_enabled("cuda"):
        return tensors
    dt = torch.get_autocast_dtype("cuda")
    return tuple(t.to(dt) if t.is_floating_point() else t for t in tensors)


def dispatch_device(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True when every tensor lies on one CUDA device
    (launch the kernel), False when every tensor lies on the CPU (run the
    plain version); raise on anything else, including a mix."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel operands lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {dev}")


def check_operands(name: str, *tensors: torch.Tensor) -> int:
    """Check what every kernel needs of its operands; returns the dtype code."""
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (fp32 or bf16)")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is "
                             "not contiguous")
    return DTYPE_CODES[dtype]
