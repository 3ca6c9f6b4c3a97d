"""A syntax and template check of the port's CUDA sources without nvcc.

Each `mspi_tpu_torch/csrc/*.cu` is compiled by the host C++ compiler with
`-std=c++17 -fsyntax-only` against small stub headers for `cuda_runtime.h`,
`cuda_bf16.h`, `mma.h` and `cuda.h` (macros for `__global__` and the other
CUDA qualifiers, declarations of the intrinsics and types the sources use,
`cuda.h`'s tensor-map types for the TMA kernels), after
two rewrites of a copy of the sources: the `<<<...>>>` launch configurations
are stripped, so a launch reads as a call, and `asm volatile(` becomes a
variadic no-op macro. Every template instantiation a source makes is
checked, so template and syntax errors in a header show here, not in the
first build on the card; what the CUDA compiler alone knows (inline PTX,
register use) is not checked.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import pytest

from tests.torch_port_utils import cpu_share

CSRC = Path(__file__).resolve().parents[1] / "mspi_tpu_torch" / "csrc"
SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

CUDA_RUNTIME = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __constant__
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __grid_constant__
#define CUDART_VERSION 12080
#define __align__(n) __attribute__((aligned(n)))
#define MSPI_ASM(...) ((void)0)
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
struct uint4 { unsigned x, y, z, w; };
struct char4 { signed char x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
enum cudaError { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716,
                 cudaErrorNotSupported = 801 };
typedef enum cudaError cudaError_t;
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int);
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t);
cudaError_t cudaGetLastError();
cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t = 0);
const char* cudaGetErrorString(cudaError_t);
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0,
                                       cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
cudaError_t cudaGetDriverEntryPoint(const char*, void**, unsigned long long,
                                    cudaDriverEntryPointQueryResult* = 0);
cudaError_t cudaGetDriverEntryPointByVersion(const char*, void**, unsigned int,
                                             unsigned long long,
                                             cudaDriverEntryPointQueryResult* = 0);
void __syncthreads();
void __syncwarp(unsigned = 0xffffffffu);
int __any_sync(unsigned, int);
template <typename T> T __shfl_xor_sync(unsigned, T, int, int = 32);
template <typename T> T __shfl_sync(unsigned, T, int, int = 32);
template <typename T> T __shfl_down_sync(unsigned, T, unsigned, int = 32);
template <typename T> T __ldg(const T*);
template <typename T> T atomicAdd(T*, T);
size_t __cvta_generic_to_shared(const void*);
float __fmul_rn(float, float);
float __fadd_rn(float, float);
float __fsub_rn(float, float);
float __fdiv_rn(float, float);
float __fmaf_rn(float, float, float);
float __int2float_rn(int);
int __float2int_rn(float);
float __expf(float);
float __logf(float);
float rsqrtf(float);
float __frcp_rn(float);
int __dp4a(int, int, int);
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
"""

CUDA_BF16 = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
__nv_bfloat16 __float2bfloat16(float);
__nv_bfloat16 __float2bfloat16_rn(float);
float __bfloat162float(__nv_bfloat16);
__nv_bfloat162 __floats2bfloat162_rn(float, float);
float __low2float(__nv_bfloat162);
float __high2float(__nv_bfloat162);
float2 __bfloat1622float2(__nv_bfloat162);
"""

MMA = r"""
#pragma once
#include "cuda_runtime.h"
namespace nvcuda {
namespace wmma {
struct row_major;
struct col_major;
struct matrix_a;
struct matrix_b;
struct accumulator;
namespace precision { struct tf32; }
enum layout_t { mem_row_major, mem_col_major };
template <typename Use, int M, int N, int K, typename T, typename Layout = void>
struct fragment {
  static constexpr int num_elements = 8;
  T x[8];
};
template <typename F, typename T> void fill_fragment(F&, const T&);
template <typename F, typename T> void load_matrix_sync(F&, const T*, unsigned);
template <typename F, typename T> void load_matrix_sync(F&, const T*, unsigned, layout_t);
template <typename D, typename A, typename B, typename C>
void mma_sync(D&, const A&, const B&, const C&, bool = false);
template <typename T, typename F> void store_matrix_sync(T*, const F&, unsigned, layout_t);
}  // namespace wmma
}  // namespace nvcuda
"""

CUDA_DRIVER = r"""
#pragma once
#include <stdint.h>
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
enum CUresult { CUDA_SUCCESS = 0 };
struct alignas(64) CUtensorMap { unsigned long long opaque[16]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0,
                           CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
"""

STUBS = {"cuda_runtime.h": CUDA_RUNTIME, "cuda_bf16.h": CUDA_BF16, "mma.h": MMA,
         "cuda.h": CUDA_DRIVER}


def _rewrite(text: str) -> str:
    """Launches as calls, inline PTX as a no-op."""
    text = re.sub(r"<<<.*?>>>", "", text, flags=re.S)
    return text.replace("asm volatile(", "MSPI_ASM(")


@pytest.fixture(scope="module")
def stub_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("csrc_stub")
    (root / "stubs").mkdir()
    for name, text in STUBS.items():
        (root / "stubs" / name).write_text(text)
    (root / "src").mkdir()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            (root / "src" / p.name).write_text(_rewrite(p.read_text()))
    return root


def test_sources_found():
    """The parametrisation below saw the port's sources, the register-resident
    bodies' launchers and headers among them."""
    assert {"attention_rel.cu", "window_attention.cu", "self_attention.cu",
            "gemm_lab.cu", "attention_rel_bwd_sm90.cu", "dwconv2d.cu"} <= set(SOURCES)
    assert (CSRC / "flash_attention_sm90.cuh").exists()
    assert (CSRC / "attention_bwd_sm90.cuh").exists()
    assert (CSRC / "sm90_wgmma.cuh").exists()


def _check(stub_tree, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    res = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-x", "c++", "-w",
         "-I", str(stub_tree / "stubs"), "-I", str(stub_tree / "src"),
         str(stub_tree / "src" / source)],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, f"{source}:\n{res.stderr[-4000:]}"


@pytest.mark.parametrize("source", SOURCES)
def test_csrc_syntax(stub_tree, source):
    _check(stub_tree, source)
