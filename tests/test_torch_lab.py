"""The port's kernel-lab kernels (TPU rows 19-21) against the JAX package's
lab bodies (`tools/bench_dwconv.py`, `bench_lnmlp.py`, `bench_int8.py`),
run as they are in interpret mode on the CPU, where the port's functions
run their plain versions.

The JAX labs call `pl.pallas_call` for the TPU; each test replaces the lab
module's `pl` by a shim whose `pallas_call` passes interpret=True and which
forwards every other name to `pl`. Tolerances: fp32 atol 1e-5 for rows
19-20 and the bf16 bodies of row 21 run in fp32 (the TPU's GELU is a
degree-16 fit of erf within 2e-7 of the port's exact erf; sums run in
another order); exact for the int8 GEMM; row 12's int8 rule for mlp_int8w
(relative RMS error <= 1e-3, max error <= 0.02 x max|ref|: a code may flip
where a product rounds across a boundary in another order). Each port lab
CLI runs once with --device cpu at a tiny size, its variant names checked
against the JAX lab's.
"""

import functools
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import lab
from mspi_tpu_torch.ops.kernels.dwconv import dwconv2d
from mspi_tpu_torch.tools import bench_dwconv, bench_int8, bench_lnmlp
from tests.torch_port_utils import cpu_share
from tools import bench_dwconv as jax_dwconv
from tools import bench_int8 as jax_int8
from tools import bench_lnmlp as jax_lnmlp

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


class _InterpretPallas:
    """`pl` with pallas_call in interpret mode."""
    pallas_call = functools.partial(pl.pallas_call, interpret=True)

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    for mod in (jax_dwconv, jax_lnmlp, jax_int8):
        monkeypatch.setattr(mod, "pl", _InterpretPallas())
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


def _f32(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_dwconv2d_matches_pallas_lab(rng):
    x, k, b = _f32(rng, 2, 9, 11, 8), _f32(rng, 7, 7, 8, scale=0.1), _f32(rng, 8, scale=0.1)
    want = jax_dwconv.pallas_dwconv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = dwconv2d(_t(x), _t(k), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N,H,W,C", [(2, 13, 41, 40), (1, 11, 19, 3), (1, 9, 64, 1)])
def test_dwconv2d_ragged_matches_pallas_lab(rng, N, H, W, C):
    """Row 19's ragged edges, as chip_smoke.py holds the kernel there: H and W
    off its 8 x 16 and 8 x 32 tiles, C off its 32-channel group and (C = 3,
    1) off the 16-byte vector, which the kernel takes by element loads."""
    x, k, b = _f32(rng, N, H, W, C), _f32(rng, 7, 7, C, scale=0.1), _f32(rng, C, scale=0.1)
    want = jax_dwconv.pallas_dwconv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = dwconv2d(_t(x), _t(k), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


_BODIES = {"matmul": jax_lnmlp._k_matmul, "matmul_gelu": jax_lnmlp._k_matmul_gelu,
           "ln_matmul": jax_lnmlp._k_ln_matmul,
           "pipe2": functools.partial(jax_lnmlp._k_pipe, k=2),
           "pipe4": functools.partial(jax_lnmlp._k_pipe, k=4),
           "mxu_stats": jax_lnmlp._k_mxu_stats}


@pytest.mark.parametrize("variant", lab.LAB_VARIANTS)
def test_lnmlp_lab_body_matches_pallas(rng, variant):
    B, N, C, H = 2, 64, 16, 64
    x = _f32(rng, B, N, C)
    g, be = _f32(rng, C, scale=0.1, shift=1.0), _f32(rng, C, scale=0.1)
    w1, b1 = _f32(rng, C, H, scale=0.2), _f32(rng, H, scale=0.1)
    w2, b2 = _f32(rng, H, C, scale=0.2), _f32(rng, C, scale=0.1)
    want = jax_lnmlp._call(_BODIES[variant], *map(jnp.asarray, (x, g, be, w1, b1, w2, b2)), 32)
    got = lab.ln_mlp_lab(_t(x), _t(g), _t(be), _t(w1.T), _t(b1), _t(w2.T), _t(b2), variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# the square case, and a non-square one whose K spans three 64-deep k tiles
@pytest.mark.parametrize("dtype,M,K,N", [
    (np.float32, 64, 64, 64), (np.int8, 64, 64, 64),
    (np.float32, 256, 192, 384), (np.int8, 256, 192, 384)],
    ids=["float32", "int8", "float32-256x192x384", "int8-256x192x384"])
def test_gemm_matches_pallas_lab(rng, dtype, M, K, N):
    if dtype == np.int8:  # the s32 sums leave the int8 range: the wrap-around is tested
        a, b = (rng.integers(-127, 128, s).astype(np.int8) for s in ((M, K), (K, N)))
    else:
        a, b = _f32(rng, M, K), _f32(rng, K, N)
    want = np.asarray(jax_int8._gemm(jnp.asarray(a), jnp.asarray(b), jnp.dtype(dtype)))
    got = lab.gemm(_t(a), _t(b)).numpy()
    assert got.shape == (M, N) and got.dtype == want.dtype
    if dtype == np.int8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("G,sms,block_m", [(1024, 132, 64), (4096, 132, 128), (2048, 132, 128),
                                            (1536, 132, 128), (1408, 132, 64)])
def test_gemm_int8_block_m(G, sms, block_m):
    """The int8 GEMM's tile rows: 128 once 128 x 128 tiles fill the SMs
    (G / 128 squared >= 132 on the H100), else 64 (128 blocks at the lab's
    1024^3)."""
    assert lab.gemm_int8_block_m(G, G, sms) == block_m


def _mlp_operands(rng, B=2, N=64, C=32, H=128):
    return _f32(rng, B, N, C), _f32(rng, C, H, scale=0.1), _f32(rng, H, C, scale=0.1)


def test_mlp_bf16_body_matches_pallas(rng):
    x, w1, w2 = _mlp_operands(rng)
    want = jax_int8._mlp_call(jax_int8._mlp_bf16_kernel, jnp.asarray(x),
                              [jnp.asarray(w1), jnp.asarray(w2)], 32)
    got = lab.mlp_bf16(_t(x), _t(w1.T), _t(w2.T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_quantize_weight_lab_matches_the_lab_host_code(rng):
    """The JAX lab quantises the [in, out] kernel per column on the host
    (`main`); the port the [out, in] weight per row."""
    w = _f32(rng, 32, 128, scale=0.1)
    s = np.abs(w).max(0, keepdims=True) / 127.0
    q = np.round(w / s).astype(np.int8)
    got_q, got_s = lab.quantize_weight_lab(_t(w.T))
    np.testing.assert_array_equal(got_q.numpy(), q.T)
    np.testing.assert_array_equal(got_s.numpy(), s[0])


def test_mlp_int8w_body_matches_pallas(rng):
    x, w1, w2 = _mlp_operands(rng)
    (w1q, s1), (w2q, s2) = lab.quantize_weight_lab(_t(w1.T)), lab.quantize_weight_lab(_t(w2.T))
    jax_w = [jnp.asarray(w1q.numpy().T), jnp.asarray(s1.numpy()[None]),
             jnp.asarray(w2q.numpy().T), jnp.asarray(s2.numpy()[None])]
    want = np.asarray(jax_int8._mlp_call(jax_int8._mlp_int8w_kernel, jnp.asarray(x), jax_w, 32),
                      np.float64)
    got = lab.mlp_int8w(_t(x), w1q, s1, w2q, s2).double().numpy()
    assert np.sqrt(np.mean((got - want) ** 2)) <= 1e-3 * np.sqrt(np.mean(want ** 2))
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def _jax_variant_names(mod):
    """The variant names of a JAX lab, read from its `main`."""
    src = inspect.getsource(mod.main)
    if mod is jax_dwconv:
        return set(re.findall(r'\("(\w+)", ', src))
    return set(re.findall(r'^\s+"(\w+)": ', src, re.M))


@pytest.mark.parametrize("port, jax_mod, argv, env", [
    (bench_dwconv, jax_dwconv, ["s3", "--batch", "1"], {}),
    (bench_lnmlp, jax_lnmlp, [], {"MSPI_LAB_SHAPE": "1,16,96,128"}),
    (bench_int8, jax_int8, [], {"MSPI_LAB_SHAPE": "1,16,96,128", "MSPI_LAB_GEMM": "128"}),
], ids=["dwconv", "lnmlp", "int8"])
def test_lab_cli_on_cpu(port, jax_mod, argv, env, monkeypatch, capsys):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert set(port.JAX_VARIANT) == set(port.VARIANTS)
    assert set(port.JAX_VARIANT.values()) == _jax_variant_names(jax_mod)
    if port is bench_dwconv:
        assert port.STAGES == jax_mod.STAGES
    results = port.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    names = {r.variant.split(":")[0] for r in results}
    assert names == set(port.VARIANTS)
    for r in results:
        assert r.variant in out and r.ms is None and r.ok is not False
