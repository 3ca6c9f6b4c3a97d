"""The port's fused MLP (TPU rows 13-14, `ops/kernels/ln_mlp.py::fused_mlp`)
against `mspi_tpu.ops.pallas.mlp.fused_mlp` in interpret mode on the CPU,
where the port's functions run their plain versions.

- the forward at the JAX test's shape (2,160,24,96), fp32 atol 3e-5 (the
  TPU's fp32 GELU is a degree-16 fit of erf within 2e-7 of the port's
  exact erf);
- the gradients of all five operands against `jax.grad` at (1,128,16,64)
  and at the tile-regression shape (1,200,64,2048), at the JAX tests'
  tolerances (atol 5e-4 / rtol 1e-4 and atol 5e-3 / rtol 1e-3);
- `mlp_backward_reference` against torch autograd of `mlp_reference` in
  fp32 and in bf16 (its rounding points);
- `maybe_fused_mlp` on the port's MViT `Mlp`, and the cases where it
  returns None.

The JAX function takes w1 [C, H] and w2 [H, C]; the port takes the
nn.Linear layout, their transposes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mspi_tpu.ops.pallas.mlp import fused_mlp as jax_fused_mlp
from mspi_tpu_torch.models.mvit import Mlp
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels.ln_mlp import (fused_mlp, maybe_fused_mlp, mlp_backward_reference,
                                               mlp_reference)
from tests.torch_port_utils import cpu_share

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


def _operands(rng, B, N, C, H, scale, x_scale=1.0, zero_bias=False):
    x = (x_scale * rng.standard_normal((B, N, C))).astype(np.float32)
    w1 = (scale * rng.standard_normal((C, H))).astype(np.float32)
    b1 = np.zeros(H, np.float32) if zero_bias else (scale * rng.standard_normal(H)).astype(
        np.float32)
    w2 = (scale * rng.standard_normal((H, C))).astype(np.float32)
    b2 = np.zeros(C, np.float32) if zero_bias else (scale * rng.standard_normal(C)).astype(
        np.float32)
    return x, w1, b1, w2, b2


def _port_args(x, w1, b1, w2, b2):
    """numpy JAX-layout operands -> torch tensors in nn.Linear layout."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w1.T, b1, w2.T, b2))


def test_fused_mlp_forward_matches_jax(rng):
    ops = _operands(rng, 2, 160, 24, 96, 0.1)
    want = jax_fused_mlp(*map(jnp.asarray, ops), interpret=True)
    got = fused_mlp(*_port_args(*ops))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("shape, scale, x_scale, zero_bias, atol, rtol", [
    ((1, 128, 16, 64), 0.2, 1.0, False, 5e-4, 1e-4),
    ((1, 200, 64, 2048), 0.05, 0.2, True, 5e-3, 1e-3),  # the JAX fwd/bwd tile regression
])
def test_fused_mlp_grads_match_jax(rng, shape, scale, x_scale, zero_bias, atol, rtol):
    ops = _operands(rng, *shape, scale, x_scale, zero_bias)
    wgt = rng.standard_normal(shape[:3]).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_fused_mlp(*a, interpret=True) * wgt),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ops))
    args = [t.requires_grad_(True) for t in _port_args(*ops)]
    (fused_mlp(*args) * torch.from_numpy(wgt)).sum().backward()
    # the port's weight gradients are in nn.Linear layout: transpose back
    got = [args[0].grad, args[1].grad.T, args[2].grad, args[3].grad.T, args[4].grad]
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert np.all(np.isfinite(g.numpy())), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_mlp_backward_reference_matches_autograd(rng, dtype, atol):
    """In bf16 the plain backward rounds du and h where the kernels do and
    autograd of the plain forward does not: its tolerance is a few bf16
    steps of the gradients' scale (about 1)."""
    x, w1, b1, w2, b2 = (t.to(dtype) for t in _port_args(*_operands(rng, 2, 24, 32, 128, 0.2)))
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dtype)
    leaves = [t.float().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    y = mlp_reference(*leaves)
    want = torch.autograd.grad(y, leaves, dy.float())
    got = mlp_backward_reference(x, w1, b1, w2, b2, dy)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        scale = max(1.0, w.abs().max().item())
        assert (g.float() - w).abs().max().item() <= atol * scale, name


def test_maybe_fused_mlp_on_the_port_mlp(rng):
    torch.manual_seed(0)
    mlp = Mlp(96, 384, 96)
    x = torch.from_numpy(rng.standard_normal((2, 10, 96)).astype(np.float32)).requires_grad_(True)
    y = maybe_fused_mlp(mlp, x)
    want = mlp.fc2(torch.nn.functional.gelu(mlp.fc1(x)))
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    y.sum().backward()
    assert mlp.fc1.weight.grad is not None and x.grad.shape == x.shape


def test_maybe_fused_mlp_returns_none(rng):
    x = torch.zeros(1, 4, 96)

    def mlp(c, h, out, bias=True):
        m = nn.Module()
        m.fc1, m.fc2 = nn.Linear(c, h, bias=bias), nn.Linear(h, out)
        return m

    assert maybe_fused_mlp(mlp(96, 384, 96, bias=False), x) is None  # no bias
    assert maybe_fused_mlp(mlp(96, 384, 48), x) is None  # fc2 out != fc1 in
    assert maybe_fused_mlp(mlp(24, 96, 24), torch.zeros(1, 4, 24)) is None  # C not compiled
    assert maybe_fused_mlp(mlp(96, 200, 96), x.bfloat16()) is None  # bf16, H % 64
    assert maybe_fused_mlp(mlp(96, 200, 96), x) is not None  # fp32 takes any H
