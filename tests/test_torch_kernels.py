"""The port's kernel functions (mspi_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

On CPU tensors each port function runs its plain PyTorch version (the CUDA
kernels run only on the card; chip_smoke.py holds them against the same
plain versions there), so these tests pin the plain versions' semantics to
the TPU kernels'. Tolerance atol 1e-5, rtol 1e-4: everything is fp32, and
the Pallas GELU's erf polynomial is within 2e-7 of erf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.models.mvit import _onehot_rows
from mspi_tpu.ops.pallas.mlp import fused_ln_mlp, fused_ln_mlp_t
from mspi_tpu.ops.pallas.pooled_attention import fused_attention_rel, fused_self_attention
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_prior
from mspi_tpu_torch.ops.kernels.pooled_attention import (attention_rel, key_expansion,
                                                         self_attention)

TOL = dict(atol=1e-5, rtol=1e-4)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


@pytest.mark.parametrize("B,H,Nq,k_shape,D", [
    (1, 1, 24, (2, 2, 3), 8),     # single head
    (2, 2, 37, (2, 3, 2), 16),    # ragged Nq, 2 heads
    (1, 2, 50, (1, 4, 5), 8),     # kt = 1
])
def test_attention_rel_matches_pallas(rng, B, H, Nq, k_shape, D):
    Nk, R = int(np.prod(k_shape)), sum(k_shape)
    q, k, v = (_randn(rng, B, H, n, D) for n in (Nq, Nk, Nk))
    rel = _randn(rng, B, H, Nq, R)
    scale = D ** -0.5
    E = np.concatenate([_onehot_rows(a, k_shape) for a in "thw"], axis=0).T
    np.testing.assert_array_equal(E, key_expansion(k_shape))
    want = fused_attention_rel(*map(jnp.asarray, (q, k, v, rel, E)), scale, interpret=True)
    got = attention_rel(*map(torch.from_numpy, (q, k, v, rel)), k_shape, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,N,C,H", [(1, 24, 16, 2), (2, 37, 32, 4)])
def test_self_attention_matches_pallas(rng, B, N, C, H):
    q, kv = _randn(rng, B, N, C), _randn(rng, B, N, 2 * C)
    want = fused_self_attention(jnp.asarray(q), jnp.asarray(kv), num_heads=H, interpret=True)
    got = self_attention(torch.from_numpy(q), torch.from_numpy(kv), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mlp_params(rng, C):
    H = 4 * C
    return (1 + _randn(rng, C, scale=0.1), _randn(rng, C, scale=0.1),
            _randn(rng, C, H, scale=C ** -0.5), _randn(rng, H, scale=0.1),
            _randn(rng, H, C, scale=H ** -0.5), _randn(rng, C, scale=0.1))


def _port_weights(g, be, w1, b1, w2, b2):
    """JAX [C,H]/[H,C] kernels -> nn.Linear layouts [H,C]/[C,H]."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (g, be, w1.T, b1, w2.T, b2))


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("B,N,C", [(1, 24, 16), (2, 37, 32)])
def test_ln_mlp_matches_pallas(rng, B, N, C, eps):
    x = _randn(rng, B, N, C)
    params = _mlp_params(rng, C)
    want = fused_ln_mlp(jnp.asarray(x), *map(jnp.asarray, params), eps=eps, interpret=True)
    got = ln_mlp(torch.from_numpy(x), *_port_weights(*params), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("BT,N,C", [(4, 12, 16), (3, 10, 32)])
def test_ln_mlp_prior_matches_transposed_pallas(rng, BT, N, C):
    """K3's call site: the port runs the K2 math on channels-last tokens
    [BT, N, C]; the TPU kernel takes them transposed to [N, C, BT]."""
    x = _randn(rng, BT, N, C)
    params = _mlp_params(rng, C)
    want = fused_ln_mlp_t(jnp.asarray(x.transpose(1, 2, 0)), *map(jnp.asarray, params),
                          eps=1e-6, interpret=True)
    got = ln_mlp_prior(torch.from_numpy(x), *_port_weights(*params))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(2, 0, 1), **TOL)


def test_dispatch_rejects_mixed_devices():
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError):
        kernels.dispatch_device(x, torch.zeros(2, 16, device="meta"))
    with pytest.raises(ValueError):
        kernels.dispatch_device(torch.zeros(2, device="meta"))
