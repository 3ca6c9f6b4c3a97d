"""The port's kernel functions (mspi_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels in interpret mode, on the CPU, forward and
backward.

On CPU tensors each port function runs its plain PyTorch version (the CUDA
kernels run only on the card; chip_smoke.py holds them against the same
plain versions there), so these tests pin the plain versions' semantics to
the TPU kernels'. Forward tolerance atol 1e-5, rtol 1e-4: everything is
fp32, and the Pallas GELU's erf polynomial is within 2e-7 of erf.
Gradients (the port's autograd Functions against jax.vjp of the Pallas
custom VJPs): 1e-4 of each gradient's largest magnitude (at least 1), as
the weight gradients sum over every row in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.models.mvit import _onehot_rows
from mspi_tpu.ops.pallas.mlp import fused_ln_mlp, fused_ln_mlp_t
from mspi_tpu.ops.pallas.pooled_attention import fused_attention_rel, fused_self_attention
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_prior
from mspi_tpu_torch.ops.kernels.pooled_attention import (attention_rel, key_expansion,
                                                         self_attention)
from tests.torch_port_utils import cpu_share

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

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
    (1, 2, 40, (2, 20, 30), 8),   # R = 52, above one 48-column rel tile
    (1, 1, 33, (1, 24, 40), 8),   # R = 65
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


# (1, 70, 256, 2): K4's head dim D = 128, one full 64-row tile and a ragged one
@pytest.mark.parametrize("B,N,C,H", [(1, 24, 16, 2), (2, 37, 32, 4), (1, 70, 256, 2)])
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


def _assert_grad_close(got, want, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=name)


def _port_grads(fn, arrays, dout):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    fn(*leaves).backward(torch.from_numpy(dout))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("B,H,Nq,k_shape,D", [
    (1, 1, 24, (2, 2, 3), 8),
    (2, 2, 37, (2, 3, 2), 16),    # ragged Nq
    (1, 2, 50, (1, 4, 5), 8),
    (1, 2, 40, (2, 20, 30), 8),   # R = 52
    (1, 1, 100, (2, 3, 45), 96),  # the bf16 kernel's head dim; Nq, Nk off 64; R = 50
])
def test_attention_rel_grads_match_pallas(rng, B, H, Nq, k_shape, D):
    Nk, R = int(np.prod(k_shape)), sum(k_shape)
    arrays = [_randn(rng, B, H, n, D) for n in (Nq, Nk, Nk)] + [_randn(rng, B, H, Nq, R)]
    dout = _randn(rng, B, H, Nq, D)
    scale = D ** -0.5
    E = jnp.asarray(key_expansion(k_shape))
    _, vjp = jax.vjp(lambda q, k, v, r: fused_attention_rel(q, k, v, r, E, scale,
                                                            interpret=True),
                     *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dout))
    got = _port_grads(lambda q, k, v, r: attention_rel(q, k, v, r, k_shape, scale), arrays, dout)
    for name, g, w in zip(("dq", "dk", "dv", "drel"), got, want):
        _assert_grad_close(g, w, name)


@pytest.mark.parametrize("B,N,C,H", [(1, 24, 16, 2), (2, 37, 32, 4), (1, 70, 256, 2)])
def test_self_attention_grads_match_pallas(rng, B, N, C, H):
    arrays = [_randn(rng, B, N, C), _randn(rng, B, N, 2 * C)]
    dout = _randn(rng, B, N, C)
    _, vjp = jax.vjp(lambda q, kv: fused_self_attention(q, kv, num_heads=H, interpret=True),
                     *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dout))
    got = _port_grads(lambda q, kv: self_attention(q, kv, H), arrays, dout)
    for name, g, w in zip(("dq", "dkv"), got, want):
        _assert_grad_close(g, w, name)


@pytest.mark.parametrize("B,N,C,eps", [(1, 24, 16, 1e-6), (2, 37, 32, 1e-5)])
def test_ln_mlp_grads_match_pallas(rng, B, N, C, eps):
    x = _randn(rng, B, N, C)
    params = _mlp_params(rng, C)
    dout = _randn(rng, B, N, C)
    _, vjp = jax.vjp(lambda *a: fused_ln_mlp(*a, eps=eps, interpret=True),
                     *map(jnp.asarray, (x, *params)))
    want = list(vjp(jnp.asarray(dout)))
    want[3], want[5] = want[3].T, want[5].T  # [C,H]/[H,C] -> nn.Linear layouts
    port_arrays = [x] + [np.ascontiguousarray(t.numpy()) for t in _port_weights(*params)]
    got = _port_grads(lambda *a: ln_mlp(*a, eps), port_arrays, dout)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2"), got, want):
        _assert_grad_close(g, w, name)


def _autograd_of(plain, arrays, dout, n_grads):
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in arrays[:n_grads]]
    rest = [torch.from_numpy(a).double() for a in arrays[n_grads:]]
    plain(*leaves, *rest).backward(torch.from_numpy(dout).double())
    return [t.grad for t in leaves]


@pytest.mark.parametrize("kernel", ["attention_rel", "self_attention", "ln_mlp"])
def test_backward_references_match_autograd(rng, kernel):
    """Each hand-written *_backward_reference against torch.autograd of its
    plain forward (autograd in fp64; the references compute in fp32:
    tolerance 1e-5 of each gradient's scale)."""
    if kernel == "attention_rel":
        ks = (2, 3, 2)
        arrays = [_randn(rng, 2, 2, 19, 8), _randn(rng, 2, 2, 12, 8), _randn(rng, 2, 2, 12, 8),
                  _randn(rng, 2, 2, 19, 7)]
        dout = _randn(rng, 2, 2, 19, 8)
        got = PA.attention_rel_backward_reference(*map(torch.from_numpy, arrays), ks, 0.3,
                                                  torch.from_numpy(dout))
        want = _autograd_of(lambda *a: PA.attention_rel_reference(*a, ks, 0.3), arrays, dout, 4)
    elif kernel == "self_attention":
        arrays = [_randn(rng, 2, 13, 16), _randn(rng, 2, 13, 32)]
        dout = _randn(rng, 2, 13, 16)
        got = PA.self_attention_backward_reference(*map(torch.from_numpy, arrays), 2,
                                                   torch.from_numpy(dout))
        want = _autograd_of(lambda *a: PA.self_attention_reference(*a, 2), arrays, dout, 2)
    else:
        arrays = [_randn(rng, 3, 11, 16)] + [np.ascontiguousarray(t.numpy())
                                             for t in _port_weights(*_mlp_params(rng, 16))]
        dout = _randn(rng, 3, 11, 16)
        got = K2.ln_mlp_backward_reference(*map(torch.from_numpy, arrays), 1e-6,
                                           torch.from_numpy(dout))
        want = _autograd_of(lambda *a: K2.ln_mlp_reference(*a, 1e-6), arrays, dout, 7)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.numpy()
        np.testing.assert_allclose(g.double().numpy(), w,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0, err_msg=str(i))


# R = 8 + H/16 + W/16 for MViTv2-S's blocks that pool keys to (8, H/16, W/16):
# 27 and 46 at 224x384, 52 at 256x448, 64 at 256x640, 66 at 288x640
@pytest.mark.parametrize("R", range(27, 67))
def test_rel_bwd_form(R):
    """The bf16 K1 backward's form at every rel width the CLIs reach, with
    RS = max(2, ceil(R / 16)) rel k-steps (rel_pad holds R): up to R = 64
    the passes compiled for the three RS that csrc/attention_rel_bwd_sm90.cu
    instantiates, above them the wide form."""
    form, rs = PA.rel_bwd_form(R)
    assert rs >= 2 and 16 * (rs - 1) < max(R, 17) <= 16 * rs
    assert form == ("sm90" if R <= 64 else "sm90_wide")
    if form == "sm90":
        assert rs in (2, 3, 4)

