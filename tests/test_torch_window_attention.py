"""The port's window attention (TPU kernel rows 15-17) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

On CPU tensors `window_attention` and its backward run their plain PyTorch
versions; the CUDA kernels themselves are held to those plain versions by
`chip_smoke.py` on the card. Inputs are seeded numpy arrays. Tolerances:
forward atol 1e-5, rtol 1e-4 (fp32, only the summation order differs);
each gradient within 1e-4 of its own largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.ops.pallas.attention import fused_window_attention
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import window_attention as WA


def _inputs(rng, B, H, N, D, nW, masked):
    qkv = rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    mask = (np.where(rng.random((nW, N, N)) > 0.8, -100.0, 0.0).astype(np.float32)
            if masked else None)
    return qkv, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("B,H,N,nW,masked", [
    (4, 3, 56, 2, True),
    (4, 3, 56, 2, False),
    (2, 1, 392, 2, True),  # a full 8x7x7 window: ragged 64-row tiles on the card
])
def test_window_attention_matches_pallas(rng, B, H, N, nW, masked):
    qkv, bias, mask = _inputs(rng, B, H, N, 32, nW, masked)
    want = fused_window_attention(_j(qkv), _j(bias), _j(mask), num_heads=H,
                                  num_windows=nW if masked else 1, interpret=True)
    kernels.reset_launch_counts()
    got = WA.window_attention(_t(qkv), _t(bias), _t(mask), H, nW if masked else 1)
    assert kernels.launches["window_attention"] == 0  # CPU tensors: the plain version
    assert got.shape == (B, N, H * 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("backward", ["packed", "perhead"])
@pytest.mark.parametrize("masked", [True, False])
def test_window_attention_grads_match_pallas(rng, monkeypatch, backward, masked):
    """dqkv and dbias against jax.vjp of the Pallas custom VJP, under the
    packed backward (row 16) and, forced by a tiny VMEM budget, the per-head
    one (row 17)."""
    B, H, N, D, nW = 4, 3, 56, 32, 2
    qkv, bias, mask = _inputs(rng, B, H, N, D, nW, masked)
    dout = rng.standard_normal((B, N, H * D)).astype(np.float32)
    if backward == "perhead":
        monkeypatch.setenv("MSPI_ATTN_VMEM_BUDGET", "200000")
    else:
        monkeypatch.delenv("MSPI_ATTN_VMEM_BUDGET", raising=False)
    jax.clear_caches()  # the budget is read while the jitted kernel traces
    nw = nW if masked else 1
    _, vjp = jax.vjp(lambda a, b: fused_window_attention(a, b, _j(mask), num_heads=H,
                                                         num_windows=nw, interpret=True),
                     _j(qkv), _j(bias))
    want = vjp(jnp.asarray(dout))
    jax.clear_caches()

    q, b = _t(qkv).requires_grad_(True), _t(bias).requires_grad_(True)
    m = _t(mask)
    WA.window_attention(q, b, m, H, nw).backward(_t(dout))
    for name, g, w in (("dqkv", q.grad, want[0]), ("dbias", b.grad, want[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_window_backward_reference_matches_autograd(rng):
    """The plain backward against autograd through the plain forward."""
    B, H, N, D, nW = 4, 2, 24, 32, 2
    qkv, bias, mask = _inputs(rng, B, H, N, D, nW, True)
    dout = torch.from_numpy(rng.standard_normal((B, N, H * D)).astype(np.float32))
    q, b = _t(qkv).requires_grad_(True), _t(bias).requires_grad_(True)
    WA.window_attention_reference(q, b, _t(mask), H, nW).backward(dout)
    dq, db = WA.window_attention_backward_reference(_t(qkv), _t(bias), _t(mask), H, nW, dout)
    torch.testing.assert_close(dq, q.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, b.grad, rtol=1e-5, atol=1e-5)
