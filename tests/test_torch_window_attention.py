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
from tests.torch_port_utils import cpu_share

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


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


@pytest.mark.parametrize("masked,backward,shape", [
    pytest.param(True, "packed", (4, 3, 56, 2), id="True-packed"),
    pytest.param(True, "perhead", (4, 3, 56, 2), id="True-perhead"),
    pytest.param(False, "packed", (4, 3, 56, 2), id="False-packed"),
    pytest.param(False, "perhead", (4, 3, 56, 2), id="False-perhead"),
    # a full 8x7x7 window, which the card's passes tile as 6 x 64 + 8 rows
    pytest.param(True, "packed", (2, 1, 392, 2), id="True-packed-full-window"),
])
def test_window_attention_grads_match_pallas(rng, monkeypatch, backward, masked, shape):
    """dqkv and dbias against jax.vjp of the Pallas custom VJP, under the
    packed backward (row 16) and, forced by a tiny VMEM budget, the per-head
    one (row 17)."""
    (B, H, N, nW), D = shape, 32
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


@pytest.mark.parametrize("heads,windows,want", [(3, 224, 8), (6, 56, 4), (12, 16, 2), (24, 4, 1)])
def test_dbias_groups_fill_two_waves(heads, windows, want):
    """VideoSwin-S's four stages at batch 2 (N = 392, 7 x 7 tiles) on 132
    SMs: the bf16 dbias pass's 49 x heads x groups blocks fill two waves of
    4 blocks per SM where the windows allow it, and no group is empty."""
    groups = WA.dbias_groups(132, 392, heads, windows, torch.bfloat16)
    assert groups == want
    assert 49 * heads * groups >= 2 * 4 * 132 or groups == windows or want == 1
    assert (groups - 1) * -(-windows // groups) < windows


@pytest.mark.parametrize("windows", [1, 2, 5, 7, 31, 224])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dbias_groups_none_empty(windows, dtype):
    """Every group of ceil(windows / groups) consecutive windows holds one;
    fp32 sizes its groups for one (query tile, head, group) block per SM."""
    for sms, heads in ((1, 1), (132, 3), (132, 24), (1000, 2)):
        groups = WA.dbias_groups(sms, 392, heads, windows, dtype)
        per = -(-windows // groups)
        assert 1 <= groups <= windows and (groups - 1) * per < windows <= groups * per
        if dtype == torch.float32:
            want = max(1, min(windows, -(-2 * sms // (7 * heads))))
            assert groups == -(-windows // -(-windows // want))


@pytest.mark.parametrize("masked", [True, False])
def test_window_backward_rounded_matches_pallas_bf16(rng, masked):
    """The plain version that rounds where the TPU kernel rounds (q_s, P
    before dv, dS before dq and dk; delta = rowsum(P dP) in fp32) against
    jax.vjp of the Pallas backward in interpret mode, both in bf16 on the
    same bf16 inputs. The two differ only in fp32 summation order, which can
    flip the bf16 rounding of a dS element or of an output: each gradient
    within one bf16 step (2^-8) of its largest magnitude. With the
    forward's bf16 O in place of P for delta (FlashAttention-2's identity on
    the rounded O) its dk moves further from the TPU kernel's, on average
    over the elements."""
    B, H, N, D, nW = 4, 3, 56, 32, 2
    qkv, bias, mask = _inputs(rng, B, H, N, D, nW, masked)
    bias *= 0.5
    dout = rng.standard_normal((B, N, H * D)).astype(np.float32)
    nw = nW if masked else 1
    bf = jnp.bfloat16
    jmask = None if mask is None else jnp.asarray(mask, bf)
    _, vjp = jax.vjp(lambda a, b: fused_window_attention(a, b, jmask, num_heads=H,
                                                         num_windows=nw, interpret=True),
                     jnp.asarray(qkv, bf), jnp.asarray(bias, bf))
    want = vjp(jnp.asarray(dout, bf))
    tq, tb, td = (torch.from_numpy(a).bfloat16() for a in (qkv, bias, dout))
    tm = None if mask is None else torch.from_numpy(mask).bfloat16()
    got = WA.window_attention_backward_rounded_reference(tq, tb, tm, H, nw, td)
    out = WA.window_attention_reference(tq, tb, tm, H, nw)
    flash2 = WA.window_attention_backward_rounded_reference(tq, tb, tm, H, nw, td, out)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    dk = slice(H * D, 2 * H * D)
    for name, g, w in (("dqkv", got[0], want[0]), ("dbias", got[1], want[1])):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2.0 ** -8 * np.abs(w).max(), err_msg=name)
    w = np.asarray(want[0].astype(jnp.float32))[..., dk]
    assert (np.abs(flash2[0].float().numpy()[..., dk] - w).mean()
            > np.abs(got[0].float().numpy()[..., dk] - w).mean())
