"""The port's int8 serving option (`ModelConfig.quant = "int8"`, TPU row 12)
against the JAX package's MSPI_QUANT=int8 on the CPU.

- `quantize_weight` on an `nn.Linear` weight [out, in] gives the codes and
  scales of the JAX `quantize_weight` on the [in, out] kernel;
- the plain `ln_mlp_int8` (what a CPU tensor runs) against
  `fused_ln_mlp_int8(interpret=True)`, and against the float LN+MLP;
- the MViT block (C 384), the fusion `Block` (C 512) and a Swin block
  (C 384) built with quant="int8" against their flax modules under
  MSPI_QUANT=int8 with the Pallas kernels in interpret mode; in train mode
  each equals the float block bit for bit;
- the inference CLI's three serving flags.

Row-12 tolerance: relative RMS error <= 1e-3 of the reference's RMS and
max abs error <= 0.02 x max|reference|. Both sides compute the same int8
codes in the same order, but the LayerNorm sums and rsqrt round in another
order, which can flip one code on a rare element (a flip moves u or y by
one step of its scale). The module tests also ask that the port sit ten
times closer to JAX's int8 output than to the float block's, so that the
closeness is JAX's quantisation and not quantisation in general.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.models import fusion as jax_fusion
from mspi_tpu.models import mvit as jax_mvit
from mspi_tpu.models import videoswin as jax_swin
from mspi_tpu.ops.pallas.mlp import fused_ln_mlp_int8
from mspi_tpu.ops.pallas.mlp import quantize_weight as jax_quantize_weight
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.models import fusion, mvit, videoswin
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels.ln_mlp import (QUANT_MIN_C, int8_operands, ln_mlp,
                                               ln_mlp_int8, quantize_weight)
from tests.torch_port_utils import cpu_share, jax_module_variables, load_port, to_np

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def assert_int8_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rms_err = np.sqrt(np.mean((got - want) ** 2))
    assert rms_err <= 1e-3 * np.sqrt(np.mean(want ** 2)), rms_err
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def _rms(a):
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


@pytest.fixture(scope="module", autouse=True)
def free_jax_programs():
    yield
    jax.clear_caches()


def test_quantize_weight_matches_jax(rng):
    """Per output channel: a [96, 40] weight has 96 scales, one per row of
    the nn.Linear layout (a reduction over the wrong axis has 40)."""
    w = _randn(rng, 96, 40) * rng.uniform(0.1, 3.0, (96, 1)).astype(np.float32)
    w[5] = 0.0  # an all-zero channel takes the 1e-12 floor
    want_q, want_s = jax_quantize_weight(jnp.asarray(w.T))
    got_q, got_s = quantize_weight(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_q.shape == (96, 40) and got_s.shape == (96,)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s)[0])
    nonzero = np.abs(got_q.numpy().astype(int)).max(axis=1)
    assert (np.delete(nonzero, 5) == 127).all() and nonzero[5] == 0


def _int8_params(rng, C, H):
    g, be = 1 + _randn(rng, C, scale=0.1), _randn(rng, C, scale=0.1)
    w1, b1 = _randn(rng, C, H, scale=0.05), _randn(rng, H, scale=0.1)
    w2, b2 = _randn(rng, H, C, scale=0.05), _randn(rng, C, scale=0.1)
    return g, be, w1, b1, w2, b2


def _port_int8(x, g, be, w1, b1, w2, b2, eps=1e-6):
    w1q, s1 = quantize_weight(torch.from_numpy(np.ascontiguousarray(w1.T)))
    w2q, s2 = quantize_weight(torch.from_numpy(np.ascontiguousarray(w2.T)))
    t = torch.from_numpy
    return ln_mlp_int8(t(x), t(g), t(be), w1q, s1, t(b1), w2q, s2, t(b2), eps)


@pytest.mark.parametrize("B,N,C,H", [(2, 200, 256, 1024), (1, 77, 384, 1536),
                                     (1, 99, 320, 1280)])
def test_ln_mlp_int8_matches_pallas(rng, B, N, C, H):
    """At the JAX package's own test shape (N = 200 pads to the TPU's row
    tile), at the MViT stage-3 width with a ragged N, and at UniFormer-B's
    stage-3 width (C = 320, which the JAX package quantises too)."""
    x = _randn(rng, B, N, C)
    params = _int8_params(rng, C, H)
    want = fused_ln_mlp_int8(jnp.asarray(x), *map(jnp.asarray, params), interpret=True)
    got = _port_int8(x, *params)
    assert got.dtype == torch.float32
    assert_int8_close(got.numpy(), want)


def test_ln_mlp_int8_close_to_float(rng):
    """int8 against the float LN+MLP (K2's plain version), as
    `test_fused_ln_mlp_int8_close_to_fp32` holds the JAX kernel: RMS error
    under 2% of the output's RMS, correlation above 0.999."""
    B, N, C, H = 2, 200, 256, 1024
    x = _randn(rng, B, N, C)
    g, be, w1, b1, w2, b2 = _int8_params(rng, C, H)
    got = _port_int8(x, g, be, w1, b1, w2, b2).numpy()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want = ln_mlp(t(x), t(g), t(be), t(w1.T), t(b1), t(w2.T), t(b2), 1e-6).numpy()
    assert _rms(got - want) < 0.02 * _rms(want)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_ln_mlp_int8_refuses_autograd(rng):
    x = torch.from_numpy(_randn(rng, 4, 256)).requires_grad_(True)
    w1q, s1 = quantize_weight(torch.from_numpy(_randn(rng, 1024, 256)))
    w2q, s2 = quantize_weight(torch.from_numpy(_randn(rng, 256, 1024)))
    ones, zeros = torch.ones(256), torch.zeros(256)
    with pytest.raises(RuntimeError, match="inference only"):
        ln_mlp_int8(x, ones, zeros, w1q, s1, torch.zeros(1024), w2q, s2, zeros, 1e-6)


def _module_outputs(rng, monkeypatch, jax_module, port_float, port_int8, *inputs):
    """(JAX int8, port int8, port float) on the same seeded weights."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MSPI_QUANT", "int8")
    xs = [jnp.asarray(x) for x in inputs]
    variables = jax_module_variables(jax_module, rng, *xs)
    want = jax_module.apply(variables, *xs)
    outs = []
    for port in (port_int8, port_float):
        load_port(port, variables)
        with torch.no_grad():
            outs.append(port(*(torch.from_numpy(np.asarray(x)) for x in inputs)))
    return want, outs[0], outs[1]


def _check_module(want, got, flt):
    want = np.asarray(want[0] if isinstance(want, tuple) else want)
    got, flt = (to_np(t[0] if isinstance(t, tuple) else t) for t in (got, flt))
    assert_int8_close(got, want)
    assert _rms(got - want) < 0.1 * _rms(got - flt), "int8 path not taken"


def _train_mode_matches_float(port_int8, port_float, *inputs):
    """quant="int8" leaves training alone: train-mode outputs are bit-equal
    (drop-path off, so train mode is deterministic)."""
    port_float.load_state_dict(port_int8.state_dict())
    port_int8.train(), port_float.train()
    with torch.no_grad():
        a = port_int8(*(torch.from_numpy(np.asarray(x)) for x in inputs))
        b = port_float(*(torch.from_numpy(np.asarray(x)) for x in inputs))
    a, b = (t[0] if isinstance(t, tuple) else t for t in (a, b))
    assert torch.equal(a, b)


def test_mvit_block_int8_matches_jax(rng, monkeypatch):
    dim, heads, thw = 384, 4, (2, 4, 4)
    kernel = (3, 3, 3)
    args = (dim, dim, heads, (2, 4, 4), 4.0, True, kernel, kernel, (1, 1, 1), (1, 2, 2))
    jax_block = jax_mvit.MultiScaleBlock(
        dim=dim, dim_out=dim, num_heads=heads, input_size=(2, 4, 4), mlp_ratio=4.0,
        qkv_bias=True, drop_path=0.0, kernel_q=kernel, kernel_kv=kernel, stride_q=(1, 1, 1),
        stride_kv=(1, 2, 2))
    port_int8 = mvit.MultiScaleBlock(*args, quant="int8")
    port_float = mvit.MultiScaleBlock(*args)
    x = _randn(rng, 2, int(np.prod(thw)), dim)

    class _Thw(torch.nn.Module):  # binds thw so both sides take one array
        def __init__(self, blk):
            super().__init__()
            self.blk = blk

        def forward(self, x):
            return self.blk(x, thw)

    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MSPI_QUANT", "int8")
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x), thw, False)
    want, _ = jax_block.apply(variables, jnp.asarray(x), thw, False)
    outs = []
    for port in (port_int8, port_float):
        load_port(port, variables)
        with torch.no_grad():
            outs.append(_Thw(port)(torch.from_numpy(x))[0])
    _check_module(want, outs[0], outs[1])
    _train_mode_matches_float(_Thw(port_int8), _Thw(port_float), x)


def test_fusion_block_int8_matches_jax(rng, monkeypatch):
    x = _randn(rng, 2, 13, 512)
    want, got, flt = _module_outputs(rng, monkeypatch, jax_fusion.Block(dim=512, num_heads=4),
                                     fusion.Block(512, 4), fusion.Block(512, 4, quant="int8"),
                                     x)
    _check_module(want, got, flt)
    _train_mode_matches_float(fusion.Block(512, 4, quant="int8"), fusion.Block(512, 4), x)


def test_swin_block_int8_matches_jax(rng, monkeypatch):
    window, shift = (2, 4, 4), (1, 2, 2)
    x = _randn(rng, 1, 2, 4, 8, 384)
    mask = jax_swin._attn_mask(2, 4, 8, window, shift)
    jax_block = jax_swin.SwinTransformerBlock3D(dim=384, num_heads=12, window_size=window,
                                                shift_size=shift)
    want, got, flt = _module_outputs(
        rng, monkeypatch, jax_block, videoswin.SwinTransformerBlock3D(384, 12, window, shift),
        videoswin.SwinTransformerBlock3D(384, 12, window, shift, quant="int8"), x, mask)
    _check_module(want, got, flt)
    _train_mode_matches_float(
        videoswin.SwinTransformerBlock3D(384, 12, window, shift, quant="int8"),
        videoswin.SwinTransformerBlock3D(384, 12, window, shift), x, mask)


def test_int8_operands_cached_until_weights_change():
    """The codes are computed once and kept as non-persistent buffers (the
    state_dict stays the float block's); a changed weight requantises."""
    blk = fusion.Block(512, 4, quant="int8")
    ops = int8_operands(blk.norm2, blk.mlp)
    assert ops[2].dtype == torch.int8 and blk.mlp.fc1.in_features >= QUANT_MIN_C
    assert int8_operands(blk.norm2, blk.mlp)[2] is ops[2]
    assert set(blk.state_dict()) == set(fusion.Block(512, 4).state_dict())
    with torch.no_grad():
        blk.mlp.fc1.weight.mul_(2.0)
    w1q, s1 = int8_operands(blk.norm2, blk.mlp)[2:4]
    assert w1q is not ops[2] and torch.equal(w1q, ops[2])
    torch.testing.assert_close(s1, 2.0 * ops[3], rtol=0, atol=0)


def test_inference_cli_serving_flags():
    default = inference.config_from_args(inference.parse_args([]))
    assert (default.model.quant, default.model.prior_fold_res,
            default.model.prior_ln_t) == ("", False, False)
    assert default == get_config("mvitv2s")
    args = inference.parse_args(["--quant", "int8", "--prior_fold_res", "--prior_ln_t",
                                 "--motion_encoder", "videoswins"])
    cfg = inference.config_from_args(args).model
    assert (cfg.motion_encoder, cfg.quant, cfg.prior_fold_res, cfg.prior_ln_t) == (
        "videoswins", "int8", True, True)
    with pytest.raises(SystemExit):
        inference.parse_args(["--quant", "int4"])
