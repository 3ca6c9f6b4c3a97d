"""The ConvNeXt prior's serving options (`ModelConfig.prior_fold_res`, TPU
row 10, and `prior_ln_t`, row 11) against the JAX package's
MSPI_PRIOR_FOLD_RES=1 and MSPI_PRIOR_LN_T=1 on the CPU, and one whole
AudioVisualSaliencyModel with all three serving options on.

- `ln_mlp_prior_res` against `fused_ln_mlp_t_res(interpret=True)` and
  `layernorm_tokens` against `fused_ln_t(interpret=True)`, both on the
  transposed [N, C, B*T] layout the TPU kernels take, at 1e-5 of the
  output's scale max(1, max|ref|) (fp32; the GELU's erf polynomial is within
  2e-7 of erf);
- `ConvNeXtTinyFeatures` with both options against the flax module under
  both switches, at the module tests' tolerance (atol 1e-4, rtol 1e-4);
- an MViT AudioVisualSaliencyModel at 32x64 with quant="int8",
  prior_fold_res and prior_ln_t against JAX under MSPI_QUANT=int8 and the
  two prior switches, every Pallas kernel in interpret mode: which calls go
  to which kernel, and the log-density map.

The JAX side runs with MSPI_MLPT_VMEM_BUDGET=1: its transposed prior
kernels then take one position per grid step instead of unrolling up to 32
in the kernel body, which changes their tiling and not their arithmetic,
and cuts the interpreter's trace and compile several-fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models import convnext as jax_convnext
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu.ops.pallas import mlp as jax_mlp
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.models import convnext
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import layernorm as LN
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels.layernorm import layernorm_tokens
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp_prior_res
from tests.torch_port_utils import (SHALLOW_MVIT, cpu_share, jit_fast, load_port, seeded_variables,
                                    skipped_init, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (32, 64)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _assert_close_to_scale(got, want, rel=1e-5):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


@pytest.fixture(autouse=True)
def small_transposed_tiles(monkeypatch):
    monkeypatch.setenv("MSPI_MLPT_VMEM_BUDGET", "1")


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


@pytest.fixture(scope="module", autouse=True)
def free_jax_programs():
    yield
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("BT,N,C", [(4, 12, 32), (3, 10, 96)])
def test_ln_mlp_prior_res_matches_transposed_pallas(rng, BT, N, C):
    """The port folds the residual on channels-last tokens [BT, N, C]; the
    TPU kernel takes them transposed to [N, C, BT]."""
    H = 4 * C
    x, s = _randn(rng, BT, N, C), _randn(rng, BT, N, C)
    gamma = rng.uniform(0.05, 0.3, C).astype(np.float32)
    g, be = 1 + _randn(rng, C, scale=0.1), _randn(rng, C, scale=0.1)
    w1, b1 = _randn(rng, C, H, scale=C ** -0.5), _randn(rng, H, scale=0.1)
    w2, b2 = _randn(rng, H, C, scale=H ** -0.5), _randn(rng, C, scale=0.1)
    want = jax_mlp.fused_ln_mlp_t_res(
        jnp.asarray(x.transpose(1, 2, 0)), jnp.asarray(s.transpose(1, 2, 0)),
        *map(jnp.asarray, (gamma, g, be, w1, b1, w2, b2)), eps=1e-6, interpret=True)
    got = ln_mlp_prior_res(_t(x), _t(s), _t(gamma), _t(g), _t(be), _t(w1.T), _t(b1), _t(w2.T),
                           _t(b2))
    _assert_close_to_scale(got.numpy(), np.asarray(want).transpose(2, 0, 1))


@pytest.mark.parametrize("BT,N,C", [(4, 12, 96), (2, 9, 384)])
def test_layernorm_tokens_matches_transposed_pallas(rng, BT, N, C):
    x = _randn(rng, BT, N, C) + 0.5
    g, be = 1 + _randn(rng, C, scale=0.1), _randn(rng, C, scale=0.1)
    want = jax_mlp.fused_ln_t(jnp.asarray(x.transpose(1, 2, 0)), jnp.asarray(g),
                              jnp.asarray(be), eps=1e-6, interpret=True)
    got = layernorm_tokens(_t(x), _t(g), _t(be), 1e-6)
    _assert_close_to_scale(got.numpy(), np.asarray(want).transpose(2, 0, 1))


def test_convnext_features_with_prior_options_match_flax(rng, monkeypatch):
    """Both prior options on: the 18 blocks fold their residual and the
    stem/downsample LayerNorms run the LayerNorm kernel's plain version; in
    fp32 the JAX package serves C = 768 unfolded (its VMEM budget), which
    computes the same sum. The options leave the float features as they
    were (to fp32 rounding)."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MSPI_PRIOR_FOLD_RES", "1")
    monkeypatch.setenv("MSPI_PRIOR_LN_T", "1")
    x = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    port = convnext.ConvNeXtTinyFeatures(fold_res=True, ln_t=True)
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    want = jax.jit(jax_convnext.ConvNeXtTinyFeatures().apply)(variables, jnp.asarray(x))
    load_port(port, variables)
    plain = load_port(convnext.ConvNeXtTinyFeatures(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        base = plain(torch.from_numpy(x))
    assert port.stem[1].kernel and port.stages_3.downsample[0].kernel
    assert all(b.fold_res for b in port.stages_2.blocks)
    for g, w, b in zip(got, want, base):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(to_np(g), to_np(b), atol=1e-5, rtol=1e-5)


def _counting(module, name, counts, monkeypatch):
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, wrapper)


def _set_options(model, on: bool):
    """Switch the serving options of a built model on or off in place."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = "int8" if on else ""
        if isinstance(m, convnext.ConvNeXtBlock2d):
            m.fold_res = on
        if isinstance(m, convnext.PriorLayerNorm):
            m.kernel = on


def test_av_model_with_serving_options_matches_jax(rng, monkeypatch):
    """An MViT AudioVisualSaliencyModel (`SHALLOW_MVIT`) at 32x64, batch 1,
    uint8 clips, with quant="int8", prior_fold_res and prior_ln_t, against
    JAX under the three switches, every Pallas kernel in interpret mode.

    Routing: the port sends 3 LN+MLPs to int8 (backbone blocks 2-3 and the
    one SyncBlock block of this config), 18 prior blocks to the folded kernel and 4 prior
    norms to the LayerNorm kernel; JAX the same, except that in fp32 its
    transposed kernel refuses the prior's 3 C = 768 blocks (VMEM), which it
    serves unfolded. Two fp32-only artefacts of the TPU's VMEM budget are
    lifted on the JAX side so that it routes as its bf16 serving path does:
    `fits_vmem_fwd` would send the C = 768 backbone block to XLA's float
    MLP, and MSPI_PRIOR_FUSED=0 keeps those 3 prior blocks on the float MLP
    rather than the int8 token-major kernel.

    The map: an int8 network turns ulp-level differences (here the float
    paths' summation orders) into flipped codes block after block, so two
    right int8 implementations drift apart by a fraction of the
    quantisation noise itself. So the map is held to this: the port's int8
    map lies closer to JAX's int8 map than to its own float map, with CC
    0.9999 against JAX's; the loss within 1e-3 of JAX's. One SyncBlock block
    and 128-wide SimSiam heads keep the model's memory down; neither
    changes a routing rule."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MSPI_QUANT", "int8")
    monkeypatch.setenv("MSPI_PRIOR_FOLD_RES", "1")
    monkeypatch.setenv("MSPI_PRIOR_LN_T", "1")
    monkeypatch.setenv("MSPI_PRIOR_FUSED", "0")
    monkeypatch.setattr(jax_mlp, "fits_vmem_fwd", lambda c, h, itemsize=2: True)
    jax_calls, port_calls = {}, {}
    for name in ("fused_ln_mlp_int8", "fused_ln_mlp_t_res", "fused_ln_t", "fused_ln_mlp_t"):
        _counting(jax_mlp, name, jax_calls, monkeypatch)
    for module, name in ((K2, "ln_mlp_int8_reference"), (K2, "ln_mlp_prior_res_reference"),
                         (LN, "layernorm_tokens_reference")):
        _counting(module, name, port_calls, monkeypatch)
    cfg = {"data": {"resolution": RES},
           "model": {"mvit": SHALLOW_MVIT, "sync_num_blocks": 1, "simsiam_hidden": 128}}
    with skipped_init():
        port = AudioVisualSaliencyModel(get_config("mvitv2s", {
            **cfg, "model": {**cfg["model"], "quant": "int8", "prior_fold_res": True,
                             "prior_ln_t": True}}), device="cpu")
    # set-up quantised the 5 int8 blocks; the codes stay out of the state_dict
    assert sum(hasattr(m, "int8_w1q") for m in port.modules()) == 3
    assert not any("int8" in k for k in port.state_dict())
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    jax_model = JaxModel(cfg=jax_get_config("mvitv2s", cfg))
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips),
                                               jnp.asarray(auds))
    jax.clear_caches()
    assert jax_calls == {"fused_ln_mlp_int8": 3, "fused_ln_mlp_t_res": 15, "fused_ln_t": 4}
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
        assert port_calls == {"ln_mlp_int8_reference": 3, "ln_mlp_prior_res_reference": 18,
                              "layernorm_tokens_reference": 4}
        _set_options(port, False)
        flt, _ = port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert got.shape == (1, *RES)
    want = np.asarray(want, np.float64)
    got, flt = got.double().numpy(), flt.double().numpy()

    def rms(a):  # log-densities: about their means
        return np.sqrt(np.mean((a - a.mean()) ** 2))
    assert rms(got - want) <= rms(got - flt)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.9999
    assert abs(float(got_loss) - float(want_loss)) < 1e-3
