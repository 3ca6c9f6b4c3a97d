"""MViT's layout options (`ModelConfig.attn_relk`, `attn_packed`, `dwconv`)
against the JAX package's MSPI_ATTN_RELK=0, MSPI_POOL_FAT=1 +
MSPI_ATTN_PACKED=1 and MSPI_DWCONV=1 on the CPU, every Pallas kernel in
interpret mode (MSPI_PALLAS_INTERPRET=1).

On CPU tensors the port's kernel functions run their plain versions, so the
kernel-level tests pin those to the TPU kernels (the CUDA kernels are held
against the same plain versions on the card by chip_smoke.py):
- row 6 `attention` against `fused_attention` at the model's augmented
  widths Da = 123 and 142 (224x384), 148, 162, 109 and 184 (256x448,
  288x640, 64x96, 512x768) and the widest form's 256, forward and
  gradients; row 7's plain backward against autograd;
- row 8 `attention_rel_packed` against `fused_attention_rel_packed`, with
  and without the residual, forward and gradients (autograd and the plain
  packed backward);
- row 18 `dwconv3d` against `fused_dwconv3d`, forward and gradients;
- one `MultiScaleBlock` per option against the flax block, with the calls
  of each kernel function counted on both sides;
- one AudioVisualSaliencyModel (the four-block MViT) with each chip path's
  options against JAX, routing counted on both sides, at inference and,
  with attn_relk=False and dwconv, one training step's gradients.

Tolerances (fp32): kernel forwards 1e-4 of the output's scale max(1,
max|ref|), gradients 1e-4 of each gradient's largest magnitude (sums in
another order); the blocks atol 1e-4, rtol 1e-4 as the other module tests;
the model as stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mspi_tpu.models.mvit as jax_mvit
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu.ops.pallas import dwconv as jax_dwconv
from mspi_tpu.ops.pallas import pooled_attention as jax_pa
from mspi_tpu.train import engine as jax_engine
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import ModelConfig, get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import mvit
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels, layers
from mspi_tpu_torch.ops.kernels import dwconv as DW
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.ops.kernels.pooled_attention import key_expansion
from mspi_tpu_torch.train import __main__ as train_cli
from mspi_tpu_torch.train import engine
from mspi_tpu_torch.train.synthetic import make_batch
from tests.test_torch_train import _assert_leaves_close
from tests.torch_port_utils import (SHALLOW_MVIT, FixedDropPathJax, compile_fast, count_calls,
                                    cpu_share, fixed_drop_path_port, jax_module_variables,
                                    jit_fast, load_port, seeded_variables, to_np, skipped_init)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (32, 64)
# the JAX switches of each option set
ENV = {"attn_relk": {"MSPI_ATTN_RELK": "0"},
       "attn_packed": {"MSPI_POOL_FAT": "1", "MSPI_ATTN_PACKED": "1"},
       # the per-head pools, where the JAX package's Pallas dwconv sits
       "dwconv": {"MSPI_DWCONV": "1", "MSPI_POOL_PACKED": "0"}}
OPTION = {"attn_relk": {"attn_relk": False}, "attn_packed": {"attn_packed": True},
          "dwconv": {"dwconv": True}}
# kernel functions of both packages, counted by the routing tests: the port's
# kernel wrappers (on the CPU, the gate to each plain version) and the JAX
# package's Pallas entry points
PORT_FNS = ((PA, "_attention_fwd"), (PA, "_attention_rel_fwd"),
            (PA, "_attention_rel_packed_fwd"), (DW, "_dwconv3d_fwd"))
JAX_FNS = ((jax_pa, "fused_attention"), (jax_pa, "fused_attention_rel"),
           (jax_pa, "fused_attention_rel_packed"), (jax_dwconv, "fused_dwconv3d"))


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Pallas in interpret mode; the prior's transposed LN+MLP kernels one
    position per grid step (their tiling, not their arithmetic), which cuts
    the interpreter's trace and compile several-fold, as in
    test_torch_prior_options."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
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


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close_to_scale(got, want, rel=1e-4, floor=1.0):
    want = np.asarray(want)
    scale = max(floor, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("B,H,Nq,k_shape,R", [
    (1, 2, 40, (2, 3, 4), 27),   # Da = 96 + 27 = 123
    (2, 1, 70, (2, 4, 6), 46),   # Da = 96 + 46 = 142, ragged against the tiles
    (1, 1, 36, (1, 2, 49), 52),  # Da = 148: 256x448's width, the wide form
    (1, 2, 20, (1, 1, 64), 66),  # Da = 162: 288x640's width
    (1, 2, 24, (2, 2, 9), 13),   # Da = 109: 64x96's width, below the 128-lane form's 113
    (1, 1, 20, (1, 3, 84), 88),  # Da = 184: 512x768's width, the 192-lane form
    (1, 1, 18, (1, 2, 157), 160),  # Da = 256: the widest form
])
def test_attention_matches_pallas(rng, B, H, Nq, k_shape, R):
    """Row 6 on q_aug/k_aug at the model's widths (the expansion lanes of
    k_aug are E's 0/1 rows), forward and the gradients of all three
    operands (the JAX custom VJP runs row 7's `_bwd_impl`)."""
    Nk, Da = int(np.prod(k_shape)), 96 + R
    q = _randn(rng, B, H, Nq, Da)
    k = np.concatenate([_randn(rng, B, H, Nk, 96),
                        np.broadcast_to(_randn(rng, Nk, R), (B, H, Nk, R))], -1)
    v, dout = _randn(rng, B, H, Nk, 96), _randn(rng, B, H, Nq, 96)
    want, vjp = jax.vjp(lambda *a: jax_pa.fused_attention(*a, interpret=True),
                        *map(jnp.asarray, (q, k, v)))
    ts = [_t(a, grad=True) for a in (q, k, v)]
    got = PA.attention(*ts)
    _close_to_scale(got.detach().numpy(), want)
    got.backward(_t(dout))
    for t, w in zip(ts, vjp(jnp.asarray(dout))):
        _close_to_scale(t.grad.numpy(), w, floor=0.0)


def test_attention_backward_reference_matches_autograd(rng):
    """Row 7's plain head-major backward (Da != Dv, scale 1) against
    autograd through the plain forward."""
    q, k = _randn(rng, 2, 2, 30, 123), _randn(rng, 2, 2, 20, 123)
    v, dout = _randn(rng, 2, 2, 20, 96), _randn(rng, 2, 2, 30, 96)
    ts = [_t(a, grad=True) for a in (q, k, v)]
    PA.attention_reference(*ts).backward(_t(dout))
    got = PA.attention_backward_reference(*map(_t, (q, k, v, dout)))
    for g, t in zip(got, ts):
        _close_to_scale(g.numpy(), t.grad.numpy(), rel=1e-5, floor=0.0)


@pytest.mark.parametrize("residual", [True, False])
def test_attention_rel_packed_matches_pallas(rng, residual):
    """Row 8 on token-major [B, N, H*D] with 2 heads; its backward is the
    layout change around K1's (row 5) plus dout into dq with the residual."""
    _check_rel_packed(rng, residual, B=2, Nq=30, k_shape=(2, 3, 2))


@pytest.mark.parametrize("residual", [True, False])
def test_attention_rel_packed_wide_rel_matches_pallas(rng, residual):
    """Row 8 at a rel width R = 52, above one 48-column rel tile."""
    _check_rel_packed(rng, residual, B=1, Nq=20, k_shape=(2, 20, 30))


def _check_rel_packed(rng, residual, B, Nq, k_shape):
    heads, D = 2, 16
    Nk, R, C = int(np.prod(k_shape)), sum(k_shape), heads * D
    q, k, v = _randn(rng, B, Nq, C), _randn(rng, B, Nk, C), _randn(rng, B, Nk, C)
    rel, dout = _randn(rng, B, Nq, heads * R), _randn(rng, B, Nq, C)
    E = jnp.asarray(key_expansion(k_shape))
    want, vjp = jax.vjp(lambda *a: jax_pa.fused_attention_rel_packed(
        *a, E, heads=heads, scale=D ** -0.5, residual=residual, interpret=True),
        *map(jnp.asarray, (q, k, v, rel)))
    ts = [_t(a, grad=True) for a in (q, k, v, rel)]
    got = PA.attention_rel_packed(*ts, k_shape, heads, D ** -0.5, residual)
    _close_to_scale(got.detach().numpy(), want)
    got.backward(_t(dout))
    plain = PA.attention_rel_packed_backward_reference(
        *map(_t, (q, k, v, rel)), k_shape, heads, D ** -0.5, residual, _t(dout))
    for t, p, w in zip(ts, plain, vjp(jnp.asarray(dout))):
        _close_to_scale(t.grad.numpy(), w, floor=0.0)
        _close_to_scale(p.numpy(), w, floor=0.0)


@pytest.mark.parametrize("shape", [(2, 4, 8, 10, 16), (1, 3, 6, 6, 96)])
def test_dwconv3d_matches_pallas(rng, shape):
    """Row 18 on channels-last [N, T, H, W, C] at test_pallas_dwconv's MViT
    q-pool form and at the head width 96, forward and both gradients (JAX:
    dx from the Pallas kernel on the flipped kernel, dw from XLA)."""
    x, dy = _randn(rng, *shape), _randn(rng, *shape)
    w = _randn(rng, 3, 3, 3, 1, shape[-1], scale=0.3)  # DHWIO, as the JAX kernel takes it
    want, vjp = jax.vjp(lambda *a: jax_dwconv.fused_dwconv3d(*a, interpret=True),
                        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, grad=True), _t(w.transpose(4, 3, 0, 1, 2), grad=True)
    got = DW.dwconv3d(xt, wt)
    _close_to_scale(got.detach().numpy(), want)
    got.backward(_t(dy))
    dx, dw = vjp(jnp.asarray(dy))
    _close_to_scale(xt.grad.numpy(), dx, floor=0.0)
    _close_to_scale(wt.grad.numpy(), np.asarray(dw).transpose(4, 3, 0, 1, 2), floor=0.0)
    ref_dx, ref_dw = DW.dwconv3d_backward_reference(*map(_t, (x, w.transpose(4, 3, 0, 1, 2),
                                                              dy)))
    _close_to_scale(ref_dx.numpy(), dx, floor=0.0)
    _close_to_scale(ref_dw.numpy(), wt.grad.numpy(), floor=0.0)


# block geometry per option: (dim, dim_out, heads, input_size, thw, stride_q,
# stride_kv), and the calls of each kernel function per forward on the port
# and the JAX side
BLOCKS = {
    "attn_relk": ((16, 32, 2, (2, 8, 8), (2, 4, 6), (1, 2, 2), (1, 4, 4)),
                  {"_attention_fwd": 1}, {"fused_attention": 1}),
    "attn_packed": ((32, 32, 2, (2, 4, 4), (2, 3, 5), (1, 1, 1), (1, 2, 2)),
                    {"_attention_rel_packed_fwd": 1}, {"fused_attention_rel_packed": 1}),
    # stride 1 everywhere: pool_q, pool_k and pool_v all run row 18
    "dwconv": ((32, 32, 2, (2, 4, 4), (2, 3, 5), (1, 1, 1), (1, 1, 1)),
               {"_attention_rel_fwd": 1, "_dwconv3d_fwd": 3},
               {"fused_attention_rel": 1, "fused_dwconv3d": 3}),
}


@pytest.mark.parametrize("option", list(BLOCKS))
def test_multiscale_block_option_matches_flax(rng, monkeypatch, option):
    (dim, dim_out, heads, input_size, thw, stride_q, stride_kv), port_want, jax_want = \
        BLOCKS[option]
    for key, value in ENV[option].items():
        monkeypatch.setenv(key, value)
    port_calls, jax_calls = {}, {}
    count_calls(PORT_FNS, port_calls, monkeypatch)
    count_calls(JAX_FNS, jax_calls, monkeypatch)
    kernel = (3, 3, 3)
    jax_block = jax_mvit.MultiScaleBlock(
        dim=dim, dim_out=dim_out, num_heads=heads, input_size=input_size, mlp_ratio=4.0,
        qkv_bias=True, drop_path=0.0, kernel_q=kernel, kernel_kv=kernel,
        stride_q=stride_q, stride_kv=stride_kv)
    port = mvit.MultiScaleBlock(dim, dim_out, heads, input_size, 4.0, True, kernel, kernel,
                                stride_q, stride_kv, **OPTION[option])
    x = rng.standard_normal((2, int(np.prod(thw)), dim)).astype(np.float32)
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x), thw, False)
    jax_calls.clear()
    want, want_thw = jax.jit(jax_block.apply, static_argnums=(2, 3))(  # counted as it traces
        variables, jnp.asarray(x), thw, False)
    load_port(port, variables)
    with torch.no_grad():
        got, got_thw = port(torch.from_numpy(x), thw)
    assert (port_calls, jax_calls) == (port_want, jax_want)
    assert tuple(got_thw) == tuple(int(t) for t in want_thw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_model_config_layout_options():
    """Every combination JAX's switches allow is a valid config; the
    augmented lanes take precedence over the packed path, as the JAX
    package's `fully_packed` condition requires MSPI_ATTN_RELK=1."""
    default = ModelConfig()
    assert (default.attn_relk, default.attn_packed, default.dwconv) == (True, False, False)
    for relk in (True, False):
        for packed in (True, False):
            for dw in (True, False):
                cfg = get_config("mvitv2s", {"model": {"attn_relk": relk, "attn_packed": packed,
                                                       "dwconv": dw}}).model
                assert (cfg.attn_relk, cfg.attn_packed, cfg.dwconv) == (relk, packed, dw)
    with pytest.raises(ValueError):
        ModelConfig(attn_relk="0")
    attn = mvit.MultiScaleAttention(32, 32, (2, 4, 4), 2, True, (3, 3, 3), (3, 3, 3),
                                    (1, 1, 1), (1, 2, 2), attn_relk=False, attn_packed=True)
    assert not attn.eval()._packed_route((2, 3, 5))
    attn.attn_relk = True
    assert attn._packed_route((2, 3, 5)) and not attn.train()._packed_route((2, 3, 5))


def test_cli_layout_flags():
    """Both CLIs parse the layout flags into the config; without them the
    config is the default."""
    assert inference.config_from_args(inference.parse_args([])) == get_config("mvitv2s")
    cfg = inference.config_from_args(inference.parse_args(
        ["--no_attn_relk", "--attn_packed", "--dwconv"])).model
    assert (cfg.attn_relk, cfg.attn_packed, cfg.dwconv) == (False, True, True)
    default = train_cli.config_from_args(train_cli.parse_args([])).model
    assert (default.attn_relk, default.attn_packed, default.dwconv) == (True, False, False)
    cfg = train_cli.config_from_args(train_cli.parse_args(
        ["--no_attn_relk", "--dwconv", "--resolution", "64", "96"]))
    assert (cfg.model.attn_relk, cfg.model.attn_packed, cfg.model.dwconv,
            cfg.data.resolution) == (False, False, True, (64, 96))


def _small_cfg(options):
    """The four-block MViT (`SHALLOW_MVIT`) AV model at 32x64 with one
    SyncBlock block and 128-wide SimSiam heads, for both packages."""
    cfg = {"data": {"resolution": RES},
           "model": {"mvit": SHALLOW_MVIT, "sync_num_blocks": 1, "simsiam_hidden": 128}}
    return cfg, get_config("mvitv2s", {**cfg, "model": {**cfg["model"], **options}})


def test_av_model_with_all_layout_options_matches_jax(rng, monkeypatch):
    """The AV model (`_small_cfg`) at inference, batch 1, uint8 clips, with
    all three options against JAX under all three switches: the calls of
    each kernel function on both sides, the log-density map within 1e-4 of
    its scale max(1, max|ref|) (the map sits near -8.7, so about 1e-3
    absolute: fp32 sums in another order through the whole model), the AV
    loss within 1e-4.

    Routing: the augmented lanes win over the packed path on both sides, so
    all 4 blocks run row 6. The stride-1 pools are block 0's pool_q and
    block 3's pool_k / pool_v: the port runs row 18 on all three; JAX, whose
    multi-head blocks pool from the packed stream at inference (its default
    MSPI_POOL_PACKED=1, here a fat XLA conv under MSPI_POOL_FAT=1), only on
    block 0's."""
    for key, value in {**ENV["attn_relk"], **ENV["attn_packed"], "MSPI_DWCONV": "1"}.items():
        monkeypatch.setenv(key, value)
    options = {"attn_relk": False, "attn_packed": True, "dwconv": True}
    port_calls, jax_calls = {}, {}
    count_calls(PORT_FNS, port_calls, monkeypatch)
    count_calls(JAX_FNS, jax_calls, monkeypatch)
    cfg, port_cfg = _small_cfg(options)
    with skipped_init():
        port = AudioVisualSaliencyModel(port_cfg, device="cpu")
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    jax_model = JaxModel(cfg=jax_get_config("mvitv2s", cfg))
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips),
                                               jnp.asarray(auds))
    jax.clear_caches()
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert port_calls == {"_attention_fwd": 4, "_dwconv3d_fwd": 3}
    assert jax_calls == {"fused_attention": 4, "fused_dwconv3d": 1}
    assert got.shape == (1, *RES)
    _close_to_scale(got.numpy(), want)
    assert abs(float(got_loss) - float(want_loss)) < 1e-4


def test_relk0_train_step_grads_match_jax(rng, monkeypatch):
    """One training step of the AV model (`_small_cfg`) with attn_relk=False
    and dwconv, batch 2, fp32, against `jax.value_and_grad` of the JAX
    engine's loss under MSPI_ATTN_RELK=0 and MSPI_DWCONV=1 (in training the
    JAX pools are per head, so row 18 serves all three stride-1 pools on
    both sides): 4 row-6 and 3 row-18 forwards, their backwards through
    rows 7 and 18 (dx) on both sides. Drop-path is made deterministic on
    both sides. Loss and aux within 1e-4, each gradient within 2e-3 of its
    own largest magnitude with `test_torch_train`'s ReLU-boundary allowance
    (fp32, two frameworks summing in different orders)."""
    monkeypatch.setenv("MSPI_ATTN_RELK", "0")
    monkeypatch.setenv("MSPI_DWCONV", "1")
    monkeypatch.setattr(jax_mvit, "DropPath", FixedDropPathJax)
    monkeypatch.setattr(layers.DropPath, "forward", fixed_drop_path_port)
    port_calls, jax_calls = {}, {}
    count_calls(PORT_FNS, port_calls, monkeypatch)
    count_calls(JAX_FNS, jax_calls, monkeypatch)
    cfg, port_cfg = _small_cfg({"attn_relk": False, "dwconv": True})
    with skipped_init():
        port = AudioVisualSaliencyModel(port_cfg, device="cpu")
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    batch = make_batch(rng, 2, 16, RES, (257, 111))
    jcfg = jax_get_config("mvitv2s", cfg)
    jmodel = JaxModel(cfg=jcfg)
    trainable, frozen = jax_engine.split_frozen(variables["params"])
    grad_fn = jax.jit(jax.value_and_grad(jax_engine._make_loss_fn(jmodel, 1.0, True),
                                         has_aux=True))
    args = (trainable, frozen, variables["batch_stats"], jax.tree.map(jnp.asarray, batch),
            jax.random.PRNGKey(1))

    def jax_run():
        (_, (aux, _)), grads = compile_fast(grad_fn, *args)(*args)
        return aux, jax.tree.map(np.asarray, grads)

    aux, grads = jax_run()
    jax.clear_caches()
    state = engine.create_train_state(port_cfg, load_port(port, variables))
    got = engine.make_train_step(1.0)(state, engine.to_device(batch, "cpu"), 1e-4)
    assert port_calls == {"_attention_fwd": 4, "_dwconv3d_fwd": 6}  # 3 forward + 3 dx
    assert jax_calls == {"fused_attention": 4, "fused_dwconv3d": 3}
    for k in ("kl", "cc", "sim", "loss_va", "loss"):
        assert abs(got[k] - float(aux[k])) <= 1e-4, (k, got[k], float(aux[k]))
    params = dict(port.named_parameters())
    _assert_leaves_close({n: params[n].grad for n in state.param_names},
                         dict(state_dict_from_jax({"params": grads})), 2e-3, "grad")
