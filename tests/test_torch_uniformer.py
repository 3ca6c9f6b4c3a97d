"""The port's UniFormer-B slice against the JAX package on the CPU.

- K4 at head dim 64 (UniFormer-B's heads) and its gradients against
  `fused_self_attention(interpret=True)` and `jax.grad` of it;
- `Attention`, `SABlock`, `SplitSABlock` and `CBlock` against their flax
  modules with the JAX side's Pallas kernels on in interpret mode, the K4
  and K2 calls counted on both sides;
- `UniFormerFeatures` at the full widths (64, 128, 320, 512) and depths
  (1, 1, 1, 1) at 16x64x96, and with `split=True`;
- the `uniformerb` AudioVisualSaliencyModel forward at 64x96;
- one training step of that model (loss, aux, gradients, BatchNorm
  statistics) against `jax.value_and_grad` of the JAX engine's loss;
- the config tables, `quant="int8"` taken at config time, the int8 model
  (row 12 at C = 320 and 512) against JAX under MSPI_QUANT=int8 with its
  routing counted, and both CLIs' `--motion_encoder`.

Weights are seeded variables over the JAX module's tree, moved into the port
by `state_dict_from_jax` (strict). Tolerances (fp32) are stated per test;
the whole-model ones are the flagship's (`tests/test_torch_slice.py`: atol
5e-4, rtol 1e-3).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mspi_tpu.models.uniformer as jax_uni
from mspi_tpu import config as jax_config
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu.ops.pallas import mlp as jax_mlp
from mspi_tpu.ops.pallas import pooled_attention as jax_pa
from mspi_tpu.train import engine as jax_engine
from mspi_tpu_torch import config, inference
from mspi_tpu_torch.config import UniFormerConfig, get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import uniformer
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels, layers
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.train import engine
from mspi_tpu_torch.train.__main__ import parse_args as train_parse_args
from mspi_tpu_torch.train.synthetic import make_batch
from tests.torch_port_utils import (compile_fast, count_calls, cpu_share, jax_module_variables,
                                    jit_fast, load_port, seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (64, 96)
SHALLOW = {"uniformer": {"depth": (1, 1, 1, 1)}}
TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=5e-4, rtol=1e-3)
# K4 and K2 on both sides: the port's kernel functions (on the CPU, the gate
# to each plain version) and the JAX package's Pallas entry points
PORT_FNS = ((PA, "_self_attention_fwd"), (K2, "ln_mlp"))
JAX_FNS = ((jax_pa, "fused_self_attention"), (jax_mlp, "fused_ln_mlp"))


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


@pytest.fixture(scope="module", autouse=True)
def free_jax_programs():
    yield
    jax.clear_caches()


def test_uniformer_train_step_matches_jax(rng, monkeypatch):
    """One fp32 training step of the one-block-a-stage uniformerb model at
    64x96, batch 2 (train-mode BatchNorm in the CBlocks, drop-path made
    deterministic on both sides), against `jax.value_and_grad` of the JAX
    engine's loss from the same variables: loss and aux within 1e-4, the
    gradient norm within 1e-3 relative and the cosine of the whole gradient
    vectors >= 0.9999; each backbone gradient (`visnet.*`, this slice's
    parameters) within 2e-3 of its own largest magnitude and the backbone's
    BatchNorm statistics within 1e-4 of theirs (the ReLU-boundary allowance
    of `test_torch_train`). The shared decoder is held leaf by leaf in
    `test_torch_train.test_train_step_matches_jax`: at this seed the
    adapter's train-mode BatchNorms over the frozen prior's features amplify
    the two frameworks' rounding in a few of its leaves (branch1's conv_t
    weight to 13% of its scale), which its whole-vector cosine here still
    bounds."""
    from tests.test_torch_train import _assert_leaves_close

    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    monkeypatch.setattr(jax_uni, "DropPath", _FixedDropPathJax)
    monkeypatch.setattr(layers.DropPath, "forward", _fixed_drop_path_port)
    cfg, port, variables = _port_av(rng)
    jcfg = jax_get_config("uniformerb", overrides={"data": {"resolution": RES}, "model": SHALLOW})
    jmodel = JaxModel(cfg=jcfg)
    batch = make_batch(rng, 2, 16, RES, (257, 111))
    batch["clips"] = (batch["clips"] * 255).astype(np.uint8)
    params = {k: v for k, v in variables["params"].items()
              if k not in jax_engine.FROZEN_TOPLEVEL}
    frozen = {k: v for k, v in variables["params"].items() if k in jax_engine.FROZEN_TOPLEVEL}
    grad_fn = jax.value_and_grad(jax_engine._make_loss_fn(jmodel, 1.0, True), has_aux=True)
    args = (params, frozen, variables["batch_stats"], jax.tree.map(jnp.asarray, batch),
            jax.random.PRNGKey(1))

    def jax_run():
        def with_norm(*a):
            out, grads = grad_fn(*a)
            return out, grads, jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)))

        (_, (aux, new_bs)), grads, grad_norm = compile_fast(jax.jit(with_norm), *args)(*args)
        return ({k: float(v) for k, v in aux.items()}, float(grad_norm),
                jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new_bs))

    aux, grad_norm, grads, new_bs = jax_run()
    jax.clear_caches()
    load_port(port, variables)
    state = engine.create_train_state(cfg, port)
    got = engine.make_train_step(1.0)(state, engine.to_device(batch, "cpu"), 1e-4)
    for k in ("kl", "cc", "sim", "loss_va", "loss"):
        assert abs(got[k] - aux[k]) <= 1e-4, (k, got[k], aux[k])
    assert abs(got["grad_norm"] - grad_norm) <= 1e-3 * grad_norm
    named = dict(port.named_parameters())
    want_grads = dict(state_dict_from_jax({"params": grads}))
    assert set(want_grads) == set(state.param_names)
    a, b = (torch.cat([t.double().flatten() for t in ts]) for ts in (
        [named[n].grad for n in state.param_names], [want_grads[n] for n in state.param_names]))
    assert float(a @ b / (a.norm() * b.norm())) >= 0.9999
    backbone = [n for n in state.param_names if n.startswith("visnet.")]
    _assert_leaves_close({n: named[n].grad for n in backbone},
                         {n: want_grads[n] for n in backbone}, 2e-3, "grad")
    want_bs = {k: v for k, v in state_dict_from_jax({"batch_stats": new_bs}).items()
               if k.startswith("visnet.") and not k.endswith("num_batches_tracked")}
    assert any(k.startswith("visnet.blocks1") for k in want_bs)  # the CBlocks' statistics
    _assert_leaves_close({k: port.state_dict()[k] for k in want_bs}, want_bs, 1e-4, "stats")


def test_uniformer_int8_av_model_matches_jax(rng, monkeypatch):
    """The uniformerb AudioVisualSaliencyModel (one block a stage, one
    SyncBlock block) at 64x96, batch 1, with quant="int8", against JAX under
    MSPI_QUANT=int8 with every Pallas kernel in interpret mode.

    Routing: both sides send the stage-3 SABlock (C = 320), the stage-4 one
    (C = 512) and the SyncBlock block to the int8 kernel, 3 calls; the
    decoder's LN+MLPs stay on K2. The map is held as the MViT int8 model is
    (`tests/test_torch_prior_options.py`): the port's int8 map lies closer to
    JAX's int8 map than to its own float map, CC 0.9999 against JAX's, the
    loss within 1e-3."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MSPI_QUANT", "int8")
    jax_calls, port_calls = {}, {}
    count_calls(((jax_mlp, "fused_ln_mlp_int8"),), jax_calls, monkeypatch)
    count_calls(((K2, "ln_mlp_int8_reference"),), port_calls, monkeypatch)
    model = {**SHALLOW, "sync_num_blocks": 1, "simsiam_hidden": 128}
    cfg, port, variables = _port_av(rng, {**model, "quant": "int8"})
    _, flt_port, _ = _port_av(rng, model)
    assert sum(hasattr(m, "int8_w1q") for m in port.modules()) == 3
    jax_model = JaxModel(cfg=jax_get_config("uniformerb", overrides={
        "data": {"resolution": RES}, "model": model}))
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips), jnp.asarray(auds))
    jax.clear_caches()
    assert jax_calls == {"fused_ln_mlp_int8": 3}
    load_port(port, variables)
    load_port(flt_port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
        assert port_calls == {"ln_mlp_int8_reference": 3}
        flt, _ = flt_port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert got.shape == (1, *RES)
    want = np.asarray(want, np.float64)
    got, flt = got.double().numpy(), flt.double().numpy()

    def rms(a):  # log-densities: about their means
        return np.sqrt(np.mean((a - a.mean()) ** 2))
    assert rms(got - want) <= rms(got - flt)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.9999
    assert abs(float(got_loss) - float(want_loss)) < 1e-3


def test_k4_head_dim_64_matches_pallas(rng):
    """K4 at D = 64 (C 128, 2 heads; N = 200, off the kernels' tiles): the
    port's function (its plain version on the CPU) and its gradients
    against the Pallas kernel in interpret mode and jax.grad of it."""
    B, N, C, H = 2, 200, 128, 2
    q, kv, w = (rng.standard_normal(s).astype(np.float32)
                for s in ((B, N, C), (B, N, 2 * C), (B, N, C)))

    def loss(qj, kvj):
        return jnp.sum(jax_pa.fused_self_attention(qj, kvj, num_heads=H, interpret=True) * w)

    want = jax_pa.fused_self_attention(jnp.asarray(q), jnp.asarray(kv), num_heads=H,
                                       interpret=True)
    want_dq, want_dkv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))
    qt, kvt = (torch.from_numpy(a).requires_grad_() for a in (q, kv))
    got = PA.self_attention(qt, kvt, H)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want_dq), **TOL)
    np.testing.assert_allclose(kvt.grad.numpy(), np.asarray(want_dkv), **TOL)
    assert PA.self_bwd_form(64) == "kv_registers"


BLOCKS = {  # module, flax module, port module, x shape, (port calls, JAX calls)
    "attention": (lambda j: j.Attention(dim=128, num_heads=2), lambda: uniformer.Attention(128, 2),
                  (2, 48, 128), ({"_self_attention_fwd": 1}, {"fused_self_attention": 1})),
    "sablock": (lambda j: j.SABlock(dim=128, num_heads=2), lambda: uniformer.SABlock(128, 2),
                (2, 2, 4, 6, 128), ({"_self_attention_fwd": 1, "ln_mlp": 1},
                                    {"fused_self_attention": 1, "fused_ln_mlp": 1})),
    # the temporal attention (N = T = 2 tokens per location) and the spatial
    # one; its MLP runs plain on both sides
    "splitsablock": (lambda j: j.SplitSABlock(dim=128, num_heads=2),
                     lambda: uniformer.SplitSABlock(128, 2), (2, 2, 4, 6, 128),
                     ({"_self_attention_fwd": 2}, {"fused_self_attention": 2})),
    "cblock": (lambda j: j.CBlock(dim=64), lambda: uniformer.CBlock(64), (2, 4, 6, 8, 64),
               ({}, {})),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(rng, monkeypatch, name):
    """Each kernel-holding module (and the CBlock) at eval against its flax
    module, Pallas in interpret mode, every K4 and K2 call counted on both
    sides."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    jax_fn, port_fn, shape, (port_want, jax_want) = BLOCKS[name]
    port_calls, jax_calls = {}, {}
    count_calls(PORT_FNS, port_calls, monkeypatch)
    count_calls(JAX_FNS, jax_calls, monkeypatch)
    jax_mod = jax_fn(jax_uni)
    x = rng.standard_normal(shape).astype(np.float32)
    variables = jax_module_variables(jax_mod, rng, jnp.asarray(x))
    jax_calls.clear()
    want = jax_mod.apply(variables, jnp.asarray(x))
    port = load_port(port_fn(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert (port_calls, jax_calls) == (port_want, jax_want)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("split", [False, True])
def test_uniformer_features_match_flax(rng, monkeypatch, split):
    """Full widths (64, 128, 320, 512, head dim 64), one block a stage, at
    16x64x96 (stage 3: N = 8 * 4 * 6 = 192 tokens, 5 heads): JAX with its
    Pallas kernels in interpret mode (K4 at N <= 4096 and K2), K4 and K2
    calls counted on both sides; split=True runs the divided-attention
    blocks. atol 2e-4, rtol 1e-3."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    cfg = UniFormerConfig(depth=(1, 1, 1, 1), split=split)
    jax_model = jax_uni.UniFormerFeatures(
        cfg=dataclasses.replace(jax_config.UniFormerConfig(), depth=(1, 1, 1, 1), split=split))
    port = uniformer.UniFormerFeatures(cfg)
    x = rng.standard_normal((1, 16, *RES, 3)).astype(np.float32)
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    port_calls, jax_calls = {}, {}
    count_calls(PORT_FNS, port_calls, monkeypatch)
    count_calls(JAX_FNS, jax_calls, monkeypatch)
    want = jit_fast(jax_model.apply, variables, jnp.asarray(x))  # counted as it traces
    jax.clear_caches()
    load_port(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    k4 = 4 if split else 2
    assert port_calls == {"_self_attention_fwd": k4, **({} if split else {"ln_mlp": 2})}
    assert jax_calls == {"fused_self_attention": k4, **({} if split else {"fused_ln_mlp": 2})}
    for g, w, c, t in zip(got, want, cfg.embed_dim, (8, 8, 8, 8)):
        assert g.shape == (1, t, *w.shape[2:4], c) and tuple(w.shape) == tuple(g.shape)
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=2e-4, rtol=1e-3)


def _port_av(rng, overrides=SHALLOW, res=RES):
    cfg = get_config("uniformerb", {"data": {"resolution": res}, "model": overrides})
    port = AudioVisualSaliencyModel(cfg, device="cpu")
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    return cfg, port, variables


def test_uniformer_av_model_matches_jax(rng, monkeypatch):
    """The whole uniformerb AudioVisualSaliencyModel at 64x96, batch 1,
    uint8 clips, one block a stage; JAX on its default CPU path (Pallas
    off). atol 5e-4, rtol 1e-3 on the log-density map, 1e-4 on the loss."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    cfg, port, variables = _port_av(rng)
    jax_model = JaxModel(cfg=jax_get_config("uniformerb", overrides={
        "data": {"resolution": RES}, "model": SHALLOW}))
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips), jnp.asarray(auds))
    jax.clear_caches()
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert got.shape == (1, *RES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert abs(float(got_loss) - float(want_loss)) < 1e-4


class _FixedDropPathJax(fnn.Module):
    """Drop-path with a fixed mask: in train mode, blocks with rate > 0.05
    drop sample 1 (stages 3-4 of the one-block-a-stage model), every kept
    sample is scaled by 1 / (1 - rate)."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        if deterministic or self.rate == 0.0:
            return x
        mask = np.array([not (b == 1 and self.rate > 0.05) for b in range(x.shape[0])])
        mask = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(mask, x / (1.0 - self.rate), jnp.zeros_like(x))


def _fixed_drop_path_port(self, x):
    if not self.training or self.rate == 0.0:
        return x
    mask = torch.tensor([not (b == 1 and self.rate > 0.05) for b in range(x.shape[0])])
    mask = mask.view(-1, *([1] * (x.dim() - 1)))
    return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


def test_uniformer_config_matches_jax():
    """The motion-encoder tables, the backbone config and the SyncBlock's
    token count against `mspi_tpu.config`."""
    got, want = get_config("uniformerb"), jax_get_config("uniformerb")
    assert got.model.motion_encoder == want.model.motion_encoder == "uniformerb"
    assert (got.model.embed_dims, got.model.pyramid_tdims, got.model.lateral_bool) == \
        (want.model.embed_dims, want.model.pyramid_tdims, want.model.lateral_bool)
    for f in dataclasses.fields(UniFormerConfig):
        assert getattr(got.model.uniformer, f.name) == getattr(want.model.uniformer, f.name)
    for res in ((224, 384), RES):
        o = {"data": {"resolution": res}}
        assert get_config("uniformerb", o).num_vis_tokens() == \
            jax_get_config("uniformerb", overrides=o).num_vis_tokens()
    for table in ("MOTION_ENCODER_EMBEDS", "MOTION_ENCODER_TDIMS", "LATERAL_BOOL"):
        for enc in config.MOTION_ENCODERS:
            assert getattr(config, table)[enc] == getattr(jax_config, table)[enc], (table, enc)


def test_uniformer_int8_taken_at_config():
    """quant="int8" sends stages 3-4's SABlocks (C = 320 and 512) to row 12,
    which has a C = 320 form: the config takes it, and so do both CLIs."""
    assert 320 in K2.INT8_C
    assert get_config("uniformerb", {"model": {"quant": "int8"}}).model.quant == "int8"
    cfg = inference.config_from_args(inference.parse_args(
        ["--motion_encoder", "uniformerb", "--quant", "int8"]))
    assert (cfg.model.motion_encoder, cfg.model.quant) == ("uniformerb", "int8")
    assert get_config("s3d", {"model": {"quant": "int8"}}).model.quant == "int8"


def test_clis_take_uniformerb():
    args = inference.parse_args(["--motion_encoder", "uniformerb", "--bf16"])
    assert args.motion_encoder == "uniformerb"
    assert train_parse_args(["--motion_encoder", "uniformerb"]).motion_encoder == "uniformerb"
