"""The port's MorphMLP-S slice against the JAX package on the CPU:

- `MorphFC_T`, `MorphFC_S`, `MorphFC_S2` and `PermutatorBlock` against
  their flax modules on a non-square [2, 8, 4, 12, 32] (an H/W mix-up in
  the H branch's swap would show), and `PatchEmbed` at eval and in train
  mode (its BatchNorms' running statistics after the call);
- `MorphMLPFeatures` at the published widths and segment dims (14, 28, 28,
  49) with one block a stage at 16x224x224, the smallest resolution at
  which the published segments divide, and the converter both ways;
- the morphmlps AudioVisualSaliencyModel at 16x64x128 with segment_dim (8,
  8, 8, 4), which divides there, the JAX side on its plain path, with the
  port's SyncBlock K4 and K2 calls and the decoder's K2 calls counted;
- the ValueError at 224x384, where stage 4 has 84 tokens, not a multiple of
  49 (the JAX model fails there in a reshape, shown by `jax.eval_shape`);
- the config tables, the SyncBlock's tokens (392 + 36 at 224x224), and both
  CLIs' `--motion_encoder morphmlps`.

Weights are seeded variables over the JAX module's tree, moved into the port
by `state_dict_from_jax` (strict). Tolerances (fp32) are stated per test;
the whole-model one is the flagship's (`tests/test_torch_slice.py`: atol
5e-4, rtol 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mspi_tpu.models.morphmlp as jax_morph
from mspi_tpu.config import MorphMLPConfig as JaxMorphMLPConfig
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import MorphMLPConfig, get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import fusion, morphmlp
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.train import __main__ as train_cli
from tests.torch_port_utils import (count_calls, cpu_share, jax_module_variables,  # noqa: F401
                                    jit_fast, load_port, seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

TOL = dict(atol=1e-4, rtol=1e-4)
AV_RES = (64, 128)
AV_MORPH = {"layers": (1, 1, 1, 1), "segment_dim": (8, 8, 8, 4)}


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


@pytest.fixture(scope="module", autouse=True)
def free_jax_programs():
    yield
    jax.clear_caches()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


MODULES = {
    "MorphFC_T": lambda m: m.MorphFC_T(32),
    "MorphFC_S": lambda m: m.MorphFC_S(32, 4),
    "MorphFC_S2": lambda m: m.MorphFC_S2(32, 4),
    "PermutatorBlock": lambda m: m.PermutatorBlock(32, 4, 3.0),
    "PermutatorBlock_stage4": lambda m: m.PermutatorBlock(32, 4, 3.0, stage4=True),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_morph_module_matches_flax(rng, name):
    """Each token-mixing module and the block (dim 32, segment_dim 4) on
    [2, 8, 4, 12, 32]: T = 8 as MorphFC_T needs, H != W, 48 positions
    (12 chunks of 4; stage 4's strided chunks too). atol 1e-4, rtol 1e-4."""
    jax_m = MODULES[name](jax_morph)
    x = rng.standard_normal((2, 8, 4, 12, 32)).astype(np.float32)
    variables = jax_module_variables(jax_m, rng, jnp.asarray(x))
    port = load_port(MODULES[name](morphmlp), variables)
    want = jax_m.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_patch_embed_matches_flax(rng, train):
    """PatchEmbed (112) on [2, 16, 20, 28, 3]: T / 2, H and W / 4; in train
    mode its two BatchNorms' running statistics. atol 1e-4, rtol 1e-4."""
    jax_m = jax_morph.PatchEmbed(112)
    x = rng.standard_normal((2, 16, 20, 28, 3)).astype(np.float32)
    variables = jax_module_variables(jax_m, rng, jnp.asarray(x))
    port = load_port(morphmlp.PatchEmbed(112), variables)
    if train:
        want, upd = jax_m.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        got = port.train()(torch.from_numpy(x))
        sd = port.state_dict()
        for k, v in state_dict_from_jax({"batch_stats": upd["batch_stats"]}).items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TOL, err_msg=k)
    else:
        want = jax_m.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    assert got.shape == (2, 8, 5, 7, 112)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_morphmlp_features_match_flax(rng):
    """MorphMLPFeatures at the published widths (112, 224, 392, 784) and
    segment dims (14, 28, 28, 49), one block a stage, at 16x224x224 (the
    smallest resolution at which those segments divide): each level within
    atol 2e-4, rtol 1e-3, T 8 at strides 4-32; the converter maps the
    port's every key onto the flax tree and back."""
    cfg = {"layers": (1, 1, 1, 1)}
    port = morphmlp.MorphMLPFeatures(MorphMLPConfig(**cfg))
    jax_model = jax_morph.MorphMLPFeatures(cfg=JaxMorphMLPConfig(**cfg))
    x = rng.standard_normal((1, 16, 224, 224, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    converted = convert_state_dict(port.state_dict())
    assert dict(_leaves(converted)) == dict(_leaves(jax.tree.map(lambda s: s, shapes)))
    variables = seeded_variables(shapes, rng)
    assert set(state_dict_from_jax(variables)) == set(port.state_dict())
    assert "blocks1.0.t_fc.mlp_t.weight" in port.state_dict()
    assert "blocks4.0.fc.reweight.fc1.weight" in port.state_dict()
    want = jit_fast(jax_model.apply, variables, jnp.asarray(x))
    with torch.no_grad():
        got = load_port(port, variables)(torch.from_numpy(x))
    for g, w, c, s in zip(got, want, (112, 224, 392, 784), (4, 8, 16, 32)):
        assert tuple(g.shape) == tuple(w.shape) == (1, 8, 224 // s, 224 // s, c)
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=2e-4, rtol=1e-3)


def test_morphmlp_av_model_matches_jax(rng, monkeypatch):
    """The morphmlps AudioVisualSaliencyModel (one block a stage,
    segment_dim (8, 8, 8, 4)) at 16x64x128, batch 1, uint8 clips, JAX on
    its plain path; the SyncBlock's 3 K4 and 3 K2 calls and the decoder's 4
    K2 calls on the port's side (the backbone's block MLPs are plain). atol
    5e-4, rtol 1e-3 on the log-density map, 1e-4 on the loss."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    overrides = {"data": {"resolution": AV_RES}, "model": {"morph": AV_MORPH}}
    port = AudioVisualSaliencyModel(get_config("morphmlps", overrides), device="cpu")
    jax_model = JaxModel(cfg=jax_get_config("morphmlps", overrides=overrides))
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    clips = rng.integers(0, 256, (1, 16, *AV_RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips), jnp.asarray(auds))
    calls = {}
    count_calls(((PA, "_self_attention_fwd"), (K2, "ln_mlp"), (fusion, "ln_mlp")), calls,
                monkeypatch)
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert calls == {"_self_attention_fwd": 3, "ln_mlp": 3 + 4}
    assert got.shape == (1, *AV_RES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    assert abs(float(got_loss) - float(want_loss)) < 1e-4


def test_morphmlp_refuses_224x384():
    """At the default 224x384, stage 4 has 7 x 12 = 84 tokens, not a
    multiple of its segment_dim 49: the port's forward raises a ValueError
    naming the condition and the resolution, before any compute; the JAX
    model fails there too (in a reshape, under jax.eval_shape). get_config
    still builds the default config, and 224x224 passes the check."""
    cfg = get_config("morphmlps")
    assert cfg.data.resolution == (224, 384) and cfg.model.morph == MorphMLPConfig()
    with torch.device("meta"):
        port = morphmlp.MorphMLPFeatures(cfg.model.morph)
        x = torch.empty(1, 16, 224, 384, 3)
    with pytest.raises(ValueError, match=r"\(H/32\)\(W/32\).*multiple of stage 4's "
                                         r"segment_dim 49.*224x384 gives 7x12 = 84"):
        port(x)
    port.check_resolution(224, 224)
    jax_model = jax_morph.MorphMLPFeatures(cfg=JaxMorphMLPConfig())
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 16, 224, 384, 3))))


def test_morphmlp_config_matches_jax():
    got, want = get_config("morphmlps"), jax_get_config("morphmlps")
    assert got.model.motion_encoder == want.model.motion_encoder == "morphmlps"
    for prop in ("embed_dims", "pyramid_tdims", "lateral_bool", "lateral_stride"):
        assert getattr(got.model, prop) == getattr(want.model, prop), prop
    for f in dataclasses.fields(MorphMLPConfig):
        assert getattr(got.model.morph, f.name) == getattr(want.model.morph, f.name), f.name
    for res, n in (((224, 224), 392), (AV_RES, 64)):
        o = {"data": {"resolution": res}}
        assert get_config("morphmlps", o).num_vis_tokens() == \
            jax_get_config("morphmlps", overrides=o).num_vis_tokens() == n
    # the SyncBlock's tokens at 224x224: 392 visual + 36 audio
    sync = fusion.SyncBlock(num_blocks=0, num_vis_tokens=get_config(
        "morphmlps", {"data": {"resolution": (224, 224)}}).num_vis_tokens(), vis_in_embed=784)
    assert sync.vis_pos_embed.shape[1] + sync.aud_pos_embed.shape[1] == 428
    with torch.device("meta"):
        full = morphmlp.MorphMLPFeatures(MorphMLPConfig())
    assert [len(getattr(full, f"blocks{s}")) for s in (1, 2, 3, 4)] == [3, 4, 9, 3]
    rates = [b.dp.rate for s in (1, 2, 3, 4) for b in getattr(full, f"blocks{s}")]
    np.testing.assert_allclose(rates, [0.1 * i / 18 for i in range(19)])
    assert get_config("morphmlps", {"model": {"remat": True}}).model.remat is True


def test_morphmlp_clis():
    """Both CLIs take --motion_encoder morphmlps; the training CLI with
    --resolution 224 224, the one at which MorphMLP-S runs."""
    args = inference.parse_args(["--motion_encoder", "morphmlps"])
    assert inference.config_from_args(args).model.motion_encoder == "morphmlps"
    cfg = train_cli.config_from_args(train_cli.parse_args(
        ["--motion_encoder", "morphmlps", "--resolution", "224", "224"]))
    assert cfg.model.motion_encoder == "morphmlps" and cfg.data.resolution == (224, 224)
