"""The port's X3D-L slice against the JAX package on the CPU:

- `X3DTransform` (with and without SE) and `ResBlock` (projection shortcut,
  stride 2) against their flax modules, at eval and in train mode (batch
  statistics; every BatchNorm's running statistics after the call);
- `X3DFeatures` on a small `X3DConfig` (depth_factor 0.4: 1, 1, 2 and 2
  blocks a stage, X3D-L's widths) at 16x64x96, in both BatchNorm modes, and
  the converter both ways: `convert_state_dict` of the port's state dict is
  the flax module's whole variable tree, leaf for leaf and shape for shape;
- the x3dl AudioVisualSaliencyModel forward at 64x96 on that backbone, the
  JAX side on its plain path (Pallas off), with the port's SyncBlock K4 and
  K2 calls and the decoder's K2 calls counted;
- the config tables, the SyncBlock's tokens (1344 at 224x384: X3D keeps T
  = 16), lateral stride 4, `remat` accepted and ignored, and both CLIs'
  `--motion_encoder x3dl`.

Weights are seeded variables over the JAX module's tree, moved into the port
by `state_dict_from_jax` (strict). Tolerances (fp32) are stated per test;
the whole-model one is the flagship's (`tests/test_torch_slice.py`: atol
5e-4, rtol 1e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mspi_tpu.models.resnet3d as jax_resnet3d
import mspi_tpu.models.x3d as jax_x3d
from mspi_tpu.config import X3DConfig as JaxX3DConfig
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import X3DConfig, get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import fusion, resnet3d, x3d
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.train import __main__ as train_cli
from tests.torch_port_utils import (count_calls, cpu_share, jax_module_variables,  # noqa: F401
                                    jit_fast, load_port, seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (64, 96)
TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = {"depth_factor": 0.4}  # 1, 1, 2, 2 blocks a stage


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


def _check(jax_module, port, variables, x, train, tol):
    """The port against the flax module (jitted) on x; in train mode also every
    BatchNorm's running statistics after the call."""
    if train:
        want, upd = jax.jit(functools.partial(jax_module.apply, train=True,
                                              mutable=["batch_stats"]))(variables, jnp.asarray(x))
        port.train()
        got = port(torch.from_numpy(x))
        stats = state_dict_from_jax({"batch_stats": upd["batch_stats"]})
        sd = port.state_dict()
        for k, v in stats.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TOL, err_msg=k)
    else:
        want = jit_fast(jax_module.apply, variables, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    return got, want


def test_x3d_av_model_matches_jax(rng, monkeypatch):
    """The x3dl AudioVisualSaliencyModel (depth_factor 0.4) at 64x96, batch
    1, uint8 clips, JAX on its plain path; the SyncBlock's 3 K4 and 3 K2
    calls and the decoder's 4 K2 calls on the port's side. atol 5e-4, rtol
    1e-3 on the log-density map, 1e-4 on the loss."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    overrides = {"data": {"resolution": RES}, "model": {"x3d": SMALL}}
    port = AudioVisualSaliencyModel(get_config("x3dl", overrides), device="cpu")
    jax_model = JaxModel(cfg=jax_get_config("x3dl", overrides=overrides))
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips), jnp.asarray(auds))
    calls = {}
    count_calls(((PA, "_self_attention_fwd"), (K2, "ln_mlp"), (fusion, "ln_mlp")), calls,
                monkeypatch)
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert calls == {"_self_attention_fwd": 3, "ln_mlp": 3 + 4}
    assert got.shape == (1, *RES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    assert abs(float(got_loss) - float(want_loss)) < 1e-4


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("block_idx,stride,dims", [(0, 2, (24, 48, 108)), (1, 1, (48, 48, 108))])
def test_resblock_matches_flax(rng, train, block_idx, stride, dims):
    """A ResBlock of X3DTransform at X3D-L's stage-3 widths on [2, 4, 8, 10,
    C]: block 0 with SE, the stride-2 channelwise conv and the projection
    shortcut; block 1 without SE, stride 1, the identity shortcut."""
    dim_in, dim_out, dim_inner = dims
    jax_block = jax_resnet3d.ResBlock(dim_in, dim_out, 3, stride, "x3d_transform", dim_inner,
                                      dim_inner, block_idx=block_idx)
    x = rng.standard_normal((2, 4, 8, 10, dim_in)).astype(np.float32)
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x))
    port = resnet3d.ResBlock(dim_in, dim_out, 3, stride, "x3d_transform", dim_inner,
                             dim_inner, block_idx=block_idx)
    assert hasattr(port, "branch1") == (stride != 1)
    assert hasattr(port.branch2, "se") == (block_idx % 2 == 0)
    got, want = _check(jax_block, load_port(port, variables), variables, x, train, TOL)
    assert got.shape == (2, 4, 8 // stride, 10 // stride, dim_out)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_x3d_transform_matches_flax(rng, train):
    """X3DTransform alone (SE, t = 3, 24 -> 54 -> 24) on [2, 6, 8, 8, 24]."""
    jax_t = jax_resnet3d.X3DTransform(24, 24, 3, 1, 54, 54, block_idx=0)
    x = rng.standard_normal((2, 6, 8, 8, 24)).astype(np.float32)
    variables = jax_module_variables(jax_t, rng, jnp.asarray(x))
    port = load_port(resnet3d.X3DTransform(24, 24, 3, 1, 54, 54, block_idx=0), variables)
    got, want = _check(jax_t, port, variables, x, train, TOL)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_x3d_features_match_flax(rng, train):
    """X3DFeatures (depth_factor 0.4) at 16x64x96: pyramid (24, 48, 96,
    192) at T 16 and strides 4-32, each level within atol 2e-4, rtol 1e-3;
    the converter maps the port's every key onto the flax tree and back."""
    port = x3d.X3DFeatures(X3DConfig(**SMALL))
    jax_model = jax_x3d.X3DFeatures(cfg=JaxX3DConfig(**SMALL))
    x = rng.standard_normal((1, 16, *RES, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    converted = convert_state_dict(port.state_dict())
    assert dict(_leaves(converted)) == dict(_leaves(jax.tree.map(lambda s: s, shapes)))
    variables = seeded_variables(shapes, rng)
    assert set(state_dict_from_jax(variables)) == set(port.state_dict())
    got, want = _check(jax_model, load_port(port, variables), variables, x, train,
                       dict(atol=2e-4, rtol=1e-3))
    for g, w, c, s in zip(got, want, (24, 48, 96, 192), (4, 8, 16, 32)):
        assert tuple(g.shape) == tuple(w.shape) == (1, 16, RES[0] // s, RES[1] // s, c)
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=2e-4, rtol=1e-3)


def test_x3d_config_matches_jax():
    got, want = get_config("x3dl"), jax_get_config("x3dl")
    assert got.model.motion_encoder == want.model.motion_encoder == "x3dl"
    for prop in ("embed_dims", "pyramid_tdims", "lateral_bool", "lateral_stride"):
        assert getattr(got.model, prop) == getattr(want.model, prop), prop
    assert got.model.lateral_stride == (4, 4, 4, 4)
    for f in dataclasses.fields(X3DConfig):
        assert getattr(got.model.x3d, f.name) == getattr(want.model.x3d, f.name), f.name
    for res, n in (((224, 384), 1344), (RES, 96)):
        o = {"data": {"resolution": res}}
        assert get_config("x3dl", o).num_vis_tokens() == \
            jax_get_config("x3dl", overrides=o).num_vis_tokens() == n
    blocks = x3d.X3DFeatures(X3DConfig())
    assert [len(list(getattr(blocks, f"s{s}").children())) for s in (2, 3, 4, 5)] == \
        [5, 10, 25, 15]
    assert get_config("x3dl", {"model": {"remat": True}}).model.remat is True


def test_x3d_clis_and_int8():
    """Both CLIs take --motion_encoder x3dl; quant="int8" is taken (only the
    SyncBlock's C = 512 reaches row 12)."""
    args = inference.parse_args(["--motion_encoder", "x3dl", "--quant", "int8"])
    assert inference.config_from_args(args).model.motion_encoder == "x3dl"
    cfg = train_cli.config_from_args(train_cli.parse_args(["--motion_encoder", "x3dl",
                                                           "--remat"]))
    assert cfg.model.motion_encoder == "x3dl" and cfg.model.remat
