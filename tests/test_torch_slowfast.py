"""The port's SlowFast 4x16 R50 slice against the JAX package on the CPU:

- `ResNetBasicStem`, `BottleneckTransform` in a `ResBlock` (Tx1x1 with T 1
  and 3; stride 2 with the projection shortcut, stride 1 with the identity
  and a grouped 1x3x3) and `FuseFastToSlow` against their flax modules, at
  eval and in train mode (batch statistics; every BatchNorm's running
  statistics after the call);
- `Nonlocal` (softmax and dot_product, with and without a pool) and a
  two-pathway `ResStage` with non-local blocks and `nonlocal_group = 2`;
- `SlowFastFeatures` at depth 18 (2, 2, 2, 2 blocks a stage) and the
  published widths at 16x64x96, in both BatchNorm modes (stage s5's fast
  pathway feeds nothing but runs: its statistics move as JAX's do), the
  slow pathway's frames {0, 4, 12, 15}, and the converter both ways;
- the slowfast4x16 AudioVisualSaliencyModel at 32x64 on that backbone, the
  JAX side on its plain path (the T-folded fast pathway is off on the
  CPU), with the port's SyncBlock K4 and K2 calls and the decoder's K2
  calls counted;
- the config tables, the SyncBlock's tokens (336 + 36 at 224x384: the slow
  pathway keeps T = 4), and both CLIs' `--motion_encoder slowfast4x16`.

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

import mspi_tpu.models.nonlocal_block as jax_nonlocal
import mspi_tpu.models.resnet3d as jax_resnet3d
import mspi_tpu.models.slowfast as jax_slowfast
from mspi_tpu.config import SlowFastConfig as JaxSlowFastConfig
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import SlowFastConfig, get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import fusion, nonlocal_block, resnet3d, slowfast
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.train import __main__ as train_cli
from tests.torch_port_utils import (count_calls, cpu_share, jax_module_variables,  # noqa: F401
                                    jit_fast, load_port, seeded_variables, to_np, skipped_init)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (64, 96)
AV_RES = (32, 64)  # the AV model test's input; the backbone tests run at RES
TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = {"depth": 18}  # 2, 2, 2, 2 blocks a stage at the published widths


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
    """The port against the flax module (jitted) on x (an array or a list
    of arrays); in train mode also every BatchNorm's running statistics after
    the call, within tol."""
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    tx = [torch.from_numpy(a) for a in x] if isinstance(x, list) else torch.from_numpy(x)
    if train:
        want, upd = jax.jit(functools.partial(jax_module.apply, train=True,
                                              mutable=["batch_stats"]))(variables, jx)
        port.train()
        got = port(tx)
        stats = state_dict_from_jax({"batch_stats": upd["batch_stats"]})
        sd = port.state_dict()
        for k, v in stats.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **tol, err_msg=k)
    else:
        want = jit_fast(jax_module.apply, variables, jx)
        with torch.no_grad():
            got = port(tx)
    return got, want


@pytest.mark.parametrize("train", [False, True])
def test_basic_stem_matches_flax(rng, train):
    """ResNetBasicStem as SlowFast's fast pathway has it: (5,7,7) / s(1,2,2)
    conv, BN, ReLU, 1x3x3 / s(1,2,2) max-pool with -inf padding, 3 -> 8
    channels on [2, 8, 18, 26, 3] (odd pooled sizes: the pad's edge)."""
    args = (3, 8, (5, 7, 7), (1, 2, 2), (2, 3, 3))
    jax_stem = jax_resnet3d.ResNetBasicStem(*args)
    x = rng.standard_normal((2, 8, 18, 26, 3)).astype(np.float32)
    variables = jax_module_variables(jax_stem, rng, jnp.asarray(x))
    port = load_port(resnet3d.ResNetBasicStem(*args), variables)
    got, want = _check(jax_stem, port, variables, x, train, TOL)
    assert got.shape == (2, 8, 5, 7, 8)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("t,stride,dims,groups", [(1, 2, (64, 256, 64), 1),
                                                  (3, 1, (64, 64, 32), 4)])
def test_bottleneck_block_matches_flax(rng, train, t, stride, dims, groups):
    """ResBlock of BottleneckTransform on [2, 4, 8, 10, C]: t = 1, stride 2
    and the projection shortcut (s2's first slow block, 64 -> 256); t = 3,
    stride 1, the identity shortcut and a 1x3x3 conv in 4 groups."""
    dim_in, dim_out, dim_inner = dims
    jax_block = jax_resnet3d.ResBlock(dim_in, dim_out, t, stride, "bottleneck_transform",
                                      dim_inner, groups)
    x = rng.standard_normal((2, 4, 8, 10, dim_in)).astype(np.float32)
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x))
    port = resnet3d.ResBlock(dim_in, dim_out, t, stride, "bottleneck_transform", dim_inner,
                             groups)
    assert isinstance(port.branch2, resnet3d.BottleneckTransform)
    assert hasattr(port, "branch1") == (stride != 1 or dim_in != dim_out)
    got, want = _check(jax_block, load_port(port, variables), variables, x, train, TOL)
    assert got.shape == (2, 4, 8 // stride, 10 // stride, dim_out)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_fuse_fast_to_slow_matches_flax(rng, train):
    """FuseFastToSlow at s2's widths (fast 32 -> 64 channels, kernel 5,
    alpha 4): slow [2, 4, 6, 8, 256], fast [2, 16, 6, 8, 32]."""
    jax_fuse = jax_slowfast.FuseFastToSlow(32, 2, 5, 4)
    xs = [rng.standard_normal((2, 4, 6, 8, 256)).astype(np.float32),
          rng.standard_normal((2, 16, 6, 8, 32)).astype(np.float32)]
    variables = jax_module_variables(jax_fuse, rng, [jnp.asarray(a) for a in xs])
    port = load_port(slowfast.FuseFastToSlow(32, 2, 5, 4), variables)
    got, want = _check(jax_fuse, port, variables, xs, train, TOL)
    assert got[0].shape == (2, 4, 6, 8, 256 + 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("instantiation", ["softmax", "dot_product"])
@pytest.mark.parametrize("pool", [None, (1, 2, 2)])
def test_nonlocal_matches_flax(rng, instantiation, pool):
    """Nonlocal (dim 32, inner 16) on [2, 4, 6, 8, 32], eval and train mode
    (its BatchNorm's statistics after the call)."""
    jax_nl = jax_nonlocal.Nonlocal(32, 16, pool, instantiation)
    x = rng.standard_normal((2, 4, 6, 8, 32)).astype(np.float32)
    variables = jax_module_variables(jax_nl, rng, jnp.asarray(x))
    port = load_port(nonlocal_block.Nonlocal(32, 16, pool, instantiation), variables)
    for train in (False, True):
        got, want = _check(jax_nl, port, variables, x, train, TOL)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_resstage_nonlocal_matches_flax(rng, train):
    """A two-pathway ResStage of bottleneck blocks with a non-local block
    after block 1 of each pathway, nonlocal_group 2 (T folded into the
    batch: attention within each half of T), pools (1,2,2) and none."""
    kw = dict(dim_in=[32, 8], dim_out=[32, 8], stride=[1, 1], temp_kernel_sizes=[[1], [3]],
              num_blocks=[2, 2], dim_inner=[16, 4], num_groups=[1, 1],
              num_block_temp_kernel=[2, 2], trans_func_name="bottleneck_transform",
              nonlocal_inds=[[1], [1]], nonlocal_group=[2, 2],
              nonlocal_pool=[[1, 2, 2], [1, 1, 1]], nonlocal_instantiation="softmax")
    jax_stage = jax_resnet3d.ResStage(**kw)
    xs = [rng.standard_normal((2, 4, 6, 8, 32)).astype(np.float32),
          rng.standard_normal((2, 8, 6, 8, 8)).astype(np.float32)]
    variables = jax_module_variables(jax_stage, rng, [jnp.asarray(a) for a in xs])
    port = resnet3d.ResStage(**kw)
    assert {"pathway0_nonlocal1", "pathway1_nonlocal1"} <= dict(port.named_children()).keys()
    got, want = _check(jax_stage, load_port(port, variables), variables, xs, train, TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_slowfast_features_match_flax(rng, train):
    """SlowFastFeatures (depth 18) at 16x64x96: pyramid (320, 640, 1280,
    2048) at T 4 and strides 4-32, each level within atol 2e-4, rtol 1e-3
    at eval; in train mode within atol 1e-3, rtol 1e-3, and every
    BatchNorm's statistics, stage s5's fast pathway's too, within 2e-4,
    1e-3. (In train mode each BatchNorm normalises by its batch statistics,
    over 24 positions a channel in s5: against the port in fp64, the flax
    module's fp32 s5 is 7.6e-4 off, the port's fp32 1.6e-4.) The slow
    pathway gets frames 0, 4, 12 and 15; the converter maps the port's
    every key onto the flax tree and back."""
    port = slowfast.SlowFastFeatures(SlowFastConfig(**SMALL))
    jax_model = jax_slowfast.SlowFastFeatures(cfg=JaxSlowFastConfig(**SMALL))
    x = rng.standard_normal((1, 16, *RES, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    converted = convert_state_dict(port.state_dict())
    assert dict(_leaves(converted)) == dict(_leaves(jax.tree.map(lambda s: s, shapes)))
    variables = seeded_variables(shapes, rng)
    assert set(state_dict_from_jax(variables)) == set(port.state_dict())
    assert any(k.startswith("s5.pathway1_res") and k.endswith("running_mean")
               for k in port.state_dict())
    seen = []
    port.s1.register_forward_pre_hook(lambda m, args: seen.append(args[0][0].clone()))
    got, want = _check(jax_model, load_port(port, variables), variables, x, train,
                       dict(atol=2e-4, rtol=1e-3))
    assert slowfast.SLOW_FRAMES == (0, 4, 12, -1)
    np.testing.assert_array_equal(seen[0].numpy(), x[:, [0, 4, 12, 15]])
    tol = dict(atol=1e-3, rtol=1e-3) if train else dict(atol=2e-4, rtol=1e-3)
    for g, w, c, s in zip(got, want, (320, 640, 1280, 2048), (4, 8, 16, 32)):
        assert tuple(g.shape) == tuple(w.shape) == (1, 4, RES[0] // s, RES[1] // s, c)
        np.testing.assert_allclose(to_np(g), np.asarray(w), **tol)


def test_slowfast_av_model_matches_jax(rng, monkeypatch):
    """The slowfast4x16 AudioVisualSaliencyModel (depth 18) at 32x64, batch
    1, uint8 clips, JAX on its plain path; the SyncBlock's 3 K4 and 3 K2
    calls and the decoder's 4 K2 calls on the port's side. atol 5e-4, rtol
    1e-3 on the log-density map, 1e-4 on the loss."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    overrides = {"data": {"resolution": AV_RES}, "model": {"slowfast": SMALL}}
    with skipped_init():
        port = AudioVisualSaliencyModel(get_config("slowfast4x16", overrides), device="cpu")
    jax_model = JaxModel(cfg=jax_get_config("slowfast4x16", overrides=overrides))
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


def test_slowfast_config_matches_jax():
    got, want = get_config("slowfast4x16"), jax_get_config("slowfast4x16")
    assert got.model.motion_encoder == want.model.motion_encoder == "slowfast4x16"
    for prop in ("embed_dims", "pyramid_tdims", "lateral_bool", "lateral_stride"):
        assert getattr(got.model, prop) == getattr(want.model, prop), prop
    assert got.model.lateral_bool == (False, False, False, False)
    for f in dataclasses.fields(SlowFastConfig):
        assert getattr(got.model.slowfast, f.name) == getattr(want.model.slowfast, f.name), \
            f.name
    for res, n in (((224, 384), 336), (RES, 24)):
        o = {"data": {"resolution": res}}
        assert get_config("slowfast4x16", o).num_vis_tokens() == \
            jax_get_config("slowfast4x16", overrides=o).num_vis_tokens() == n
    # the SyncBlock's tokens at 224x384: 336 visual + 36 audio
    sync = fusion.SyncBlock(num_blocks=0, num_vis_tokens=got.num_vis_tokens(),
                            vis_in_embed=2048)
    assert sync.vis_pos_embed.shape[1] + sync.aud_pos_embed.shape[1] == 372
    with torch.device("meta"):
        r50 = slowfast.SlowFastFeatures(SlowFastConfig())
    assert [len([n for n, _ in getattr(r50, f"s{s}").named_children()
                 if n.startswith("pathway0_res")]) for s in (2, 3, 4, 5)] == [3, 4, 6, 3]
    assert get_config("slowfast4x16", {"model": {"remat": True}}).model.remat is True


def test_slowfast_clis():
    """Both CLIs take --motion_encoder slowfast4x16; quant="int8" is taken
    (only the SyncBlock's C = 512 reaches row 12)."""
    args = inference.parse_args(["--motion_encoder", "slowfast4x16", "--quant", "int8"])
    assert inference.config_from_args(args).model.motion_encoder == "slowfast4x16"
    cfg = train_cli.config_from_args(train_cli.parse_args(["--motion_encoder",
                                                           "slowfast4x16"]))
    assert cfg.model.motion_encoder == "slowfast4x16"
