"""The port's S3D slice against the JAX package on the CPU.

- one Inception `Mixed` block against its flax module, at eval and in train
  mode (batch statistics, running statistics updated);
- `S3DFeatures` (the whole backbone) at 16x64x96;
- the `s3d` AudioVisualSaliencyModel forward at 64x96, with the SyncBlock's
  K4 and K2 calls and the decoder's K2 calls counted on both sides (the
  backbone itself has no kernel: its convs, pools and BatchNorms are plain
  on both sides);
- the config tables and the SyncBlock's 336 tokens, and `quant="int8"`,
  which S3D takes (only its SyncBlock reaches row 12).

Weights are seeded variables over the JAX module's tree, moved into the port
by `state_dict_from_jax` (strict). Tolerances (fp32) are stated per test;
the whole-model ones are the flagship's (`tests/test_torch_slice.py`: atol
5e-4, rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mspi_tpu.models.s3d as jax_s3d
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu.ops.pallas import mlp as jax_mlp
from mspi_tpu.ops.pallas import pooled_attention as jax_pa
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import S3DConfig, get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import fusion, s3d
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from tests.torch_port_utils import (count_calls, cpu_share, jax_module_variables, jit_fast,
                                    load_port, seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (64, 96)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


@pytest.fixture(scope="module", autouse=True)
def free_jax_programs():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("train", [False, True])
def test_mixed_block_matches_flax(rng, train):
    """Mixed_4e (512 -> 528 channels, both SepConv branches, the pooled
    branch) on [2, 4, 6, 8, 512]: the output, and in train mode every
    BatchNorm's running statistics after the call."""
    spec = s3d.MIXED_SPECS["4e"]
    jax_block = jax_s3d.Mixed(*spec)
    x = rng.standard_normal((2, 4, 6, 8, spec[0])).astype(np.float32)
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x))
    port = load_port(s3d.Mixed(*spec), variables)
    if train:
        want, upd = jax_block.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        port.train()
        got = port(torch.from_numpy(x))
        want_stats = state_dict_from_jax({"batch_stats": upd["batch_stats"]})
        for k, v in want_stats.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(port.state_dict()[k].numpy(), v.numpy(), **TOL,
                                           err_msg=k)
    else:
        want = jax_block.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    assert got.shape[-1] == 528
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_s3d_features_match_flax(rng):
    """The whole S3D_features_only at 16x64x96 (pool stride 1): pyramid
    (192, 480, 832, 1024) at T (8, 8, 4, 4), each level within atol 2e-4,
    rtol 1e-3 (fp32 through 19 conv units)."""
    port = s3d.S3DFeatures(pool=S3DConfig().pool_stride)
    jax_model = jax_s3d.S3DFeatures(pool=1)
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    x = rng.standard_normal((1, 16, *RES, 3)).astype(np.float32)
    want = jit_fast(jax_model.apply, variables, jnp.asarray(x))
    load_port(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w, c, t, s in zip(got, want, (192, 480, 832, 1024), (8, 8, 4, 4), (4, 8, 16, 32)):
        assert tuple(g.shape) == tuple(w.shape) == (1, t, RES[0] // s, RES[1] // s, c)
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=2e-4, rtol=1e-3)


def test_s3d_av_model_matches_jax(rng, monkeypatch):
    """The whole s3d AudioVisualSaliencyModel at 64x96, batch 1, uint8
    clips, JAX with its Pallas kernels in interpret mode; the SyncBlock's 3
    K4 and 3 K2 calls and the decoder's 4 K2 calls on both sides. atol
    5e-4, rtol 1e-3 on the log-density map, 1e-4 on the loss."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MSPI_MLPT_VMEM_BUDGET", "1")  # the prior's tiling, not its arithmetic
    cfg = get_config("s3d", {"data": {"resolution": RES}})
    port = AudioVisualSaliencyModel(cfg, device="cpu")
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    jax_model = JaxModel(cfg=jax_get_config("s3d", overrides={"data": {"resolution": RES}}))
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    port_calls, jax_calls = {}, {}
    count_calls(((PA, "_self_attention_fwd"), (K2, "ln_mlp"), (fusion, "ln_mlp")), port_calls,
              monkeypatch)
    count_calls(((jax_pa, "fused_self_attention"), (jax_mlp, "fused_ln_mlp")), jax_calls,
              monkeypatch)
    # one compiled program: the kernel functions are counted as it traces
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips), jnp.asarray(auds))
    jax.clear_caches()
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert port_calls == {"_self_attention_fwd": 3, "ln_mlp": 3 + 4}
    assert jax_calls == {"fused_self_attention": 3, "fused_ln_mlp": 3 + 4}
    assert got.shape == (1, *RES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    assert abs(float(got_loss) - float(want_loss)) < 1e-4


def test_s3d_config_matches_jax():
    got, want = get_config("s3d"), jax_get_config("s3d")
    assert got.model.motion_encoder == want.model.motion_encoder == "s3d"
    assert (got.model.embed_dims, got.model.pyramid_tdims, got.model.lateral_bool) == \
        (want.model.embed_dims, want.model.pyramid_tdims, want.model.lateral_bool)
    assert got.model.s3d.pool_stride == want.model.s3d.pool_stride == 1
    for res, n in (((224, 384), 336), (RES, 24)):
        o = {"data": {"resolution": res}}
        assert get_config("s3d", o).num_vis_tokens() == \
            jax_get_config("s3d", overrides=o).num_vis_tokens() == n


def test_s3d_int8_and_clis():
    """S3D serves with quant="int8" (its backbone has no LN+MLP block; the
    SyncBlock's C = 512 runs row 12) and both CLIs take --motion_encoder
    s3d."""
    cfg = inference.config_from_args(inference.parse_args(
        ["--motion_encoder", "s3d", "--quant", "int8"]))
    assert (cfg.model.motion_encoder, cfg.model.quant) == ("s3d", "int8")
    from mspi_tpu_torch.train.__main__ import parse_args

    assert parse_args(["--motion_encoder", "s3d"]).motion_encoder == "s3d"
