"""Each ported module that holds a kernel, plus the audio net, against its
JAX module on the CPU, with the JAX side's Pallas kernels on in interpret
mode. Weights are the JAX module's seeded variables, moved into the port by
`state_dict_from_jax` (strict). Tolerance atol 1e-4, rtol 1e-4 (fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.models import audio_resnet as jax_audio
from mspi_tpu.models import convnext as jax_convnext
from mspi_tpu.models import fusion as jax_fusion
from mspi_tpu.models import mvit as jax_mvit
from mspi_tpu_torch.models import audio_resnet, convnext, fusion, mvit
from tests.torch_port_utils import cpu_share, jax_module_variables, load_port, to_np

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")


def _compare(rng, jax_module, port_module, *inputs, **kwargs):
    xs = [np.asarray(x, np.float32) for x in inputs]
    variables = jax_module_variables(jax_module, rng, *map(jnp.asarray, xs), **kwargs)
    want = jax_module.apply(variables, *map(jnp.asarray, xs), **kwargs)
    port = load_port(port_module, variables)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, xs))
    return want, got


def test_convnext_block2d(rng):
    x = rng.standard_normal((3, 6, 5, 32))
    want, got = _compare(rng, jax_convnext.ConvNeXtBlock2d(dim=32),
                         convnext.ConvNeXtBlock2d(32), x)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("dim,dim_out,heads,input_size,thw,stride_q,stride_kv", [
    # q-pooling transition block (like MViT block 1): 16 -> 32 channels
    (16, 32, 2, (2, 8, 8), (2, 4, 6), (1, 2, 2), (1, 4, 4)),
    # plain block: kv pooled only
    (32, 32, 2, (2, 4, 4), (2, 3, 5), (1, 1, 1), (1, 2, 2)),
])
def test_multiscale_block(rng, dim, dim_out, heads, input_size, thw, stride_q, stride_kv):
    kernel = (3, 3, 3)
    jax_block = jax_mvit.MultiScaleBlock(
        dim=dim, dim_out=dim_out, num_heads=heads, input_size=input_size, mlp_ratio=4.0,
        qkv_bias=True, drop_path=0.0, kernel_q=kernel, kernel_kv=kernel,
        stride_q=stride_q, stride_kv=stride_kv)
    port = mvit.MultiScaleBlock(dim, dim_out, heads, input_size, 4.0, True, kernel, kernel,
                                stride_q, stride_kv)
    x = rng.standard_normal((2, int(np.prod(thw)), dim)).astype(np.float32)
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x), thw, False)
    want, want_thw = jax.jit(jax_block.apply, static_argnums=(2, 3))(
        variables, jnp.asarray(x), thw, False)
    load_port(port, variables)
    with torch.no_grad():
        got, got_thw = port(torch.from_numpy(x), thw)
    assert tuple(got_thw) == tuple(int(t) for t in want_thw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_fusion_block(rng):
    x = rng.standard_normal((2, 13, 32))
    want, got = _compare(rng, jax_fusion.Block(dim=32, num_heads=2),
                         fusion.Block(32, 2), x)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_sync_block(rng):
    vis = rng.standard_normal((2, 2, 1, 3, 48))
    aud = rng.standard_normal((2, 2, 2, 512))
    jax_sync = jax_fusion.SyncBlock(num_blocks=1, num_vis_tokens=6, num_aud_tokens=4,
                                    vis_in_embed=48, embed_dim=512)
    port = fusion.SyncBlock(num_blocks=1, num_vis_tokens=6, num_aud_tokens=4,
                            vis_in_embed=48, embed_dim=512, num_heads=4)
    want, got = _compare(rng, jax_sync, port, vis, aud)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_convnext_block3d(rng):
    x = rng.standard_normal((2, 4, 5, 6, 16))
    want, got = _compare(rng, jax_fusion.ConvNextBlock3d(16), fusion.ConvNextBlock3d(16), x)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_audio_resnet18(rng):
    x = rng.standard_normal((2, 65, 47, 1))
    want, got = _compare(rng, jax_audio.AudioResNet18(), audio_resnet.AudioResNet18(), x)
    assert got.shape == want.shape == (2, 3, 2, 512)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
