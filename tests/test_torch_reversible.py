"""The port's reversible MViT (mspi_tpu_torch.models.reversible_mvit)
against the JAX package on the CPU, mirroring tests/test_reversible.py.

Tolerances: a block's forward and its inversion 1e-5 (fp32); the
reversible span's gradients 1e-5 of each tensor's largest magnitude against
plain autograd through the same port blocks (the same framework: only the
inversion's rounding differs), and 2e-3 against JAX's `custom_vjp`, as the
port's other gradient tests; the depth-4 encoder 1e-4.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.config import MViTConfig as JaxMViTConfig
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models import reversible_mvit as jax_rev
from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import reversible_mvit
from tests.torch_port_utils import (assert_imports_no_jax, cpu_share,  # noqa: F401
                                    jax_module_variables, jit_fast, load_port,
                                    seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

THW = (2, 4, 6)
DIM = 64
BLOCK = dict(input_size=THW, num_heads=2, mlp_ratio=2.0, qkv_bias=True, kernel_q=(3, 3, 3),
             kernel_kv=(3, 3, 3), stride_kv=(1, 2, 2))
N = THW[0] * THW[1] * THW[2]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _blocks(rng, n):
    """n JAX ReversibleBlocks with seeded numpy variables, and the port's
    blocks loaded with them."""
    jblock = jax_rev.ReversibleBlock(dim=DIM, **BLOCK)
    x = jnp.zeros((1, N, DIM))
    variables = [jax.tree.map(np.asarray, jax_module_variables(jblock, rng, x, x, THW))
                 for _ in range(n)]
    ports = [load_port(reversible_mvit.ReversibleBlock(DIM, **BLOCK), v) for v in variables]
    return jblock, variables, ports


def test_reversible_block_matches_jax_and_inverts(rng):
    jblock, (variables,), (port,) = _blocks(rng, 1)
    x1, x2 = _randn(rng, 2, N, DIM), _randn(rng, 2, N, DIM)
    want = jax.jit(jblock.apply, static_argnums=3)(variables, jnp.asarray(x1), jnp.asarray(x2),
                                                   THW)
    with torch.no_grad():
        y1, y2 = port(torch.from_numpy(x1), torch.from_numpy(x2), THW)
        x2_rec = y2 - port.g_part(y1)
        x1_rec = y1 - port.f_part(x2_rec, THW)
    for got, w in zip((y1, y2), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x2_rec.numpy(), x2, atol=1e-5)
    np.testing.assert_allclose(x1_rec.numpy(), x1, atol=1e-5)


def _loss(y1, y2):
    return (y1 ** 2).sum() + (y2 * 0.5).sum()


@pytest.mark.parametrize("against", ["autograd", "jax"])
def test_reversible_sequence_gradients(rng, against):
    """`reversible_sequence` over 3 blocks (the O(1)-activation backward)
    against plain autograd through the same blocks, or against JAX's
    `custom_vjp` reversible_sequence: the loss 1e-5, the inputs' gradients
    and every parameter's."""
    jblock, variables, ports = _blocks(rng, 3)
    x1, x2 = _randn(rng, 1, N, DIM), _randn(rng, 1, N, DIM)
    t1, t2 = (torch.from_numpy(x).requires_grad_(True) for x in (x1, x2))
    loss = _loss(*reversible_mvit.reversible_sequence(ports, t1, t2, THW))
    loss.backward()
    got = {"x1": t1.grad, "x2": t2.grad}
    got.update({f"{i}.{k}": p.grad for i, blk in enumerate(ports)
                for k, p in blk.named_parameters()})
    if against == "autograd":
        p1, p2 = (torch.from_numpy(x).requires_grad_(True) for x in (x1, x2))
        for blk in ports:
            blk.zero_grad()
        y1, y2 = p1, p2
        for blk in ports:
            y1, y2 = blk(y1, y2, THW)
        want_loss = _loss(y1, y2)
        want_loss.backward()
        want_loss = want_loss.detach()
        want = {"x1": p1.grad, "x2": p2.grad}
        want.update({f"{i}.{k}": p.grad for i, blk in enumerate(ports)
                     for k, p in blk.named_parameters()})
        rel = 1e-5
    else:
        params = [v["params"] for v in variables]

        def loss_rev(params_list, a, b):
            y1, y2 = jax_rev.reversible_sequence([jblock] * 3, params_list, a, b, THW)
            return jnp.sum(y1 ** 2) + jnp.sum(y2 * 0.5)

        want_loss, (gp, g1, g2) = jit_fast(jax.value_and_grad(loss_rev, argnums=(0, 1, 2)),
                                           params, jnp.asarray(x1), jnp.asarray(x2))
        jax.clear_caches()
        want = {"x1": torch.from_numpy(np.asarray(g1)), "x2": torch.from_numpy(np.asarray(g2))}
        for i, g in enumerate(gp):
            want.update({f"{i}.{k}": v for k, v in state_dict_from_jax(
                {"params": jax.tree.map(np.asarray, g)}).items()})
        rel = 2e-3
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert set(got) == set(want)
    # norm_k's bias adds q.b to every key's score, which the softmax drops:
    # its gradient is 0 in exact arithmetic, and rounding noise on both
    # sides, held to 1e-6 of the largest gradient
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        assert err <= max(rel * w.abs().max().item(), floor), (k, err)


def test_reversible_mvit_features_match_jax(rng):
    """`ReversibleMViTFeatures` at depth 4 as tests/test_reversible.py builds
    it (one transition doubling 96 -> 192, the concat fusion 384 wide), on
    a random [1, 16, 64, 96, 3] clip: the variable tree leaf for leaf (the
    JAX tree from the port's, applied by flax, which raises on a leaf it
    lacks, and loaded back strictly) and the output 1e-4."""
    kw = dict(depth=4, dim_mul=((1, 2.0),), head_mul=((1, 2.0),),
              pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2), (2, 1, 1, 1), (3, 1, 1, 1)))
    jmodel = jax_rev.ReversibleMViTFeatures(cfg=JaxMViTConfig(**kw))
    clips = _randn(rng, 1, 16, 64, 96, 3)
    port = reversible_mvit.ReversibleMViTFeatures(MViTConfig(**kw))
    variables = jax.tree.map(np.asarray, seeded_variables(
        convert_state_dict(port.state_dict()), rng))
    load_port(port, variables)
    assert port.kinds == ("rev", "transition", "rev", "rev")
    want = jit_fast(jmodel.apply, variables, jnp.asarray(clips))
    jax.clear_caches()
    with torch.no_grad():
        got = port(torch.from_numpy(clips))
    assert got.shape == (1, 384)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)


def _families(name):
    """(JAX module, its init arguments, the port module) of each model family
    of this slice, at test size."""
    from mspi_tpu.config import MViTConfig as JC
    from mspi_tpu.models.masked import MaskedMViT as JaxMaskedMViT
    from mspi_tpu.models.mvit import MViTFeatures as JaxMViTFeatures
    from mspi_tpu.train.ssl import ContrastiveNet as JaxContrastiveNet
    from mspi_tpu_torch.models.masked import MaskedMViT
    from mspi_tpu_torch.models.mvit import MViTFeatures
    from mspi_tpu_torch.train.ssl import ContrastiveNet
    from tests.torch_port_utils import SHALLOW_MVIT

    clips = jnp.zeros((1, 16, 32, 32, 3))
    if name == "contrastive":
        kw = dict(dim_in=768, dim_hidden=64, dim_out=16, use_predictor=True, num_prototypes=12)
        return (JaxContrastiveNet(trunk=JaxMViTFeatures(cfg=JC(**SHALLOW_MVIT)), **kw),
                (clips,), {"predict": True},
                ContrastiveNet(MViTFeatures(MViTConfig(**SHALLOW_MVIT)), **kw))
    if name.startswith("masked"):
        target = name.split("_")[1]
        grid = (8, 2, 2) if target == "hog" else (8, 8, 8)
        return (JaxMaskedMViT(cfg=JC(**SHALLOW_MVIT), target=target),
                (clips, jnp.zeros((1, *grid), bool)), {},
                MaskedMViT(MViTConfig(**SHALLOW_MVIT), target=target))
    kw = dict(depth=4, dim_mul=((1, 2.0),), head_mul=((1, 2.0),),
              pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2), (2, 1, 1, 1), (3, 1, 1, 1)))
    return (jax_rev.ReversibleMViTFeatures(cfg=JaxMViTConfig(**kw)), (clips,), {},
            reversible_mvit.ReversibleMViTFeatures(MViTConfig(**kw)))


@pytest.mark.parametrize("name", ["contrastive", "masked_hog", "masked_pixel", "reversible"])
def test_variable_tree_converts_leaf_for_leaf(name):
    """The JAX module's own init tree (`jax.eval_shape`) goes through
    `state_dict_from_jax` into exactly the port module's state dict: every
    key, every shape, nothing dropped or left over."""
    jmodule, args, kwargs, port = _families(name)
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kwargs))
    sd = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_slice_modules_import_no_jax():
    """The modules of the ssl, masked and reversible slice and the caffe2
    loader import neither JAX, flax nor the JAX package."""
    assert_imports_no_jax(("caffe2", "models.contrastive", "models.masked",
                           "models.reversible_mvit", "train.ssl", "train.checkpoints",
                           "run_net"))
