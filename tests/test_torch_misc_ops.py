"""The port's `ops/subbn.py` and `convert/inflate.py` against the JAX
package on the CPU (the cases of `tests/test_misc_ops.py` but its XLA
cost analysis, which belongs to the measuring tools).

- `SubBatchNorm` (channels-last, statistics per split): per-split torch
  BatchNorm in training (1e-4 / 1e-3, the pre-port tolerance), and the JAX
  module in both modes, its updated statistics included (1e-5), the output
  in the input's dtype;
- `sync_batchnorm` on 2 gloo ranks (`tests/torch_dist_worker.py syncbn`):
  each rank's output and the running statistics against JAX's
  `sync_batchnorm` under `pmap` over 2 devices, and the input gradients
  against JAX's gradient of plain BatchNorm over the global batch (1e-5);
- the inflation utilities on torch layouts against the JAX functions on
  flax layouts through `state_dict_from_jax`, the resizes up and down
  (1e-6).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.convert import inflate as jax_inflate
from mspi_tpu.ops.layers import batchnorm as jax_batchnorm
from mspi_tpu.ops.subbn import SubBatchNorm as JaxSubBatchNorm
from mspi_tpu.ops.subbn import sync_batchnorm as jax_sync_batchnorm
from mspi_tpu_torch.convert import inflate, state_dict_from_jax
from mspi_tpu_torch.ops.subbn import SubBatchNorm
from mspi_tpu_torch.parallel import free_port
from tests.torch_port_utils import cpu_share, jax_module_variables, load_port, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)


def test_subbn_train_matches_per_split_torch(rng):
    """Training normalises each split with its own statistics (torch
    BatchNorm3d per split); eval on the aggregated statistics is finite."""
    C, splits, sub = 6, 2, 4
    x = rng.standard_normal((splits * sub, 2, 3, 3, C)).astype(np.float32)
    bn_port = SubBatchNorm(C, num_splits=splits).train()
    y = bn_port(torch.from_numpy(x)).detach()
    bn = torch.nn.BatchNorm3d(C).train()
    xt = torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3)))
    outs = []
    for s in range(splits):
        bn.reset_running_stats()
        outs.append(bn(xt[s * sub:(s + 1) * sub]).detach())
    ref = torch.cat(outs).numpy()
    np.testing.assert_allclose(np.transpose(y.numpy(), (0, 4, 1, 2, 3)), ref,
                               atol=1e-4, rtol=1e-3)
    assert torch.isfinite(bn_port.eval()(torch.from_numpy(x))).all()


@pytest.mark.parametrize("train", [True, False])
def test_subbn_matches_jax(rng, train):
    """The JAX module's seeded variables (scale, bias, and [3, C] running
    statistics) loaded into the port: the output (fp32 and, cast back,
    bf16) and in training the updated statistics (unbiased variance)."""
    C, splits = 5, 3
    x = rng.standard_normal((6, 2, 3, 4, C)).astype(np.float32) * 2 + 0.5
    jax_bn = JaxSubBatchNorm(num_features=C, num_splits=splits)
    variables = jax_module_variables(jax_bn, rng, jnp.asarray(x), use_running_average=False)
    assert variables["batch_stats"]["mean"].shape == (splits, C)
    want, upd = jax_bn.apply(variables, jnp.asarray(x), use_running_average=not train,
                             mutable=["batch_stats"])
    port = load_port(SubBatchNorm(C, num_splits=splits), variables).train(train)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    if train:
        want_sd = state_dict_from_jax({"batch_stats": jax.tree.map(np.asarray,
                                                                   upd["batch_stats"])})
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(to_np(port.state_dict()[k]), want_sd[k].numpy(), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert port(xb).dtype == torch.bfloat16


def test_sync_batchnorm_matches_global_bn(rng, tmp_path):
    """2 gloo ranks of 2 samples each: the outputs and running statistics
    of JAX's `sync_batchnorm` under pmap over 2 devices, and the gradients
    of sum(w * y) of plain BatchNorm over the global batch of 4."""
    x = rng.standard_normal((4, 2, 4, 5, 3)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(3)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3)).astype(np.float32)
    torch.save({"x": torch.from_numpy(x), "w": torch.from_numpy(w),
                "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
               tmp_path / "syncbn_in.pt")
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_worker", "syncbn",
                               str(tmp_path), str(r), "2", str(port)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]

    sync = jax_sync_batchnorm()
    xs = jnp.asarray(x.reshape(2, 2, 2, 4, 5, 3))
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(3), "var": jnp.ones(3)}}

    def fwd(xd):
        y, upd = sync.apply(variables, xd, use_running_average=False, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y_sync, stats = jax.pmap(fwd, axis_name="data", devices=jax.devices()[:2])(xs)
    plain = jax_batchnorm()

    def global_loss(xg):
        y, _ = plain.apply(variables, xg, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * w)

    grads = np.asarray(jax.grad(global_loss)(jnp.asarray(x)))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()[-3000:]
    for r in range(2):
        got = torch.load(tmp_path / f"syncbn_out_{r}.pt", weights_only=False)
        np.testing.assert_allclose(got["y"].numpy(), np.asarray(y_sync[r]), **TOL)
        np.testing.assert_allclose(got["grad"].numpy(), grads[2 * r:2 * r + 2], **TOL)
        np.testing.assert_allclose(got["mean"].numpy(), np.asarray(stats["mean"][r]), **TOL)
        np.testing.assert_allclose(got["var"].numpy(), np.asarray(stats["var"][r]), **TOL)


def test_sync_batchnorm_outside_a_group_is_batchnorm(rng):
    """Without a process group the module is the port's BatchNorm."""
    from mspi_tpu_torch.ops.layers import BatchNorm
    from mspi_tpu_torch.ops.subbn import sync_batchnorm

    x = torch.from_numpy(rng.standard_normal((4, 3, 5, 6)).astype(np.float32))
    a, b = sync_batchnorm(6).train(), BatchNorm(6).train()
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    torch.testing.assert_close(a.running_var, b.running_var, rtol=0, atol=0)


def test_inflate_conv2d(rng):
    """Mean-preserving and centred inflation of [O, I, kh, kw], equal to the
    JAX function's on the flax layout [kh, kw, I, O]."""
    k2 = rng.standard_normal((7, 7, 3, 96)).astype(np.float32)
    w2 = state_dict_from_jax({"params": {"c": {"kernel": k2}}})["c.weight"]
    for t, center in ((2, False), (3, True)):
        want = state_dict_from_jax({"params": {"c": {"kernel": jax_inflate.inflate_conv2d_to_3d(
            k2, t, center=center)}}})["c.weight"]
        got = inflate.inflate_conv2d_to_3d(w2, t, center=center)
        assert got.shape == (96, 3, t, 7, 7)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(inflate.inflate_conv2d_to_3d(w2, 2).sum(2).numpy(), w2.numpy(),
                               atol=1e-6)
    centred = inflate.inflate_conv2d_to_3d(w2, 3, center=True)
    assert centred[:, :, 0].abs().max() == 0 and torch.equal(centred[:, :, 1], w2)


@pytest.mark.parametrize("old,new,prefix", [(16, 36, 1), (36, 16, 1), (49, 9, 0)])
def test_interpolate_pos_embed(rng, old, new, prefix):
    """A 4x4 grid to 6x6 and back down, the class token kept, and 7x7 to
    3x3 without a prefix, against `jax.image.resize(..., "linear",
    antialias=False)`."""
    pe = rng.standard_normal((1, prefix + old, 8)).astype(np.float32)
    got = inflate.interpolate_pos_embed(torch.from_numpy(pe), new, num_prefix_tokens=prefix)
    assert got.shape == (1, prefix + new, 8)
    np.testing.assert_array_equal(got[:, :prefix].numpy(), pe[:, :prefix])
    np.testing.assert_allclose(got.numpy(), jax_inflate.interpolate_pos_embed(pe, new, prefix),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("old,new", [(15, 31), (31, 15), (27, 13), (7, 13)])
def test_interpolate_rel_pos(rng, old, new):
    rp = rng.standard_normal((old, 32)).astype(np.float32)
    t = torch.from_numpy(rp)
    got = inflate.interpolate_rel_pos(t, new)
    assert got.shape == (new, 32)
    np.testing.assert_allclose(got.numpy(), jax_inflate.interpolate_rel_pos(rp, new),
                               atol=2e-6, rtol=0)
    assert inflate.interpolate_rel_pos(t, old) is t


def test_inflate_swin2d(rng):
    """A Swin-2D tree (patch embedding conv, a block's bias table, a
    linear named `proj`) inflated as the JAX function inflates its flax
    tree: the conv over time / patch_t, the table tiled 2 window_t - 1
    times, the linear untouched."""
    tree = {"patch_embed": {"proj": {"kernel": rng.standard_normal((4, 4, 3, 8)),
                                     "bias": rng.standard_normal(8)}},
            "layers_0": {"blocks_0": {"attn": {
                "relative_position_bias_table": rng.standard_normal((169, 3)),
                "proj": {"kernel": rng.standard_normal((8, 8)),
                         "bias": rng.standard_normal(8)}}}}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    got = inflate.inflate_swin2d(state_dict_from_jax({"params": tree}), 2, 8)
    want = state_dict_from_jax({"params": jax_inflate.inflate_swin2d(tree, 2, 8)})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)
    (table,) = [v for k, v in got.items() if k.endswith("relative_position_bias_table")]
    assert table.shape == (169 * 15, 3) and got["patch_embed.proj.weight"].shape == (8, 3, 2, 4, 4)
