"""The port's contrastive pretraining (mspi_tpu_torch.models.contrastive,
mspi_tpu_torch.train.ssl and `run_net --task ssl`) against the JAX
package on the CPU.

Tolerances: the losses, `sinkhorn`, `momentum_update` and `queue_update`
1e-5 (fp32, the same formulas); the kNN eval exact; one training step per
objective as stated in `test_ssl_step_matches_jax`. The random draws (the
queue, the prototypes, the weights) come from numpy on both sides: the two
frameworks' generators are never compared.
"""

import contextlib
import io
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mspi_tpu.models.mvit as jax_mvit
from mspi_tpu.config import MViTConfig as JaxMViTConfig
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models import contrastive as jax_c
from mspi_tpu.models.mvit import MViTFeatures as JaxMViTFeatures
from mspi_tpu.ops.layers import batchnorm as jax_batchnorm
from mspi_tpu.ops.layers import conv3d as jax_conv3d
from mspi_tpu.train import optim as jax_optim
from mspi_tpu.train import ssl as jax_ssl
from mspi_tpu_torch import run_net
from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import contrastive
from mspi_tpu_torch.models.mvit import MViTFeatures
from mspi_tpu_torch.ops import layers
from mspi_tpu_torch.train import optim, ssl
from tests.test_run_net_cli import _build_k400_tree
from tests.torch_port_utils import (SHALLOW_MVIT, FixedDropPathJax, compile_fast,  # noqa: F401
                                    cpu_share, fixed_drop_path_port, seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

TOL = dict(atol=1e-5, rtol=1e-5)
CLIP = (16, 32, 32)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["nt_xent", "moco", "byol", "swav", "sinkhorn"])
def test_contrastive_loss_matches_jax(rng, name):
    z1, z2, p1, p2 = (_randn(rng, 6, 16) for _ in range(4))
    queue, protos = _randn(rng, 32, 16), _randn(rng, 12, 16)
    unit = [x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (z1, protos)]
    args = {"nt_xent": (z1, z2, 0.1), "moco": (z1, z2, queue, 0.07),
            "byol": (p1, z2, p2, z1), "swav": (z1, z2, protos, 0.1),
            # SwAV feeds it cosine scores
            "sinkhorn": (unit[0] @ unit[1].T,)}[name]
    fn = name if name == "sinkhorn" else f"{name}_loss"
    want = jax.jit(getattr(jax_c, fn))(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                         for a in args))
    got = getattr(contrastive, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                     for a in args))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("K,ptr", [(8, 6), (10, 8), (12, 3)])
def test_momentum_and_queue_update_match_jax(rng, K, ptr):
    """The EMA at m = 0.9; the queue at a pointer that wraps (8, 6), one
    whose slice would run past the end (10, 8: JAX's dynamic_update_slice
    moves it back) and one inside (12, 3)."""
    online, target = _randn(rng, 3, 5), _randn(rng, 3, 5)
    want = jax_c.momentum_update({"w": jnp.asarray(online)}, {"w": jnp.asarray(target)}, 0.9)
    t = torch.from_numpy(target.copy())
    contrastive.momentum_update([torch.from_numpy(online)], [t], 0.9)
    np.testing.assert_allclose(t.numpy(), np.asarray(want["w"]), **TOL)

    queue, keys = _randn(rng, K, 4), _randn(rng, 4, 4)
    want_q, want_ptr = jax_c.queue_update(jnp.asarray(queue), jnp.asarray(keys),
                                          jnp.asarray(ptr))
    got_q, got_ptr = contrastive.queue_update(torch.from_numpy(queue.copy()),
                                              torch.from_numpy(keys), ptr)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), **TOL)
    assert got_ptr == int(want_ptr)


def test_knn_eval_and_momentum_anneal_match_jax(rng):
    """`knn_mem_update` and `eval_knn` on the same memory, labels and
    queries (the predictions exactly), and `momentum_anneal_cosine` along an
    epoch range (1e-7)."""
    n, dim = 40, 8
    mem, labels = _randn(rng, n, dim), rng.integers(0, 3, n)
    emb, idx = _randn(rng, 10, dim), rng.permutation(n)[:10]
    queries = _randn(rng, 7, dim)
    want_mem = jax_ssl.knn_mem_update(jnp.asarray(mem), jnp.asarray(emb), jnp.asarray(idx))
    got_mem = ssl.knn_mem_update(torch.from_numpy(mem), torch.from_numpy(emb),
                                 torch.from_numpy(idx))
    np.testing.assert_allclose(got_mem.numpy(), np.asarray(want_mem), **TOL)
    for k in (1, 5, 200):
        want = jax_ssl.eval_knn(jnp.asarray(queries), want_mem, jnp.asarray(labels), knn_k=k,
                                num_classes=3)
        got = ssl.eval_knn(torch.from_numpy(queries), got_mem, torch.from_numpy(labels),
                           knn_k=k, num_classes=3)
        assert got.tolist() == np.asarray(want).tolist(), k
    assert ssl.knn_mem_create(n, dim).norm(dim=-1).sub(1).abs().max() < 1e-6
    for epoch in (0.0, 3.5, 10.0):
        assert abs(ssl.momentum_anneal_cosine(0.99, epoch, 10.0)
                   - float(jax_ssl.momentum_anneal_cosine(0.99, epoch, 10.0))) <= 1e-7


class _BNTrunkJax(fnn.Module):
    """A patchify conv and a BatchNorm: a trunk whose statistics the step
    updates (MViT has none)."""

    def setup(self):
        self.conv = jax_conv3d(3, 16, (2, 8, 8), (2, 8, 8))
        self.bn = jax_batchnorm(momentum=0.1)

    def __call__(self, clips, train=False):
        return [jax.nn.relu(self.bn(self.conv(clips), use_running_average=not train))]


class _BNTrunk(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = layers.Conv3d(3, 16, (2, 8, 8), (2, 8, 8))
        self.bn = layers.BatchNorm(16, momentum=0.1)

    def forward(self, clips):
        return [torch.relu(self.bn(self.conv(clips)))]


def _trunks(kind):
    if kind == "mvit":
        return JaxMViTFeatures(cfg=JaxMViTConfig(**SHALLOW_MVIT)), \
            MViTFeatures(MViTConfig(**SHALLOW_MVIT)), 768
    return _BNTrunkJax(), _BNTrunk(), 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_moved_alike(got: dict, before: dict, want_tree, collection: str, what: str):
    """Each tensor's change over the step (`got - before`) within 2e-3 of
    the largest magnitude of JAX's change, and 1e-6 of the whole tree's
    (the rounding noise of a tensor that barely moves)."""
    want = state_dict_from_jax({collection: _np_tree(want_tree)})
    moves = {k: w.double().numpy() - before[k].double().numpy() for k, w in want.items()
             if not k.endswith("num_batches_tracked")}
    floor = 1e-6 * max(np.abs(m).max() for m in moves.values())
    for k, m in moves.items():
        g = got[k].detach().double().numpy() - before[k].double().numpy()
        assert np.abs(g - m).max() <= max(2e-3 * np.abs(m).max(), floor), (what, k)


@pytest.mark.parametrize("objective,trunk", [("moco", "mvit"), ("moco", "bn"), ("simclr", "bn"),
                                             ("byol", "bn"), ("swav", "bn")])
def test_ssl_step_matches_jax(rng, monkeypatch, objective, trunk):
    """One `make_ssl_train_step` of each objective on a ContrastiveNet
    (dim_hidden 64, dim_out 16, a 6-entry queue, 12 prototypes) against the
    JAX step (`jit=True`, compiled by `compile_fast`) from the same numpy
    weights and queue, at [2, 16, 32, 32, 3] per view, with
    `construct_optimizer`'s SGD (nesterov, weight decay 1e-4, the CLI's
    defaults) at LR 0.1 and momentum 0.9. The trunk
    is a conv + BatchNorm (whose statistics the step updates, twice in
    byol) for every objective, and for moco, the task's default, also the
    four-block MViT (`SHALLOW_MVIT`, drop-path on fixed masks: the JAX step
    passes no drop-path key). The loss 1e-5; how the step moved each
    parameter, each momentum tensor and each BatchNorm statistic (the online
    and the momentum net's) 2e-3 of JAX's move; the queue 1e-5 and its
    pointer exactly."""
    monkeypatch.setattr(jax_mvit, "DropPath", FixedDropPathJax)
    monkeypatch.setattr(layers.DropPath, "forward", fixed_drop_path_port)
    jax_trunk, port_trunk, dim_in = _trunks(trunk)
    kw = dict(dim_in=dim_in, dim_hidden=64, dim_out=16,
              use_predictor=objective in ("moco", "byol"),
              num_prototypes=12 if objective == "swav" else 0)
    jnet = jax_ssl.ContrastiveNet(trunk=jax_trunk, **kw)
    net = ssl.ContrastiveNet(port_trunk, **kw)
    clips1, clips2 = _randn(rng, 2, *CLIP, 3), _randn(rng, 2, *CLIP, 3)
    # the JAX variable tree from the port's (the converter's inverse holds it
    # leaf for leaf below), drawn from numpy
    variables = _np_tree(seeded_variables(convert_state_dict(net.state_dict()), rng))
    bs = variables.get("batch_stats", {})
    queue = _randn(rng, 6, 16)
    opt = dict(optimizing_method="sgd", base_lr=0.1, weight_decay=1e-4, zero_wd_1d_param=False)
    tx = jax_optim.construct_optimizer(None, **opt)
    jstate = jax_ssl.SSLTrainState(
        params=variables["params"], batch_stats=bs, momentum_params=variables["params"],
        momentum_batch_stats=bs, opt_state=tx.init(variables["params"]),
        queue=jnp.asarray(queue), queue_ptr=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0))
    step = jax_ssl.make_ssl_train_step(jnet, tx, objective, momentum=0.9, jit=True)
    jbatch = {"clips1": jnp.asarray(clips1), "clips2": jnp.asarray(clips2)}
    jstate, want_loss = compile_fast(step, jstate, jbatch, 0.1)(jstate, jbatch, 0.1)
    jax.clear_caches()

    before = state_dict_from_jax(variables)
    net.load_state_dict(before, strict=True)
    state = ssl.create_ssl_state(net, lambda p: optim.construct_optimizer(p, **opt),
                                 queue_size=6 if objective == "moco" else 0)
    if objective == "moco":
        state.queue = torch.from_numpy(queue)
    loss = ssl.make_ssl_train_step(objective, momentum=0.9)(
        state, {"clips1": torch.from_numpy(clips1), "clips2": torch.from_numpy(clips2)}, 0.1)
    assert abs(loss - float(want_loss)) <= 1e-5
    got, got_m = net.state_dict(), state.momentum_model.state_dict()
    _assert_moved_alike(got, before, jstate.params, "params", "params")
    _assert_moved_alike(got_m, before, jstate.momentum_params, "params", "momentum")
    if bs:
        _assert_moved_alike(got, before, jstate.batch_stats, "batch_stats", "stats")
        _assert_moved_alike(got_m, before, jstate.momentum_batch_stats, "batch_stats",
                            "momentum stats")
    if objective == "moco":
        np.testing.assert_allclose(state.queue.numpy(), np.asarray(jstate.queue), **TOL)
        assert state.queue_ptr == int(jstate.queue_ptr) == 2


@pytest.mark.parametrize("objective", ["moco", "simclr", "byol", "swav"])
def test_run_net_ssl_cli(rng, tmp_path, objective):
    """`python -m mspi_tpu_torch.run_net --task ssl --model mvitv2s` with
    `--device cpu` on a 4-video tree, one epoch of one batch of 4 at 2
    frames and crop 32 (the least the 32-stride trunk takes): one finite
    {"ssl": ...} line."""
    data_dir = str(tmp_path / "k400")
    _build_k400_tree(data_dir, rng, n_frames=4)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_net.main(["--task", "ssl", "--ssl_objective", objective, "--model", "mvitv2s",
                      "--data_dir", data_dir, "--epochs", "1", "--batch_size", "4",
                      "--num_frames", "2", "--sampling_rate", "1", "--crop_size", "32",
                      "--base_lr", "0.01", "--device", "cpu"])
    (line,) = [json.loads(s) for s in out.getvalue().splitlines() if s.startswith("{")]
    assert line["ssl"]["objective"] == objective and line["ssl"]["epoch"] == 0
    assert np.isfinite(line["ssl"]["loss"])
