"""The port's optimizers and LR policies (`mspi_tpu_torch.train.optim`)
against the JAX package's (`mspi_tpu.train.optim`, optax) on the CPU.

Each optimizer, with and without the zero-weight-decay partition of 1-D
parameters, runs 3 steps from one seeded tree of a 4-D conv kernel, a
matrix, a bias and a norm scale, on the same seeded gradients and a
changing LR; every parameter after each step within 1e-5 relative plus an
absolute 3e-5 of the LRs' sum (fp32, the same formulas in another order of
rounding: an Adam update is O(lr) and its first moment cancels between
steps whose gradients change sign, so its rounding scales with the LR, not
with the parameter). The LR policies agree to 1e-12 (Python floats in
both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mspi_tpu.train import optim as jax_optim
from mspi_tpu_torch.train import optim
from tests.torch_port_utils import cpu_share  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_share")

SHAPES = {"conv": (3, 3, 4, 5), "dense": (6, 4), "bias": (4,), "scale": (5,)}
LRS = (0.1, 0.05, 0.02)


def _tree(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("zero_wd", [True, False], ids=["zero_wd_1d", "wd_all"])
@pytest.mark.parametrize("method", optim.OPTIMIZERS)
def test_optimizer_matches_optax(rng, method, zero_wd):
    params = _tree(rng)
    grads = [_tree(rng) for _ in LRS]
    kw = dict(optimizing_method=method, base_lr=LRS[0], momentum=0.9, weight_decay=0.05,
              nesterov=True, zero_wd_1d_param=zero_wd)
    tx = jax_optim.construct_optimizer(jax.tree.map(jnp.asarray, params), **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    opt = optim.construct_optimizer(list(tparams.items()), **kw)
    for lr, g in zip(LRS, grads):
        state.hyperparams["learning_rate"] = lr
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        optim.set_lr(opt, lr)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       atol=3e-5 * sum(LRS), rtol=1e-5,
                                       err_msg=f"{method} {k}")


def test_wd_mask_matches_jax(rng):
    params = _tree(rng)
    want = jax_optim.wd_mask(params)
    got = optim.wd_mask([torch.from_numpy(v) for v in params.values()])
    assert got == [want[k] for k in params]


def test_unknown_optimizer_refused():
    with pytest.raises(NotImplementedError):
        optim.construct_optimizer([torch.zeros(2, requires_grad=True)], "rmsprop")


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, end_lr=1e-6, max_epoch=10),
    dict(base_lr=0.1, end_lr=1e-6, max_epoch=10, warmup_epochs=2.5, warmup_start_lr=0.01),
    dict(base_lr=0.4, end_lr=0.0, max_epoch=30, warmup_epochs=3, warmup_start_lr=1e-3,
         cosine_after_warmup=True),
])
def test_lr_cosine_matches_jax(kw):
    got, want = optim.lr_cosine(**kw), jax_optim.lr_cosine(**kw)
    for e in np.linspace(0, kw["max_epoch"] - 1e-3, 37):
        assert abs(got(e) - want(e)) <= 1e-12


@pytest.mark.parametrize("warmup", [0.0, 1.5])
def test_lr_steps_matches_jax(warmup):
    kw = dict(base_lr=0.2, lrs=(1, 0.1, 0.01), steps=(0, 4, 8), max_epoch=12,
              warmup_epochs=warmup, warmup_start_lr=0.02)
    got, want = optim.lr_steps_with_relative_lrs(**kw), jax_optim.lr_steps_with_relative_lrs(**kw)
    for e in np.linspace(0, 11.9, 41):
        assert abs(got(e) - want(e)) <= 1e-12


@pytest.mark.parametrize("warmup", [0, 2])
def test_cosine_scheduler_matches_jax(warmup):
    np.testing.assert_array_equal(optim.cosine_scheduler(0.5, 1e-4, 6, 7, warmup, 1e-3),
                                  jax_optim.cosine_scheduler(0.5, 1e-4, 6, 7, warmup, 1e-3))
