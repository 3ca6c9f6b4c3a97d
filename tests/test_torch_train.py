"""The port's training path (mspi_tpu_torch.train, the BatchNorm and
drop-path layers, the host data pipeline) against the JAX package on the
CPU, and the whole training step of the full-depth flagship at 32x64.

Tolerances: metrics and losses 1e-5 (fp32, the same formulas); BatchNorm
1e-5 (fp32 statistics in both); the whole step as stated in
`test_train_step_matches_jax`.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mspi_tpu.models.mvit as jax_mvit
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.data import datasets as jax_datasets
from mspi_tpu.data import loader as jax_loader
from mspi_tpu.data import video as jax_video
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu.ops.layers import batchnorm as jax_batchnorm
from mspi_tpu.train import engine as jax_engine
from mspi_tpu.train import loss as jax_loss
from mspi_tpu.train import metrics as jax_metrics
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.convert import adamw_state_dict_from_jax, state_dict_from_jax
from mspi_tpu_torch.data import datasets, loader, video
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import layers
from mspi_tpu_torch.train import checkpoints, engine, loss, metrics
from mspi_tpu_torch.train.synthetic import make_batch
from tests.synthetic_data import build_avsp_tree
from tests.torch_port_utils import (SHALLOW_MVIT, FixedDropPathJax, compile_fast, cpu_share,
                                    fixed_drop_path_port, load_port, seeded_variables,
                                    skipped_init, xdist_thread_share)

RES = (32, 64)
TOL = dict(atol=1e-5, rtol=1e-5)


def test_train_step_matches_jax(rng, monkeypatch):
    """One port training step of the full-depth flagship at 32x64, batch 2,
    fp32, against `jax.value_and_grad(_make_loss_fn(...))` plus the JAX
    AdamW update, from one set of seeded variables; drop-path is made
    deterministic on both sides. Then the port resumes from the JAX
    TrainState after step 1 (parameters, batch statistics and the AdamW
    moments converted) and its step 2 matches JAX's step 2.

    Tolerances (fp32, CPU kernels of two frameworks summing in different
    orders through 16 blocks and the decoder): loss and aux 1e-4 absolute,
    grad norm 1e-3 relative, each gradient and each AdamW moment 2e-3 of
    its own largest magnitude, BatchNorm statistics 1e-4 of theirs (with
    the ReLU-boundary allowance of `_assert_leaves_close`)."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    monkeypatch.setattr(jax_mvit, "DropPath", FixedDropPathJax)
    monkeypatch.setattr(layers.DropPath, "forward", fixed_drop_path_port)
    jcfg = jax_get_config("mvitv2s", overrides={"data": {"resolution": RES}})
    jmodel = JaxModel(cfg=jcfg)
    # the JAX variable tree from the port model's (the strict loads below
    # hold the two trees leaf for leaf), which spares tracing JAX's init
    cfg, model = _port_model(init=False)
    variables = _np_tree(dict(seeded_variables(convert_state_dict(model.state_dict()), rng)))
    batches = [_batch(rng) for _ in range(2)]
    lr = 1e-4

    # JAX: value_and_grad of the engine's loss plus make_train_step's update,
    # in one program compiled once (lr is a float32 array so that step 2
    # does not retrace)
    tx = jax_engine.make_optimizer(jcfg)
    grad_fn = jax.value_and_grad(jax_engine._make_loss_fn(jmodel, 1.0, True), has_aux=True)

    @jax.jit
    def jax_step(state, batch):
        (_, (aux, new_bs)), grads = grad_fn(state.params, state.frozen, state.batch_stats,
                                            batch, jax.random.PRNGKey(1))
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        aux = dict(aux, grad_norm=optax.global_norm(grads))
        return aux, grads, state.replace(params=optax.apply_updates(state.params, updates),
                                         opt_state=opt_state, batch_stats=new_bs)

    def jax_run():
        jstate = jax_engine.create_train_state(jcfg, variables, tx)
        steps, compiled = [], None
        for batch in batches:
            jstate.opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
            jbatch = jax.tree.map(jnp.asarray, batch)
            compiled = compiled or compile_fast(jax_step, jstate, jbatch)
            aux, grads, jstate = compiled(jstate, jbatch)
            aux = {k: float(v) for k, v in aux.items()}
            steps.append((aux, _np_tree(grads), _np_tree(jstate.batch_stats), _np_tree(jstate)))
        return steps

    def check_metrics(got, want):
        for k in ("kl", "cc", "sim", "loss_va", "loss"):
            assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-3 * want["grad_norm"]

    def check_moments(state, jax_state):
        adam = _adam(jax_state.opt_state)
        want = adamw_state_dict_from_jax(adam.count, adam.mu, adam.nu, state.optimizer,
                                         state.param_names)["state"]
        got = state.optimizer.state_dict()["state"]
        assert float(got[0]["step"]) == float(want[0]["step"])
        for key in ("exp_avg", "exp_avg_sq"):
            _assert_leaves_close({n: got[i][key] for i, n in enumerate(state.param_names)},
                                 {n: want[i][key] for i, n in enumerate(state.param_names)},
                                 2e-3, key)

    jax_steps = jax_run()
    jax.clear_caches()  # the compiled step is the largest thing this worker holds
    step = engine.make_train_step(1.0)
    port = load_port(model, variables)
    state = engine.create_train_state(cfg, port)
    got = step(state, engine.to_device(batches[0], "cpu"), lr)

    # step 1 from the same variables
    aux, grads, new_bs, jstate1 = jax_steps[0]
    check_metrics(got, aux)
    params = dict(port.named_parameters())
    _assert_leaves_close({n: params[n].grad for n in state.param_names},
                         dict(state_dict_from_jax({"params": grads})), 2e-3, "grad")
    want_bs = {k: v for k, v in state_dict_from_jax({"batch_stats": new_bs}).items()
               if not k.endswith("num_batches_tracked")}
    _assert_leaves_close({k: port.state_dict()[k] for k in want_bs}, want_bs, 1e-4, "stats")
    check_moments(state, jstate1)

    # step 2, resumed from the converted JAX TrainState after step 1
    _, model = _port_model(1, init=False)
    port = load_port(model, {"params": {**jstate1.params, **jstate1.frozen},
                             "batch_stats": jstate1.batch_stats})
    state = engine.create_train_state(cfg, port)
    adam = _adam(jstate1.opt_state)
    state.optimizer.load_state_dict(adamw_state_dict_from_jax(
        adam.count, adam.mu, adam.nu, state.optimizer, state.param_names))
    aux, _, _, jstate2 = jax_steps[1]
    check_metrics(step(state, engine.to_device(batches[1], "cpu"), lr), aux)
    check_moments(state, jstate2)


def test_train_cli_runs_on_cpu(tmp_path):
    root = build_avsp_tree(str(tmp_path / "data"))
    logs = tmp_path / "logs"
    share = xdist_thread_share()  # see cpu_share
    env = {**os.environ, **({"OMP_NUM_THREADS": str(share)} if share else {})}
    subprocess.run([sys.executable, "-m", "mspi_tpu_torch.train", "--data_root", root,
                    "--resolution", *map(str, RES), "--epochs", "1", "--monitored_epochs", "1",
                    "--device", "cpu", "--num_workers", "2", "--log_dir", str(logs)],
                   check=True, timeout=300, cwd=Path(__file__).resolve().parents[1],
                   capture_output=True, env=env)
    (run,) = logs.iterdir()
    assert (run / "checkpoints" / "ckpt_1").exists()
    (line,) = (run / "log" / "log.txt").read_text().splitlines()
    assert "train_loss" in line and "val_cc" in line


@pytest.mark.usefixtures("cpu_share")
def test_checkpoint_save_restore_then_identical_step(rng, tmp_path):
    """save after step 1, restore into a fresh model, step 2: bit-identical
    to the uninterrupted run (parameters, BN statistics, AdamW state and
    the drop-path generator all come back). The four-block MViT keeps the
    three steps cheap; its blocks 1-3 draw drop-path."""
    batches = [engine.to_device(_batch(rng), "cpu") for _ in range(2)]
    step = engine.make_train_step(1.0)
    cfg, model = _port_model(0, SHALLOW_MVIT)
    state = engine.create_train_state(cfg, model)
    step(state, batches[0], 1e-4)
    path = checkpoints.save_checkpoint(str(tmp_path), state, 1)
    assert checkpoints.latest_checkpoint(str(tmp_path)) == path
    want = step(state, batches[1], 1e-4)

    _, fresh = _port_model(1, SHALLOW_MVIT)
    restored, epoch = checkpoints.restore_checkpoint(path, engine.create_train_state(cfg, fresh))
    assert epoch == 1
    got = step(restored, batches[1], 1e-4)
    assert got == want
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("momentum,eps", [(0.1, 1e-5), (0.001, 1e-3)])
def test_batchnorm_train_mode_matches_flax(rng, momentum, eps):
    """Output and running statistics after one train-mode call, against the
    JAX package's flax BatchNorm (biased fast variance, flax momentum)."""
    x = (2.0 + 3.0 * rng.standard_normal((4, 3, 5, 6))).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.standard_normal(6)).astype(np.float32), \
        (0.1 * rng.standard_normal(6)).astype(np.float32)
    mean0, var0 = (0.1 * rng.standard_normal(6)).astype(np.float32), \
        rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bn = jax_batchnorm(momentum=momentum, epsilon=eps, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                         mutable=["batch_stats"])

    port = layers.BatchNorm(6, eps=eps, momentum=momentum)
    sd = state_dict_from_jax({c: {"bn": tree} for c, tree in variables.items()})
    port.load_state_dict({k[len("bn."):]: v for k, v in sd.items()})
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **TOL)
    port.eval()  # eval mode reads the running statistics
    ref = (x - port.running_mean.numpy()) / np.sqrt(port.running_var.numpy() + eps)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               ref * scale + bias, atol=1e-4, rtol=1e-4)


def test_drop_path_keep_rate_and_scaling():
    dp = layers.DropPath(0.3)
    x = torch.ones(20000, 3, 2)
    dp.train()
    dp.generator = torch.Generator().manual_seed(5)
    y = dp(x)
    kept = y[:, 0, 0] != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.015
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert (y[~kept] == 0).all()
    assert (y == y[:, :1, :1]).all()  # one draw per sample
    dp.generator = torch.Generator().manual_seed(5)
    assert torch.equal(dp(x), y)  # the generator alone decides the mask
    dp.eval()
    assert dp(x) is x
    with pytest.raises(RuntimeError):
        dp.train()
        dp.generator = None
        dp(x)


def _maps(rng, b=3, h=12, w=16):
    logits = rng.standard_normal((b, h, w)).astype(np.float32)
    log_pred = logits - np.log(np.exp(logits).sum(axis=(1, 2), keepdims=True))
    gt = rng.random((b, h, w)).astype(np.float32) ** 3
    fix = (rng.random((b, h, w)) > 0.9).astype(np.float32)
    return log_pred.astype(np.float32), gt, fix


@pytest.mark.parametrize("with_fixations", [False, True])
def test_sal_loss_matches_jax(rng, with_fixations):
    log_pred, gt, fix = _maps(rng)
    fixations = fix if with_fixations else None
    want, want_aux = jax_loss.sal_loss(jnp.asarray(log_pred), jnp.asarray(gt),
                                       None if fixations is None else jnp.asarray(fixations))
    got, got_aux = loss.sal_loss(torch.from_numpy(log_pred), torch.from_numpy(gt),
                                 None if fixations is None else torch.from_numpy(fixations))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["kldiv", "normalize_map", "similarity", "cc", "nss", "ig",
                                  "auc_judd", "auc_shuff"])
def test_metric_matches_jax(rng, name):
    log_pred, gt, fix = _maps(rng)
    s_map = np.exp(log_pred)
    if name in ("auc_judd", "auc_shuff"):
        args = (s_map[0], fix[0]) if name == "auc_judd" else (s_map[0], fix[0], fix[1])
        want = getattr(jax_metrics, name)(*args, rng=np.random.default_rng(1))
        got = getattr(metrics, name)(*args, rng=np.random.default_rng(1))
        assert got == want
        return
    other = {"nss": fix, "ig": gt}.get(name, gt)
    args = [s_map] if name == "normalize_map" else [s_map, other]
    if name == "ig":
        args.append(np.full_like(s_map, 0.5) + rng.random(s_map.shape).astype(np.float32))
    want = getattr(jax_metrics, name)(*map(jnp.asarray, args))
    got = getattr(metrics, name)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("max_epoch", [30, 120, 200])
def test_step_lr_schedule_matches_jax(max_epoch):
    assert (engine.step_lr_schedule(1e-4, max_epoch)
            == jax_engine.step_lr_schedule(1e-4, max_epoch))


def test_datasets_and_loader_match_jax(tmp_path):
    """Samples of both modes (fixations on) and the shuffled batches of the
    threaded loader equal the JAX package's, array for array."""
    root = build_avsp_tree(str(tmp_path))
    for mode, seed in (("train", 7), ("test", 8)):
        kw = dict(split=1, len_clip=8, mode=mode, size=(40, 56), load_fixations=True, seed=seed)
        want = jax_datasets.AudioVisualDataset(root, "AVAD", **kw)
        got = datasets.AudioVisualDataset(root, "AVAD", **kw)
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            a, b = got[i], want[i]
            for field in ("clip", "audio", "gt", "fixation"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field), field)
    sets = [datasets.build_training_datasets(root, 1, 8, True, (40, 56), seed=3),
            jax_datasets.build_training_datasets(root, 1, 8, True, (40, 56), seed=3)]
    assert [len(s) for s in sets[0]] == [len(s) for s in sets[1]] == [2, 4]
    got = list(loader.DataLoader(sets[0][0], 2, shuffle=True, num_workers=2, seed=4))
    want = list(jax_loader.DataLoader(sets[1][0], 2, shuffle=True, num_workers=2, seed=4))
    assert len(got) == len(want) == 1
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], want[0][key], key)


@pytest.mark.parametrize("helper", ["normalize_frames", "resize_fixation"])
def test_host_video_helpers_match_jax(rng, helper):
    """The host helpers the dataset does not reach in its test: exact."""
    if helper == "normalize_frames":
        u8 = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
        got = video.normalize_frames(u8)
        np.testing.assert_array_equal(got, jax_video.normalize_frames(u8))
        np.testing.assert_allclose(  # the device path computes the same affine
            layers.normalize_frames(torch.from_numpy(u8), torch.float32).numpy(), got,
            atol=1e-6, rtol=0)
    else:
        fix = (rng.random((37, 53)) > 0.97).astype(np.float32)
        for row, col in ((20, 30), (64, 96)):
            np.testing.assert_array_equal(video.resize_fixation(fix, row, col),
                                          jax_video.resize_fixation(fix, row, col))


def _batch(rng, batch=2):
    """A synthetic batch with uint8 clips, as the loader emits them."""
    b = make_batch(rng, batch, 16, RES, (257, 111))
    b["clips"] = (b["clips"] * 255).astype(np.uint8)
    return b


def _port_model(seed=0, mvit=None, init=True):
    """The flagship at RES; init=False: its tensors left as allocated, for a
    strict load to fill (`skipped_init`)."""
    model_cfg = {} if mvit is None else {"mvit": mvit}
    cfg = get_config("mvitv2s", {"data": {"resolution": RES}, "model": model_cfg})
    with contextlib.nullcontext() if init else skipped_init():
        return cfg, AudioVisualSaliencyModel(cfg, device="cpu",
                                             generator=torch.Generator().manual_seed(seed))


def _adam(opt_state):
    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
               if hasattr(s, "mu")]
    return adam


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_leaves_close(got: dict, want: dict, rel: float, what: str):
    """Each tensor against its own scale: |got - want| <= rel * max|want|
    elementwise, or 1e-6 of the largest magnitude in the whole tree (the
    rounding noise of a gradient that is zero in exact arithmetic: a conv
    bias in front of a train-mode BatchNorm or of the map's log-softmax),
    except for at most 1% of a tensor's elements (at least
    one), which may come from a ReLU whose input sits within rounding of 0
    and so switches on in one framework and off in the other (the
    adapter's branch0 BatchNorm has one at |y| < 1e-5 with these inputs);
    such a tensor must still agree to 5e-2 in relative L2 norm, or, where
    it is zero in exact arithmetic and so rounding noise on both sides, to
    ten times the floor in L2 norm (the noise of a sum over a map's
    pixels: the readout's last conv bias, in front of the log-softmax,
    reaches 1.5e-6 of the largest gradient in the port)."""
    assert set(got) == set(want), what
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        w = w.double().numpy()
        g = got[name].detach().double().numpy()
        assert g.shape == w.shape, (what, name)
        bad = np.abs(g - w) > max(rel * np.abs(w).max(), floor)
        assert bad.sum() <= max(1, 0.01 * w.size), f"{what} {name}: {bad.sum()} of {w.size}"
        if bad.any():
            assert np.linalg.norm(g - w) <= max(5e-2 * np.linalg.norm(w), 10 * floor), \
                f"{what} {name}"
