"""The port's data and tensor parallelism (`mspi_tpu_torch.parallel`,
`train.engine.make_ddp_train_step`, the training CLI's `--dp/--tp`) on the
CPU, in gloo groups of separate processes (`tests/torch_dist_worker.py`).

- DDP: the four-block MViT AV model (`SHALLOW_MVIT`, one SyncBlock block,
  128-wide SimSiam heads) at 64x96, global batch 2 over 2 ranks, one step
  against the JAX package's `make_ddp_train_step` on a 2-device CPU mesh
  from the same seeded variables, drop-path on fixed masks on both sides;
  exactly one all_reduce in the step; and against the port's own
  one-process steps on each sample, averaged, on one thread as the ranks
  run (metrics 1e-5, each gradient and statistic 1e-5 of its largest
  magnitude: the same arithmetic but for the all-reduce's sum). Against JAX, the tolerances of
  `tests/test_torch_train.py::test_train_step_matches_jax` (metrics 1e-4
  absolute, grad norm 1e-3 relative, BatchNorm statistics 1e-4 of their
  largest magnitude), but each averaged gradient (JAX's from its AdamW
  first moment, 0.1 g after one step) 5e-3 of its largest magnitude, not
  2e-3: a rank's BatchNorms normalise one sample, and the decoder's
  (the adapter's branches, `sa_1`'s mask conv) land 2.0-2.6e-3 in relative
  L2 from JAX's, uniformly over each tensor (fp32 batch statistics, their
  fast variance E[x^2] - mean^2 summed in another order over one sample).
- TP: the same model with its SyncBlock split over 2 ranks, global batch
  2 on one data rank, against JAX's TP step as `train.py` runs it
  (`make_train_step` under GSPMD, the state placed by `param_shardings` on
  a (1, 2) CPU mesh) from the same seeded variables, at the tolerances of
  `test_train_step_matches_jax` (metrics 1e-4 absolute, grad norm 1e-3
  relative, each gradient 2e-3 of its largest magnitude, BatchNorm
  statistics 1e-4); and against the port's one-process step
  (`make_ddp_train_step` without a mesh, the same drop-path draws, one
  thread as the ranks run): metrics 1e-5, every gradient 1e-4 of its
  largest magnitude (fp32, the split products' partial sums in another
  order). Both runs also write a checkpoint of the mesh: whole tensors in
  the one-device form, which a one-device state restores and from which
  every rank resumes its part exactly.
- classification: `run_classification_training` of a toy linear
  classifier over 2 data ranks, each decoding only its half of every
  training batch, against the same run in one process (losses 1e-6
  relative, the validation error exactly).
- the mesh arithmetic of the CLI, the batch split, the loader's rows, TP's
  width refusal, the CLI joining a group from MSPI_COORDINATOR.
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

import mspi_tpu.models.mvit as jax_mvit
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu.parallel import batch_sharding, param_shardings
from mspi_tpu.parallel import create_mesh as jax_create_mesh
from mspi_tpu.train import engine as jax_engine
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import fusion
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import layers
from mspi_tpu_torch.data.loader import DataLoader
from mspi_tpu_torch.parallel import Mesh, batch_shard, data_rows, free_port
from mspi_tpu_torch.parallel.tensor_parallel import TensorParallelBlock
from mspi_tpu_torch.train import __main__ as train_cli
from mspi_tpu_torch.train import checkpoints, engine
from mspi_tpu_torch.train.synthetic import make_batch
from tests.test_torch_train import _adam, _assert_leaves_close
from tests.torch_dist_worker import cls_history, fixed_drop_path
from tests.torch_port_utils import (SHALLOW_MVIT, FixedDropPathJax, compile_fast,  # noqa: F401
                                    cpu_share, seeded_variables)

pytestmark = pytest.mark.usefixtures("cpu_share")

REPO = Path(__file__).resolve().parents[1]
RES = (64, 96)
OVERRIDES = {"data": {"resolution": RES},
             "model": {"mvit": SHALLOW_MVIT, "sync_num_blocks": 1, "simsiam_hidden": 128}}
LR = 1e-4


def _setup(rng):
    """Seeded variables over the port model's tree, its state dict, and a
    global batch of 2 with uint8 clips."""
    port = AudioVisualSaliencyModel(get_config("mvitv2s", OVERRIDES), device="cpu")
    variables = jax.tree.map(np.asarray, seeded_variables(
        convert_state_dict(port.state_dict()), rng))
    port.load_state_dict(state_dict_from_jax(variables))
    batch = make_batch(rng, 2, 16, RES, (257, 111))
    batch["clips"] = (batch["clips"] * 255).astype(np.uint8)
    return variables, port.state_dict(), batch


def _start(tmp_path, mode, world, *args):
    """The worker in `mode` on `world` gloo ranks, each its own process
    (one thread each), started; `_wait` joins them."""
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_worker", mode,
                              str(tmp_path), str(r), str(world), str(port), *map(str, args)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _wait(procs):
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()[-3000:]


def _spawn(tmp_path, mode, world, *args):
    _wait(_start(tmp_path, mode, world, *args))


def _start_ranks(tmp_path, dp, tp, state_dict, batch):
    """One step on dp * tp gloo ranks, started: the test computes JAX's step
    meanwhile, and `_ranks_result` joins them for rank 0's results."""
    torch.save({"overrides": OVERRIDES, "state_dict": state_dict, "lr": LR,
                "batch": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in batch.items()}}, tmp_path / "in.pt")
    return _start(tmp_path, "step", dp * tp, dp, tp)


def _ranks_result(tmp_path, procs):
    _wait(procs)
    return torch.load(tmp_path / "out.pt", weights_only=False)


def _stats(sd):
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in ("running_mean",
                                                                    "running_var")}


def _jax_step(variables, batch, dp, tp):
    """One JAX step from `variables` on a (dp, tp) CPU mesh: the DDP step
    for tp = 1, else train.py's GSPMD step on the `param_shardings`
    placement. Its metrics, the gradients (from the AdamW first moment,
    0.1 g after one step) and the BatchNorm statistics, in the port's
    names."""
    jcfg = jax_get_config("mvitv2s", overrides=OVERRIDES)
    tx = jax_engine.make_optimizer(jcfg)
    jstate = jax_engine.create_train_state(jcfg, variables, tx)
    mesh = jax_create_mesh((dp, tp), devices=jax.devices()[:dp * tp])
    model = JaxModel(cfg=jcfg)
    if tp == 1:
        step = jax_engine.make_ddp_train_step(model, tx, 1.0, mesh, donate=False)
        jbatch = jax.tree.map(jnp.asarray, batch)
    else:
        jstate = jax.device_put(jstate, param_shardings(mesh, jstate))
        jbatch = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh, v.ndim))
                  for k, v in batch.items()}
        step = jax_engine.make_train_step(model, tx, 1.0, donate=False)
    lr = jnp.float32(LR)
    jstate, jmetrics = compile_fast(step, jstate, jbatch, lr)(jstate, jbatch, lr)
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    grads = dict(state_dict_from_jax({"params": jax.tree.map(
        lambda m: np.asarray(m) / 0.1, _adam(jstate.opt_state).mu)}))
    stats = _stats(state_dict_from_jax({"batch_stats": jax.tree.map(
        np.asarray, jstate.batch_stats)}))
    jax.clear_caches()
    return jmetrics, grads, stats


def _check_against_jax(got, jax_result, grad_rel):
    jmetrics, want_grads, want_stats = jax_result
    for k in ("kl", "cc", "sim", "loss_va", "loss"):
        assert abs(got["metrics"][k] - jmetrics[k]) <= 1e-4, (k, got["metrics"], jmetrics)
    assert abs(got["metrics"]["grad_norm"] - jmetrics["grad_norm"]) <= \
        1e-3 * jmetrics["grad_norm"]
    _assert_leaves_close(got["grads"], want_grads, grad_rel, "grad")
    _assert_leaves_close({k: got["state_dict"][k] for k in want_stats}, want_stats, 1e-4,
                         "stats")


def _check_checkpoint(got, cfg):
    """The mesh's checkpoint holds the gathered state in the one-device
    form, which a one-device state restores; every rank resumed its part."""
    assert got["resumed"]
    blob = torch.load(got["ckpt"], weights_only=False)
    assert blob["model"].keys() == got["state_dict"].keys()
    for k, v in got["state_dict"].items():
        assert torch.equal(blob["model"][k], v), k
    model = AudioVisualSaliencyModel(cfg, device="cpu")
    state, epoch = checkpoints.restore_checkpoint(got["ckpt"],
                                                  engine.create_train_state(cfg, model))
    assert epoch == 1
    shapes = {n: p.shape for n, p in model.named_parameters()}
    for i, st in state.optimizer.state_dict()["state"].items():
        assert st["exp_avg"].shape == shapes[state.param_names[i]]


def test_ddp_step_matches_jax(rng, monkeypatch, tmp_path):
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    monkeypatch.setattr(jax_mvit, "DropPath", FixedDropPathJax)
    variables, state_dict, batch = _setup(rng)
    ranks = _start_ranks(tmp_path, 2, 1, state_dict, batch)

    # the port alone: the mean of one-process steps on each sample, on one
    # thread as the ranks run (the same sums in the same order)
    monkeypatch.setattr(layers.DropPath, "forward", fixed_drop_path)
    cfg = get_config("mvitv2s", OVERRIDES)

    def port_alone():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        runs = []
        for i in range(2):
            model = AudioVisualSaliencyModel(cfg, device="cpu")
            model.load_state_dict(state_dict)
            state = engine.create_train_state(cfg, model)
            metrics = engine.make_ddp_train_step(1.0, None)(
                state, engine.to_device({k: v[i:i + 1] for k, v in batch.items()}, "cpu"), LR)
            params = dict(model.named_parameters())
            runs.append((metrics, {n: params[n].grad for n in state.param_names},
                         _stats(model.state_dict())))
        torch.set_num_threads(threads)
        return runs

    want = _jax_step(variables, batch, 2, 1)
    runs = port_alone()
    got = _ranks_result(tmp_path, ranks)
    assert got["all_reduce"] == 1
    _check_against_jax(got, want, 5e-3)
    for k in ("kl", "cc", "sim", "loss_va", "loss"):
        assert abs(got["metrics"][k] - (runs[0][0][k] + runs[1][0][k]) / 2) <= 1e-5, k
    for j, (what, have) in enumerate((("grad", got["grads"]),
                                      ("stats", _stats(got["state_dict"])))):
        mean = {n: (runs[0][j + 1][n] + runs[1][j + 1][n]) / 2 for n in runs[0][j + 1]}
        _assert_leaves_close(have, mean, 1e-5, what)
    _check_checkpoint(got, cfg)


def test_tp_step_matches_one_process(rng, monkeypatch, tmp_path):
    """TP 2 against JAX's TP step on a (1, 2) mesh and against the port's
    one-process step (the module docstring gives the tolerances)."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    monkeypatch.setattr(jax_mvit, "DropPath", FixedDropPathJax)
    variables, state_dict, batch = _setup(rng)
    ranks = _start_ranks(tmp_path, 1, 2, state_dict, batch)

    monkeypatch.setattr(layers.DropPath, "forward", fixed_drop_path)
    cfg = get_config("mvitv2s", OVERRIDES)
    model = AudioVisualSaliencyModel(cfg, device="cpu")
    model.load_state_dict(state_dict)
    state = engine.create_train_state(cfg, model)

    def port_alone():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as the ranks run
        metrics = engine.make_ddp_train_step(1.0, None)(state, engine.to_device(batch, "cpu"), LR)
        torch.set_num_threads(threads)
        return metrics

    want_jax = _jax_step(variables, batch, 1, 2)
    want = port_alone()
    got = _ranks_result(tmp_path, ranks)
    _check_against_jax(got, want_jax, 2e-3)
    params = dict(model.named_parameters())
    for k, v in want.items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got["metrics"], want)
    _assert_leaves_close(got["grads"], {n: params[n].grad for n in state.param_names}, 1e-4,
                         "grad")
    # the gathered state dict has the whole model's names and shapes
    assert {k: v.shape for k, v in got["state_dict"].items()} == \
        {k: v.shape for k, v in model.state_dict().items()}
    _check_checkpoint(got, cfg)


def test_classification_ddp_loads_its_rows(tmp_path):
    """2 data ranks, each decoding only its half of every training batch,
    train as one process does on whole batches (the toy classifier has no
    BatchNorm: the mean of the halves' gradients is the batch's)."""
    want, loaded = cls_history()
    _spawn(tmp_path, "cls", 2, 2)
    got = torch.load(tmp_path / "cls_out.pt", weights_only=False)
    assert got["loaded"] * 2 == loaded  # 2 epochs of 12 samples in one process
    assert len(got["history"]) == len(want) == 2
    for g, w in zip(got["history"], want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-6)
        assert g["val_top1_err"] == w["val_top1_err"]
        assert {k: g[k] for k in ("epoch", "lr", "t", "crop", "batch")} == \
            {k: w[k] for k in ("epoch", "lr", "t", "crop", "batch")}


def _mesh(dp, tp, rank=0):
    return Mesh(dp, tp, rank, None, None, torch.device("cpu"))


def test_tp_refuses_widths_off_the_kernel():
    block = fusion.Block(512, 4, mlp_ratio=4.25)  # H = 2176: 544 units a rank at tp 4
    with pytest.raises(ValueError, match="H % 64"):
        TensorParallelBlock(block, _mesh(1, 4))
    with pytest.raises(ValueError, match="heads"):
        TensorParallelBlock(fusion.Block(512, 4), _mesh(1, 3))


def test_batch_shard():
    batch = {"clips": np.arange(12).reshape(4, 3), "gt": np.arange(4)}
    parts = [batch_shard(batch, _mesh(2, 2, r)) for r in range(4)]
    for r, part in enumerate(parts):  # rank r at data index r // 2
        np.testing.assert_array_equal(part["gt"], batch["gt"][2 * (r // 2):2 * (r // 2) + 2])
    assert batch_shard(batch, None)["clips"] is batch["clips"]
    with pytest.raises(ValueError):
        batch_shard({"x": np.zeros(3)}, _mesh(2, 1))


class _Indexed:
    """Samples that hold their index; counts what is decoded."""

    def __init__(self):
        self.loaded = []

    def __len__(self):
        return 10

    def __getitem__(self, i):
        self.loaded.append(i)
        return np.int64(i)


def test_loader_decodes_its_rows():
    """With a data rank's rows, the loader decodes only those samples of
    each seeded batch; the ranks' parts make up the one-device batches."""
    def batches(rows):
        ds = _Indexed()
        loader = DataLoader(ds, 4, shuffle=True, drop_last=True, num_workers=2, seed=3,
                            rows=rows)
        loader.collate = staticmethod(np.stack)
        return list(loader), sorted(ds.loaded)

    whole, loaded = batches(slice(None))
    parts = [batches(data_rows(4, _mesh(2, 1, r))) for r in range(2)]
    assert len(loaded) == 8
    assert sorted(parts[0][1] + parts[1][1]) == loaded
    for i, batch in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([parts[0][0][i], parts[1][0][i]]), batch)


@pytest.mark.parametrize("dp,tp,n_dev,batch,want", [
    (None, 1, 8, 2, (2, 1)), (None, 2, 8, 16, (4, 2)), (3, 1, 8, 2, (1, 1)),
    (4, 2, 8, 8, (4, 2)), (None, 1, 1, 2, (1, 1)), (None, 2, 2, 2, (1, 2))])
def test_cli_mesh_shape(dp, tp, n_dev, batch, want):
    """train.py:136-141: dp = --dp or n_dev // tp, then gcd(dp, batch) or 1."""
    assert train_cli.mesh_shape(dp, tp, n_dev, batch) == want
    args = train_cli.parse_args(["--tp", str(tp)] + (["--dp", str(dp)] if dp else []))
    assert (args.dp, args.tp) == (dp, tp)


def test_cli_dp_tp_one_runs_one_device(monkeypatch):
    """--dp 1 --tp 1 takes today's path: `run` without a mesh, no ranks."""
    calls = []
    monkeypatch.setattr(train_cli, "run", lambda args, cfg, log_dir, mesh=None:
                        calls.append(mesh))
    train_cli.main(["--dp", "1", "--tp", "1", "--device", "cpu"])
    assert calls == [None]


def test_cli_joins_coordinator_group(monkeypatch):
    """With MSPI_COORDINATOR set (train.py calls maybe_init_distributed
    too), the CLI joins that group and runs as one rank of a mesh over its
    world, then leaves it."""
    import torch.distributed as dist

    meshes = []
    monkeypatch.setattr(train_cli, "run", lambda args, cfg, log_dir, mesh=None:
                        meshes.append((mesh.dp, mesh.tp, mesh.rank, log_dir)))
    monkeypatch.setenv("MSPI_COORDINATOR", f"localhost:{free_port()}")
    monkeypatch.setenv("MSPI_NUM_PROCESSES", "1")
    monkeypatch.setenv("MSPI_PROCESS_ID", "0")
    train_cli.main(["--device", "cpu", "--log_dir", "logs"])
    assert [m[:3] for m in meshes] == [(1, 1, 0)] and meshes[0][3].startswith("logs")
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="does not cover"):
        train_cli.main(["--device", "cpu", "--tp", "2"])
    assert not dist.is_initialized()


def test_maybe_init_distributed(monkeypatch):
    """A no-op without MSPI_COORDINATOR (as the JAX one); with it, a gloo
    group of MSPI_NUM_PROCESSES over TCP, this process MSPI_PROCESS_ID,
    on which `create_mesh` builds the default all-data mesh."""
    import torch.distributed as dist

    from mspi_tpu_torch.parallel import create_mesh, maybe_init_distributed

    monkeypatch.delenv("MSPI_COORDINATOR", raising=False)
    assert maybe_init_distributed() is False and not dist.is_initialized()
    monkeypatch.setenv("MSPI_COORDINATOR", f"localhost:{free_port()}")
    monkeypatch.setenv("MSPI_NUM_PROCESSES", "1")
    monkeypatch.setenv("MSPI_PROCESS_ID", "0")
    assert maybe_init_distributed("gloo") is True
    try:
        mesh = create_mesh()
        assert (mesh.dp, mesh.tp, mesh.rank, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0, 0)
        with pytest.raises(ValueError, match="world size"):
            create_mesh((2, 1))
    finally:
        dist.destroy_process_group()
