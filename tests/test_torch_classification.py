"""The port's video-classification surface against the JAX package on the
CPU: the ResNet transforms, heads, `zero_init_final_bn`, the classifier zoo
(all 12 names), MixUp / CutMix / smoothing / random erasing on the JAX
draws, the Kinetics sampling, the meters, the multigrid schedule, precise
BN, the scalar writer, one classification step, and `python -m
mspi_tpu_torch.run_net`.

Weights are seeded variables over the JAX module's tree, moved into the port
by `state_dict_from_jax` (strict). Tolerances (fp32) are stated per test.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mspi_tpu.models.mvit as jax_mvit
import mspi_tpu.models.resnet3d as jax_resnet3d
from mspi_tpu.config import MViTConfig as JaxMViTConfig
from mspi_tpu.config import UniFormerConfig as JaxUniFormerConfig
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.data import augment as jax_augment
from mspi_tpu.data import kinetics as jax_kinetics
from mspi_tpu.models import heads as jax_heads
from mspi_tpu.models import video_zoo as jax_zoo
from mspi_tpu.models.weight_init import zero_init_final_bn as jax_zero_init
from mspi_tpu.ops.pallas import mlp as jax_mlp
from mspi_tpu.ops.pallas import pooled_attention as jax_pa
from mspi_tpu.train import classification as jax_cls
from mspi_tpu.train import multigrid as jax_multigrid
from mspi_tpu.train import optim as jax_optim
from mspi_tpu.train import precise_bn as jax_precise_bn
from mspi_tpu.utils import meters as jax_meters
from mspi_tpu.utils import tensorboard as jax_tb
from mspi_tpu_torch import run_net
from mspi_tpu_torch.config import MViTConfig, UniFormerConfig
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.data import augment, kinetics
from mspi_tpu_torch.models import heads, resnet3d, video_zoo
from mspi_tpu_torch.models.weight_init import zero_init_final_bn
from mspi_tpu_torch.ops import kernels, layers
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.train import classification, multigrid, optim, precise_bn
from mspi_tpu_torch.utils import meters
from mspi_tpu_torch.utils import tensorboard
from tests.test_run_net_cli import _build_k400_tree
from tests.test_torch_train import _assert_leaves_close
from tests.torch_port_utils import (SHALLOW_MVIT, FixedDropPathJax, count_calls,  # noqa: F401
                                    cpu_share, fixed_drop_path_port, jax_module_variables,
                                    jit_fast, load_port, seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

TOL = dict(atol=1e-4, rtol=1e-4)
CLIP = (16, 32, 32)  # a classifier's input at the tests' size: T, H, W


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


@pytest.fixture(scope="module", autouse=True)
def free_jax_programs():
    yield
    jax.clear_caches()


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["basic_transform", "csn_transform", "r2plus1d_transform"])
def test_transform_matches_flax(rng, name, train):
    """Each new transform in a ResBlock (stride 2, projection shortcut) on
    [2, 4, 8, 10, 16], eval and train mode (every BatchNorm's running
    statistics after the call too); 1e-4."""
    args = (16, 32, 3, 2, name, 12)
    x = _randn(rng, 2, 4, 8, 10, 16)
    jax_block = jax_resnet3d.ResBlock(*args)
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x))
    port = load_port(resnet3d.ResBlock(*args), variables)
    if train:
        want, upd = jax_block.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        port.train()
        sd = port.state_dict()
        got = port(torch.from_numpy(x))
        for k, v in state_dict_from_jax({"batch_stats": upd["batch_stats"]}).items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TOL, err_msg=k)
    else:
        want = jax_block.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["resnet", "x3d", "transformer"])
def test_head_matches_flax(rng, name, train):
    """Each head in eval mode (class softmax) and in train mode without a
    dropout generator (logits; the JAX head without an rng); 1e-4 (X3DHead's
    lin_5 BatchNorm takes its train-mode statistics over the batch's 8
    pooled values)."""
    x = _randn(rng, 8, 2, 3, 3, 24)
    if name == "resnet":
        jax_head, port, args = jax_heads.ResNetBasicHead([24], 7, 0.5), \
            heads.ResNetBasicHead([24], 7, 0.5), [x]
    elif name == "x3d":
        jax_head, port, args = jax_heads.X3DHead(24, 20, 30, 7, bn_lin5_on=True), \
            heads.X3DHead(24, 20, 30, 7, bn_lin5_on=True), [x]
    else:
        jax_head, port, args = jax_heads.TransformerBasicHead(24, 7), \
            heads.TransformerBasicHead(24, 7), x
    jx = [jnp.asarray(x)] if isinstance(args, list) else jnp.asarray(x)
    variables = jax_module_variables(jax_head, rng, jx)
    load_port(port, variables)
    if train:
        want, _ = jax_head.apply(variables, jx, train=True, mutable=["batch_stats"])
        port.train()
    else:
        want = jax_head.apply(variables, jx)
    tx = [torch.from_numpy(x)] if isinstance(args, list) else torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(to_np(port(tx)), np.asarray(want), **TOL)


def test_head_dropout_on_a_generator(rng):
    """Dropout only in training and only with a generator: kept values
    scaled by 1 / keep, the same mask from the same seed."""
    head = heads.TransformerBasicHead(64, 5, dropout_rate=0.5).train()
    x = torch.from_numpy(_randn(rng, 4, 10, 64))
    a, b = (head(x, torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, head(x))
    mask = torch.rand((4, 64), generator=torch.Generator().manual_seed(3)) < 0.5
    pooled = x.mean(1)
    want = head.projection(torch.where(mask, pooled / 0.5, torch.zeros_like(pooled)))
    torch.testing.assert_close(a, want)


def test_zero_init_final_bn_matches_jax(rng):
    """A stage of basic, one of bottleneck and one of (2+1)D blocks: the
    same scales zeroed as the JAX transform zeroes in the variable tree."""
    for name in ("basic_transform", "bottleneck_transform", "r2plus1d_transform"):
        args = ([8], [16], [1], [[3]], [2], [8], [1], [2], name)
        x = _randn(rng, 1, 2, 4, 4, 8)
        variables = jax_module_variables(jax_resnet3d.ResStage(*args), rng, [jnp.asarray(x)])
        want = state_dict_from_jax({"params": jax_zero_init(
            jax.tree.map(np.asarray, variables["params"]))})
        port = zero_init_final_bn(load_port(resnet3d.ResStage(*args), variables))
        zeroed = sorted(k for k, v in port.state_dict().items() if v.dim() and not v.any())
        assert zeroed == sorted(k for k, v in want.items() if not v.any()) and zeroed, name


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


@pytest.mark.parametrize("name", video_zoo.CLASSIFIERS)
def test_build_classifier_takes_every_name(name):
    """The port's classifier, built on the meta device, converts
    (`mspi_tpu.convert.convert_state_dict`) to exactly the flax
    classifier's variable tree at 16x224x224, leaf for leaf and shape for
    shape: no key dropped, none extra."""
    with torch.device("meta"):
        port = video_zoo.build_classifier(name, 10)
    got = dict(_flat(convert_state_dict({k: torch.empty(v.shape)
                                         for k, v in port.state_dict().items()})))
    shapes = jax.eval_shape(lambda: jax_zoo.build_classifier(name, 10).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 224, 224, 3))))
    assert got == dict(_flat(shapes))


def _classifier_pair(name):
    if name == "mvitv2s":
        return (jax_zoo.MViTClassifier(JaxMViTConfig(**SHALLOW_MVIT), 10),
                video_zoo.MViTClassifier(MViTConfig(**SHALLOW_MVIT), 10),
                ((PA, "_attention_rel_fwd"), (K2, "ln_mlp")),
                ((jax_pa, "fused_attention_rel"), (jax_mlp, "fused_ln_mlp")))
    depth = {"depth": (1, 1, 1, 1)}
    return (jax_zoo.UniFormerClassifier(JaxUniFormerConfig(**depth), 10),
            video_zoo.UniFormerClassifier(UniFormerConfig(**depth), 10),
            ((PA, "_self_attention_fwd"), (K2, "ln_mlp")),
            ((jax_pa, "fused_self_attention"), (jax_mlp, "fused_ln_mlp")))


@pytest.mark.parametrize("name", ["mvitv2s", "uniformerb"])
def test_classifier_matches_flax(rng, monkeypatch, name):
    """The mvitv2s (four blocks, `SHALLOW_MVIT`) and uniformerb (one block a
    stage) classifiers at eval on [1, 16, 32, 32, 3], the JAX side's Pallas
    kernels in interpret mode, each kernel function's calls counted on both
    sides (MViT: K1 in its 4 blocks, K2 in them; UniFormer-B: K4 and K2 in
    its 2 SABlocks). The log class probabilities within 1e-4. The JAX side
    routes as its bf16 path does: in fp32 the TPU's VMEM budget
    (`fits_vmem_fwd`) would send MViT's C = 768 block to XLA's float MLP,
    which is lifted, as `tests/test_torch_prior_options.py` lifts it."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_mlp, "fits_vmem_fwd", lambda c, h, itemsize=2: True)
    jax_model, port, port_fns, jax_fns = _classifier_pair(name)
    x = _randn(rng, 1, *CLIP, 3)
    variables = jax_module_variables(jax_model, rng, jnp.asarray(x))
    load_port(port, variables)
    port_calls, jax_calls = {}, {}
    count_calls(port_fns, port_calls, monkeypatch)
    count_calls(jax_fns, jax_calls, monkeypatch)
    want = jit_fast(jax_model.apply, variables, jnp.asarray(x))  # counted as it traces
    jax.clear_caches()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    n = 4 if name == "mvitv2s" else 2
    assert list(port_calls.values()) == list(jax_calls.values()) == [n, n]
    np.testing.assert_allclose(np.log(to_np(got)), np.log(np.asarray(want)), **TOL)


def _trace(opt_state):
    (trace,) = [s.trace for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return trace


def test_cls_train_step_matches_jax(rng, monkeypatch):
    """One step of the mvitv2s classifier (`SHALLOW_MVIT`, no head
    dropout, drop-path on fixed masks) at [2, 16, 32, 32, 3]: cross-entropy
    with label smoothing 0.1, SGD with nesterov momentum 0.9 and coupled
    weight decay 1e-4, against `make_cls_train_step` with
    `construct_optimizer`. The loss within 1e-5; the logits 1e-4; each
    tensor's momentum buffer after the step (g + wd p on both sides) 2e-3 of
    its largest magnitude (`_assert_leaves_close`)."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    monkeypatch.setattr(jax_mvit, "DropPath", FixedDropPathJax)
    monkeypatch.setattr(layers.DropPath, "forward", fixed_drop_path_port)
    jax_model = jax_zoo.MViTClassifier(JaxMViTConfig(**SHALLOW_MVIT), 10, dropout_rate=0.0)
    clips, labels = _randn(rng, 2, *CLIP, 3), np.array([3, 7])
    variables = jax_module_variables(jax_model, rng, jnp.asarray(clips))
    kw = dict(optimizing_method="sgd", base_lr=0.1, weight_decay=1e-4, zero_wd_1d_param=False)
    tx = jax_optim.construct_optimizer(None, **kw)
    state = jax_cls.ClsTrainState(params=variables["params"], batch_stats={},
                                  opt_state=tx.init(variables["params"]),
                                  rng=jax.random.PRNGKey(0))
    step = jax_cls.make_cls_train_step(jax_model, tx, label_smoothing=0.1)
    state, want_loss, want_logits = step(state, {"clips": jnp.asarray(clips),
                                                 "labels": jnp.asarray(labels)}, 0.1)
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, _trace(state.opt_state))})
    jax.clear_caches()

    port = load_port(video_zoo.MViTClassifier(MViTConfig(**SHALLOW_MVIT), 10, 0.0), variables)
    pstate = classification.create_cls_state(
        port, lambda params: optim.construct_optimizer(params, **kw))
    loss, logits = classification.make_cls_train_step(label_smoothing=0.1)(
        pstate, {"clips": torch.from_numpy(clips), "labels": torch.from_numpy(labels)}, 0.1)
    assert abs(loss - float(want_loss)) <= 1e-5
    np.testing.assert_allclose(to_np(logits), np.asarray(want_logits), **TOL)
    params = dict(port.named_parameters())
    got = {n: pstate.optimizer.state[params[n]]["momentum_buffer"] for n in want}
    _assert_leaves_close(got, dict(want), 2e-3, "trace")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(rng, smoothing):
    logits, labels = _randn(rng, 4, 9), np.array([0, 8, 3, 3])
    want = jax_cls.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = classification.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       smoothing)
    assert abs(float(got) - float(want)) <= 1e-6
    targets = np.asarray(jax_augment.one_hot_smooth(jnp.asarray(labels), 9, 0.2))
    assert abs(float(classification.soft_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets))) - float(
        jax_cls.soft_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))) <= 1e-6


def test_mixup_cutmix_match_jax_on_its_draws(rng):
    """MixUp and CutMix on [4, 2, 12, 10, 3] with the draws the JAX
    transforms make from their key (lambda; CutMix's box centre), and the
    label smoothing; 1e-6."""
    clips, labels = _randn(rng, 4, 2, 12, 10, 3), np.array([1, 0, 4, 2])
    t_clips, t_labels = torch.from_numpy(clips), torch.from_numpy(labels)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jax_augment.mixup_batch(key, jnp.asarray(clips), jnp.asarray(labels), 5, 0.8, 0.1)
        lam = float(jax.random.beta(key, 0.8, 0.8))
        got = augment.mixup_batch(t_clips, t_labels, 5, lam, 0.1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-6, rtol=1e-6)
        want = jax_augment.cutmix_batch(key, jnp.asarray(clips), jnp.asarray(labels), 5, 1.0,
                                        0.1)
        k1, k2, k3 = jax.random.split(key, 3)
        got = augment.cutmix_batch(t_clips, t_labels, 5, float(jax.random.beta(k1, 1.0, 1.0)),
                                   int(jax.random.randint(k2, (), 0, 12)),
                                   int(jax.random.randint(k3, (), 0, 10)), 0.1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_random_erasing_matches_jax_on_its_draws(rng):
    """Random erasing with prob 0.6 on [6, 2, 16, 12, 3] with the draws
    the JAX transform makes per sample (whether, area, aspect, position,
    noise): bit-equal."""
    clips = _randn(rng, 6, 2, 16, 12, 3)
    key = jax.random.PRNGKey(4)
    want = jax_augment.random_erasing(key, jnp.asarray(clips), prob=0.6)
    draws = {"apply": [], "area": [], "log_ratio": [], "y": [], "x": [], "noise": []}
    for kb, clip in zip(jax.random.split(key, 6), clips):
        k_apply, k_area, k_aspect, k_y, k_x, k_noise = jax.random.split(kb, 6)
        area = 16 * 12 * jax.random.uniform(k_area, (), minval=0.02, maxval=1 / 3)
        log_ratio = jax.random.uniform(k_aspect, (), minval=jnp.log(0.3),
                                       maxval=jnp.log(1 / 0.3))
        h, w = augment.erasing_box(16, 12, float(area), float(log_ratio))
        draws["apply"].append(bool(jax.random.uniform(k_apply) < 0.6))
        draws["area"].append(float(area))
        draws["log_ratio"].append(float(log_ratio))
        draws["y"].append(int(jax.random.randint(k_y, (), 0, 16 - h)))
        draws["x"].append(int(jax.random.randint(k_x, (), 0, 12 - w)))
        draws["noise"].append(np.asarray(jax.random.normal(k_noise, clip.shape)))
    draws["noise"] = torch.from_numpy(np.stack(draws["noise"]))
    assert 0 < sum(draws["apply"]) < 6
    got = augment.random_erasing(torch.from_numpy(clips), draws)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    own = augment.draw_erasing(torch.Generator().manual_seed(0), torch.from_numpy(clips), 0.6)
    assert len(own["apply"]) == 6 and own["noise"].shape == clips.shape


def test_kinetics_sampling_matches_jax(rng, tmp_path):
    """The temporal and spatial sampling and the val / test clips of a
    frame tree (the JAX module's, bit for bit: the port keeps its own copy)."""
    for args in ((50, 10.0, 30.0, 8), (5, 0.0, 15.0, 16)):
        np.testing.assert_array_equal(kinetics.temporal_sampling(*args),
                                      jax_kinetics.temporal_sampling(*args))
    for clip_idx in (0, 4, 9):
        assert kinetics.get_start_end_idx(80, 32, clip_idx, 10) == \
            jax_kinetics.get_start_end_idx(80, 32, clip_idx, 10)
    assert kinetics.get_start_end_idx(80, 32, -1, 1, np.random.default_rng(1)) == \
        jax_kinetics.get_start_end_idx(80, 32, -1, 1, np.random.default_rng(1))
    frames = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    for idx in (-1, 0, 1, 2):
        np.testing.assert_array_equal(
            kinetics.spatial_resize_crop(frames, 32, 40, 24, idx, np.random.default_rng(2), True),
            jax_kinetics.spatial_resize_crop(frames, 32, 40, 24, idx,
                                             np.random.default_rng(2), True))
    root = str(tmp_path / "k400")
    _build_k400_tree(root, rng, n_videos=2, n_frames=12)
    for split in ("val", "train"):
        a = kinetics.KineticsFrames(root, split, 4, 2, 32)
        b = jax_kinetics.KineticsFrames(root, split, 4, 2, 32)
        for i in range(len(a)):
            sa, sb = a[i], b[i]
            np.testing.assert_array_equal(sa.clip, sb.clip)
            assert (sa.label, sa.index) == (sb.label, sb.index)


def test_meters_match_jax(rng):
    preds, labels = rng.random((12, 6)), rng.integers(0, 6, 12)
    assert meters.topk_errors(preds, labels, (1, 5)) == \
        jax_meters.topk_errors(preds, labels, (1, 5))
    got, want = meters.TrainMeter(3, 2), jax_meters.TrainMeter(3, 2)
    vals, wals = meters.ValMeter(3), jax_meters.ValMeter(3)
    for i in range(3):
        for m in (got, want):
            m.update_stats(10.0 * i, 20.0, 0.5 + i, 0.1, 4)
        for m in (vals, wals):
            m.update_stats(30.0 - i, 40.0, 4)
    a, b = got.get_epoch_stats(0), want.get_epoch_stats(0)
    a.pop("time"), b.pop("time")
    assert a == b and vals.get_epoch_stats(1) == wals.get_epoch_stats(1)
    tests = [cls(3, 2, 6) for cls in (meters.TestMeter, jax_meters.TestMeter)]
    for m in tests:
        m.update_stats(preds[:6].astype(np.float32), np.repeat(labels[:3], 2), np.arange(6))
    assert tests[0].finalize_metrics() == tests[1].finalize_metrics()


def test_multigrid_matches_jax():
    got, want = multigrid.MultigridSchedule(), jax_multigrid.MultigridSchedule()
    assert got.schedule(20, 16, 224, 8) == want.schedule(20, 16, 224, 8)
    sched = want.schedule(20, 16, 224, 8)
    assert all(got.get_current(sched, e) == want.get_current(sched, e) for e in range(20))
    assert multigrid.short_cycle_crops(224) == jax_multigrid.short_cycle_crops(224)
    a = list(multigrid.short_cycle_batches(50, 4, 224, rng=np.random.default_rng(0)))
    b = list(jax_multigrid.short_cycle_batches(50, 4, 224, rng=np.random.default_rng(0)))
    assert len(a) == len(b) and all((x[0] == y[0]).all() and x[1] == y[1]
                                    for x, y in zip(a, b))


def test_precise_bn_matches_jax(rng):
    """A bottleneck ResStage's BatchNorm statistics after precise BN over 3
    batches (two stats-bearing layers deep, so the calibration must hold
    through the train-mode forward), against `update_precise_bn`; 1e-5."""
    args = ([8], [16], [1], [[3]], [2], [8], [1], [2])
    batches = [[jnp.asarray(_randn(rng, 2, 2, 4, 4, 8) * 2 + 1)] for _ in range(4)]
    jax_stage = jax_resnet3d.ResStage(*args)
    variables = jax_module_variables(jax_stage, rng, batches[0][0])
    want = jax_precise_bn.update_precise_bn(jax_stage, variables, batches,
                                            lambda b: (b,), num_batches=3)
    port = load_port(resnet3d.ResStage(*args), variables)
    precise_bn.update_precise_bn(port, [[torch.from_numpy(np.asarray(b[0]))] for b in batches],
                                 lambda b: (b,), num_batches=3)
    assert not port.training
    sd = port.state_dict()
    for k, v in state_dict_from_jax({"batch_stats": want["batch_stats"]}).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        else:
            assert int(sd[k]) == 0  # the batch counters as they were


def test_scalar_writer_matches_jax(tmp_path):
    """The event encoding of the port's copy: CRC32C, scalar and
    histogram summaries byte-equal to the JAX module's; a written file."""
    assert tensorboard.crc32c(b"123456789") == jax_tb.crc32c(b"123456789") == 0xE3069283
    assert tensorboard._scalar_value("a/b", 1.5) == jax_tb._scalar_value("a/b", 1.5)
    values = np.linspace(-1, 2, 40)
    assert tensorboard._histo_value("h", values) == jax_tb._histo_value("h", values)
    writer = tensorboard.SummaryWriter(str(tmp_path))
    writer.add_scalars({"train/loss": 0.5, "train/lr": 0.1}, step=1)
    writer.add_weight_histograms(torch.nn.Linear(3, 2), step=1)
    writer.close()
    (event,) = tmp_path.iterdir()
    assert event.stat().st_size > 0


def test_run_net_cli_trains_and_evaluates(rng, tmp_path):
    """`python -m mspi_tpu_torch.run_net --model x3dl` on the JAX CLI
    test's 4-video tree with `--device cpu`, in this process: the train and
    val JSON lines; an epoch checkpoint the second run resumes from."""
    data_dir = str(tmp_path / "k400")
    _build_k400_tree(data_dir, rng)
    argv = ["--model", "x3dl", "--data_dir", data_dir, "--mode", "train", "--num_classes", "2",
            "--epochs", "1", "--batch_size", "2", "--num_frames", "8", "--sampling_rate", "2",
            "--crop_size", "64", "--device", "cpu", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--auto_resume"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_net.main(argv)
    stats = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    train = next(s["train"] for s in stats if "train" in s)
    assert np.isfinite(train["loss"]) and (train["t"], train["crop"], train["batch"]) == (8, 64, 2)
    assert next(s["val"] for s in stats if "val" in s)["epoch"] == 0
    assert (tmp_path / "ckpt" / "ckpt_0").exists()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_net.main(argv[:-3] + ["--epochs", "2", "--ckpt_dir", str(tmp_path / "ckpt"),
                                  "--auto_resume"])
    assert "auto-resumed from epoch 0" in out.getvalue()
    assert '"epoch": 1' in out.getvalue() and '"epoch": 0,' not in out.getvalue()


def test_new_modules_import_no_jax():
    """The modules of the classification surface and the parallel layer
    import neither JAX, flax nor the JAX package (as
    `tests/test_torch_slice.py::test_port_imports_no_jax` holds the rest)."""
    import subprocess
    import sys
    from pathlib import Path

    modules = ("run_net", "parallel", "parallel.tensor_parallel", "train.optim",
               "train.classification", "train.multigrid", "train.precise_bn",
               "models.video_zoo", "models.heads", "models.weight_init", "data.augment",
               "data.kinetics", "utils.meters", "utils.tensorboard")
    code = ("import sys; before = set(sys.modules); "
            + "; ".join(f"import mspi_tpu_torch.{m}" for m in modules)
            + "; new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'flax', 'mspi_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])


class _ToyClassifier(torch.nn.Module):
    """A linear classifier on the clip's mean colour, with the zoo's
    contract: logits in training, the softmax at eval."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 4)

    def forward(self, clips, generator=None):
        logits = self.fc(clips.mean(dim=(1, 2, 3)))
        return logits if self.training else torch.softmax(logits, -1)


def test_epoch_loops_and_multiview_test(rng):
    """`train_epoch`, `eval_epoch` and `perform_test` on three batches:
    the meters' statistics are those of the JAX meters fed the same
    predictions; the test ensemble sums each video's two clips."""
    batches = [{"clips": _randn(rng, 2, 2, 4, 4, 3), "labels": np.array([i % 4, 3]),
                "indices": np.array([2 * i, 2 * i + 1])} for i in range(3)]
    state = classification.create_cls_state(
        _ToyClassifier(), lambda p: optim.construct_optimizer(p, "sgd", 0.1))
    state, stats = classification.train_epoch(
        state, classification.make_cls_train_step(), batches, lambda e: 0.1, 0, 3)
    assert stats["epoch"] == 0 and np.isfinite(stats["loss"]) and "top1_err" in stats
    eval_step = classification.make_cls_eval_step()
    got = classification.eval_epoch(state, eval_step, batches, 0, 3)
    meter = jax_meters.ValMeter(3)
    preds = [eval_step(state, torch.from_numpy(b["clips"])).numpy() for b in batches]
    for p, b in zip(preds, batches):
        meter.update_stats(*jax_meters.topk_errors(p, b["labels"], (1, 5)), 2)
    assert got == meter.get_epoch_stats(0)
    test = classification.perform_test(state, eval_step, [
        {**b, "labels": np.full(2, b["labels"][0]), "indices": np.array([2 * i, 2 * i + 1])}
        for i, b in enumerate(batches)], 3, 2, 4)
    want = jax_meters.TestMeter(3, 2, 4)
    for i, (p, b) in enumerate(zip(preds, batches)):
        want.update_stats(p, np.full(2, b["labels"][0]), np.array([2 * i, 2 * i + 1]))
    assert test == want.finalize_metrics()
