"""The port's masked pretraining (mspi_tpu_torch.models.masked,
`ops.layers.resize_to` and `run_net --task masked`) against the JAX package
on the CPU.

Tolerances: HOG, the resize and the loss 1e-5 (fp32, the same formulas);
the MaskedMViT forward 1e-4 (16 fp32 blocks' worth of summation order, here
four); one AdamW step's gradients 2e-3 of each tensor's largest magnitude,
as the port's other training-step tests.
"""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.config import MViTConfig as JaxMViTConfig
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models import masked as jax_masked
from mspi_tpu.ops.layers import resize_to as jax_resize_to
from mspi_tpu_torch import run_net
from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import masked
from mspi_tpu_torch.ops.layers import resize_to
from mspi_tpu_torch.train import optim
from tests.test_run_net_cli import _build_k400_tree
from tests.torch_port_utils import (SHALLOW_MVIT, compile_fast, cpu_share, jit_fast,  # noqa: F401
                                    load_port, seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

TOL = dict(atol=1e-5, rtol=1e-5)
CLIP = (16, 32, 32)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,cell", [((2, 32, 32, 3), 8), ((1, 16, 40, 3), 8),
                                        ((1, 12, 12, 3), 4)])
def test_hog_per_frame_matches_jax(rng, shape, cell):
    """Random frames (gradients of both signs, so negative phases that wrap
    modulo nbins), a ramp whose Sobel response is exactly 0 in one axis, and
    cells on the reflect border (every frame's outer cells)."""
    frames = _randn(rng, *shape)
    frames[0, :, :, 0] = np.arange(shape[2], dtype=np.float32)[None, :] * 0.5  # gy = 0
    want = jax.jit(functools.partial(jax_masked.hog_per_frame, nbins=9, cell=cell))(
        jnp.asarray(frames))
    got = masked.hog_per_frame(torch.from_numpy(frames), nbins=9, cell=cell)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ts,ss", [(2, 16), (1, 8)])
def test_hog_targets_match_jax(rng, ts, ss):
    clips = _randn(rng, 2, 4, 32, 32, 3)
    want = jax.jit(functools.partial(jax_masked.hog_targets, temporal_stride=ts,
                                     spatial_stride=ss, nbins=9, cell=8))(jnp.asarray(clips))
    got = masked.hog_targets(torch.from_numpy(clips), ts, ss, nbins=9, cell=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("src,dst", [((1, 1, 1), (8, 2, 2)), ((2, 3, 5), (2, 6, 10)),
                                     ((4, 6, 6), (2, 3, 4))])
def test_resize_to_matches_jax(rng, src, dst):
    """Up (1 -> 2, x2) and down (no antialias) along the three grid axes."""
    x = _randn(rng, 2, *src, 7)
    want = jax_resize_to(jnp.asarray(x), dst, (1, 2, 3))
    got = resize_to(torch.from_numpy(x), dst, (1, 2, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_masked_prediction_loss_and_mask(rng, normalize):
    """The loss against JAX's on the same mask; `random_patch_mask` puts
    exactly int(n * ratio) True entries in each sample (its draws are the
    port's own)."""
    mask = masked.random_patch_mask(torch.Generator().manual_seed(3), 2, (4, 8, 8), 0.4)
    assert mask.shape == (2, 4, 8, 8) and mask.dtype == torch.bool
    assert mask.reshape(2, -1).sum(1).tolist() == [int(256 * 0.4)] * 2
    pred, target = _randn(rng, 2, 4, 8, 8, 24), _randn(rng, 2, 4, 8, 8, 24)
    m = mask.float().numpy()
    want = jax_masked.masked_prediction_loss(jnp.asarray(pred), jnp.asarray(target),
                                             jnp.asarray(m), normalize_target=normalize)
    got = masked.masked_prediction_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                        mask, normalize_target=normalize)
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))


def _models(rng, target):
    """The JAX and the port MaskedMViT on one set of numpy variables (the
    JAX tree from the port's; the strict load holds it leaf for leaf)."""
    jmodel = jax_masked.MaskedMViT(cfg=JaxMViTConfig(**SHALLOW_MVIT), target=target)
    port = masked.MaskedMViT(MViTConfig(**SHALLOW_MVIT), target=target)
    variables = jax.tree.map(np.asarray, seeded_variables(
        convert_state_dict(port.state_dict()), rng))
    return jmodel, variables, load_port(port, variables)


@pytest.mark.parametrize("target", ["hog", "pixel"])
def test_masked_mvit_forward_matches_jax(rng, target):
    """MaskedMViT on the four-block MViT (`SHALLOW_MVIT`) at [1, 16, 32, 32,
    3], eval mode: prediction 1e-4, target 1e-5, on one 40% mask."""
    clips = _randn(rng, 1, *CLIP, 3)
    stride = 16 if target == "hog" else 4
    grid = (CLIP[0] // 2, CLIP[1] // stride, CLIP[2] // stride)
    mask = masked.random_patch_mask(torch.Generator().manual_seed(0), 1, grid).numpy()
    jmodel, variables, port = _models(rng, target)
    want_pred, want_target, _ = jit_fast(jmodel.apply, variables, jnp.asarray(clips),
                                                      jnp.asarray(mask))
    jax.clear_caches()
    with torch.no_grad():
        pred, tgt, _ = port(torch.from_numpy(clips), torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(pred), np.asarray(want_pred), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(tgt), np.asarray(want_target), **TOL)


def test_masked_step_matches_jax(rng):
    """One `run_net`-style step (HOG target, eval mode, optax's AdamW at LR
    1e-3, weight decay 0.05) at [2, 16, 32, 32, 3]: the loss 1e-5, each
    gradient 2e-3 of its own largest magnitude, against
    `jax.value_and_grad` of the JAX CLI's loss on the same mask; the AdamW
    step's first moments (0.1 g) the same way."""
    clips = _randn(rng, 2, *CLIP, 3)
    mask = masked.random_patch_mask(torch.Generator().manual_seed(1), 2, (8, 2, 2)).numpy()
    jmodel, variables, port = _models(rng, "hog")

    def loss_fn(p):
        pred, target, m = jmodel.apply({"params": p}, jnp.asarray(clips), jnp.asarray(mask))
        return jax_masked.masked_prediction_loss(pred, target, m.astype(jnp.float32),
                                                 normalize_target=False)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    want_loss, grads = compile_fast(grad_fn, variables["params"])(variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    jax.clear_caches()
    opt = optim.construct_optimizer(list(port.named_parameters()), "adamw", base_lr=1e-3,
                                    weight_decay=0.05, zero_wd_1d_param=False)
    loss = run_net.masked_train_step(port, opt, torch.from_numpy(clips), torch.from_numpy(mask),
                                     normalize_target=False)
    assert abs(loss - float(want_loss)) <= 1e-5
    params = dict(port.named_parameters())
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        for got, scale in ((params[name].grad, 1.0), (opt.state[params[name]]["exp_avg"], 0.1)):
            err = (got - scale * w).abs().max().item()
            assert err <= max(2e-3 * scale * w.abs().max().item(), scale * floor), name


@pytest.mark.parametrize("target", ["hog", "pixel"])
def test_run_net_masked_cli(rng, tmp_path, target):
    """`python -m mspi_tpu_torch.run_net --task masked` with `--device cpu`
    on a 4-video tree, one epoch of two batches of 2 at 2 frames and crop 32
    (the least MViTv2-S and the 16-pixel HOG grid take): one finite
    {"masked": ...} line."""
    data_dir = str(tmp_path / "k400")
    _build_k400_tree(data_dir, rng, n_frames=4)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_net.main(["--task", "masked", "--masked_target", target, "--data_dir", data_dir,
                      "--epochs", "1", "--batch_size", "2", "--num_frames", "2",
                      "--sampling_rate", "1", "--crop_size", "32", "--base_lr", "1e-4",
                      "--device", "cpu"])
    (line,) = [json.loads(s) for s in out.getvalue().splitlines() if s.startswith("{")]
    assert line["masked"]["target"] == target and line["masked"]["epoch"] == 0
    assert np.isfinite(line["masked"]["loss"])
