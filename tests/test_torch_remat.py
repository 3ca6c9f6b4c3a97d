"""`ModelConfig.remat` on the CPU: one training step with each MViT / VideoSwin
block recomputed in the backward pass (`ops.layers.checkpoint_block`)
against the same step without remat, from the same weights, batch and
drop-path generator:

- the gradient of every trainable tensor within 1e-6 of its scale (the same
  fp32 operations in both steps), the loss and aux values equal;
- the drop-path generator in the same state afterwards (the recompute draws
  the forward's masks and leaves the generator where the forward left it);
- each checkpointed block's forward run twice in the remat step and once
  without remat, so remat is not a no-op, and with it (no early stop) each
  MViT block's K1 and K2 calls; in eval mode and under no_grad it runs
  once;
- a recompute whose generator was not restored draws other masks, and its
  gradients differ: the restore is what keeps them equal.

Models: the four-block MViT (`SHALLOW_MVIT`; blocks 1-3 draw drop-path at
rates 0.067-0.2) at 32x32 and a (1,1,1,1)-deep VideoSwin at 64x96.
"""

import numpy as np
import pytest
import torch

from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.models.mvit import MultiScaleBlock
from mspi_tpu_torch.models.videoswin import SwinTransformerBlock3D
from mspi_tpu_torch.ops import layers
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from mspi_tpu_torch.train import engine
from mspi_tpu_torch.train.synthetic import make_batch
from tests.torch_port_utils import SHALLOW_MVIT, count_calls, cpu_share  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

CASES = {"mvitv2s": ((32, 32), {"mvit": SHALLOW_MVIT}, MultiScaleBlock),
         "videoswins": ((64, 96), {"videoswin": {"depths": (1, 1, 1, 1)}},
                        SwinTransformerBlock3D)}


def _model(encoder, remat):
    res, model_cfg, _ = CASES[encoder]
    cfg = get_config(encoder, {"data": {"resolution": res}, "model": {**model_cfg,
                                                                      "remat": remat}})
    return cfg, AudioVisualSaliencyModel(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(0))


def _count_block_calls(model, block_cls):
    calls = {}
    for name, m in model.named_modules():
        if isinstance(m, block_cls):
            calls[name] = 0
            m.register_forward_pre_hook(
                lambda mod, args, n=name: calls.__setitem__(n, calls[n] + 1))
    return calls


def _step(encoder, remat, batch):
    cfg, model = _model(encoder, remat)
    calls = _count_block_calls(model, CASES[encoder][2])
    state = engine.create_train_state(cfg, model, seed=11)
    metrics = engine.make_train_step(cfg.train.gamma)(state, batch, 1e-4)
    grads = {n: p.grad.clone() for n, p in zip(state.param_names,
                                               engine.trainable_parameters(state))}
    return metrics, grads, state.generator.get_state(), calls, model


@pytest.mark.parametrize("encoder", sorted(CASES))
def test_remat_step_matches_plain_step(encoder, monkeypatch):
    res = CASES[encoder][0]
    batch = engine.to_device(make_batch(np.random.default_rng(3), 2, 16, res, (257, 111)),
                             "cpu")
    fwd = {}
    count_calls(((PA, "_attention_rel_fwd"), (K2, "ln_mlp_reference")), fwd, monkeypatch)
    m_plain, g_plain, gen_plain, calls_plain, _ = _step(encoder, False, batch)
    fwd_plain = dict(fwd)
    m_remat, g_remat, gen_remat, calls_remat, model = _step(encoder, True, batch)
    assert calls_plain and set(calls_plain.values()) == {1}
    assert set(calls_remat.values()) == {2}, calls_remat
    if encoder == "mvitv2s":  # each block's K1 and K2 again in its recompute
        assert fwd_plain["_attention_rel_fwd"] == len(calls_plain)
        assert fwd == {k: 2 * n + len(calls_plain) for k, n in fwd_plain.items()}
    assert torch.equal(gen_remat, gen_plain)
    for k in m_plain:
        assert abs(m_remat[k] - m_plain[k]) <= 1e-6 * max(1.0, abs(m_plain[k])), k
    assert g_remat.keys() == g_plain.keys()
    for name, want in g_plain.items():
        scale = max(want.abs().max().item(), 1e-30)
        assert (g_remat[name] - want).abs().max().item() <= 1e-6 * scale, name

    # eval mode, and train mode under no_grad: no checkpoint, one forward each
    for k in calls_remat:
        calls_remat[k] = 0
    with torch.no_grad():
        model.eval()(batch["clips"], batch["audio"])
        model.train()(batch["clips"], batch["audio"])
    assert set(calls_remat.values()) == {2}


def test_remat_without_generator_restore_differs(monkeypatch):
    """The mutation the restore guards against: a checkpoint that keeps
    only the default generators lets the recompute draw fresh masks, and
    the step's gradients move off the plain step's."""
    batch = engine.to_device(make_batch(np.random.default_rng(3), 2, 16, (32, 32), (257, 111)),
                             "cpu")
    _, g_plain, _, _, _ = _step("mvitv2s", False, batch)

    def bare_checkpoint(block, *args):
        return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)

    monkeypatch.setattr("mspi_tpu_torch.models.mvit.checkpoint_block", bare_checkpoint)
    _, g_bare, _, _, _ = _step("mvitv2s", True, batch)
    worst = max((g_bare[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for n, g in g_plain.items())
    assert worst > 1e-3


def test_drop_path_generators_found_once():
    """checkpoint_block restores each distinct generator once, whatever the
    number of DropPath modules sharing it."""
    gen = torch.Generator().manual_seed(5)
    block = torch.nn.Sequential(layers.DropPath(0.5), layers.DropPath(0.5)).train()
    for m in block:
        m.generator = gen
    x = torch.ones(64, 3, requires_grad=True)
    y = layers.checkpoint_block(block, x)
    want_state = gen.get_state()
    y.sum().backward()
    assert torch.equal(gen.get_state(), want_state)
    keep = (y.detach()[:, 0] != 0).float()
    np.testing.assert_allclose(x.grad[:, 0].numpy(), (keep * 4.0).numpy())
