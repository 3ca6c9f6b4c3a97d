"""The port's VideoSwin-S slice against the JAX package on the CPU.

- `WindowAttention3D` and `SwinTransformerBlock3D` (shifted and unshifted)
  against their flax modules, with the JAX side's Pallas kernels on in
  interpret mode;
- the full-config `VideoSwinFeatures` forward at 16x64x96 (stages 3-4 clamp
  their windows there, so the bug-compatible bias index runs too) and the
  gradients of a (2,2,2,2)-deep backbone against `jax.grad`, under both of
  the JAX package's bias-table backwards (`MSPI_SWIN_SEP_DTABLE`);
- the `videoswins` AudioVisualSaliencyModel forward at 64x96;
- the entry-point repairs: the inference CLI's `--motion_encoder` and the
  mmaction `backbone.` prefix in `load_pretrained_encoders`.

Weights are seeded variables over the JAX module's tree (from flax's init,
or for the deep models from the port's state_dict through the JAX
package's converter), moved into the port by `state_dict_from_jax`
(strict). Tolerances are stated per test (fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.config import VideoSwinConfig as JaxSwinConfig
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models import videoswin as jax_swin
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import VideoSwinConfig, get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models import videoswin
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.train.checkpoints import load_pretrained_encoders
from tests.torch_port_utils import (cpu_share, jax_module_variables, jit_fast, load_port,
                                    seeded_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (64, 96)
TOL = dict(atol=1e-4, rtol=1e-4)


def test_videoswin_av_model_matches_jax(rng, monkeypatch):
    """The whole videoswins AudioVisualSaliencyModel at 64x96, batch 1,
    uint8 clips, with a (2,2,2,2)-deep backbone (the full depth is held to
    flax above; JAX's compile of the whole model grows with it);
    tolerances as the MViT flagship's (atol 5e-4, rtol 1e-3). The variable
    tree comes from the port's state_dict through the JAX package's
    converter (flax's init trace of the whole model takes longer than the
    comparison itself)."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    cfg = {"data": {"resolution": RES}, "model": {"videoswin": {"depths": (2, 2, 2, 2)}}}
    jax_model = JaxModel(cfg=jax_get_config("videoswins", overrides=cfg))
    port = AudioVisualSaliencyModel(get_config("videoswins", cfg), device="cpu")
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips),
                                               jnp.asarray(auds))
    jax.clear_caches()
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))
    assert got.shape == (1, *RES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    assert abs(float(got_loss) - float(want_loss)) < 1e-4


def test_window_attention_module_matches_flax(rng, monkeypatch):
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    window, heads, nW = (2, 4, 4), 2, 2
    N = 32
    x = rng.standard_normal((2 * nW, N, 64)).astype(np.float32)
    mask = np.where(rng.random((nW, N, N)) > 0.8, -100.0, 0.0).astype(np.float32)
    jax_attn = jax_swin.WindowAttention3D(dim=64, window_size=window, num_heads=heads)
    variables = jax_module_variables(jax_attn, rng, jnp.asarray(x))
    port = load_port(videoswin.WindowAttention3D(64, window, heads), variables)
    for m in (None, mask):
        want = jit_fast(jax_attn.apply, variables, jnp.asarray(x),
                        None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = port(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 2)])
def test_swin_block_matches_flax(rng, monkeypatch, shift):
    """A block on a [2, 4, 6, 10, 64] grid with window (2,4,4): H and W pad
    to whole windows; the shifted case rolls and masks."""
    monkeypatch.setenv("MSPI_PALLAS_INTERPRET", "1")
    window = (2, 4, 4)
    x = rng.standard_normal((2, 4, 6, 10, 64)).astype(np.float32)
    Dp, Hp, Wp = 4, 8, 12
    mask = jax_swin._attn_mask(Dp, Hp, Wp, window, (1, 2, 2))
    jax_block = jax_swin.SwinTransformerBlock3D(dim=64, num_heads=2, window_size=window,
                                                shift_size=shift)
    variables = jax_module_variables(jax_block, rng, jnp.asarray(x), jnp.asarray(mask))
    want = jit_fast(jax_block.apply, variables, jnp.asarray(x), jnp.asarray(mask))
    port = load_port(videoswin.SwinTransformerBlock3D(64, 2, window, shift), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def _backbone(depths):
    jcfg = dataclasses.replace(JaxSwinConfig(), depths=depths)
    return (jax_swin.VideoSwinFeatures(cfg=jcfg),
            videoswin.VideoSwinFeatures(dataclasses.replace(VideoSwinConfig(), depths=depths)))


def test_videoswin_features_match_flax(rng, monkeypatch):
    """Full VideoSwin-S config (depths 2,2,18,2); JAX runs its default CPU
    path (Pallas off). Tolerance atol 2e-4, rtol 1e-3 over 24 blocks. The
    variables come from the port's state_dict through the JAX package's
    converter (flax's init trace costs seconds at this depth); the
    gradient tests below hold the trees' names leaf for leaf."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    jax_model, port = _backbone((2, 2, 18, 2))
    x = rng.standard_normal((1, 16, *RES, 3)).astype(np.float32)
    variables = seeded_variables(convert_state_dict(port.state_dict()), rng)
    want = jit_fast(jax_model.apply, variables, jnp.asarray(x))
    load_port(port, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w, c in zip(got, want, (96, 192, 384, 768)):
        assert g.shape[0] == 1 and g.shape[1] == 8 and g.shape[-1] == c
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=2e-4, rtol=1e-3)
    jax.clear_caches()


@pytest.fixture(scope="module")
def shallow_backbone():
    """A (2,2,2,2)-deep backbone's seeded JAX variables, input and feature
    weights, shared by both gradient tests."""
    rng = np.random.default_rng(7)
    jax_model, _ = _backbone((2, 2, 2, 2))
    x = rng.standard_normal((1, 16, *RES, 3)).astype(np.float32)
    variables = jax_module_variables(jax_model, rng, jnp.asarray(x))
    feats = jax.eval_shape(jax_model.apply, variables, jnp.asarray(x))
    ws = [rng.standard_normal(f.shape).astype(np.float32) for f in feats]
    return variables, x, ws


@pytest.mark.parametrize("sep_dtable", ["0", "1"])
def test_videoswin_grads_match_jax(shallow_backbone, monkeypatch, sep_dtable):
    """Gradients of sum(w_i * feature_i) with respect to every parameter of
    a (2,2,2,2)-deep backbone, against jax.grad with the bias table's
    backward as autodiff's scatter (0) or the separable one-hot einsums (1);
    each gradient within 1e-4 of its own largest magnitude."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    monkeypatch.setenv("MSPI_SWIN_SEP_DTABLE", sep_dtable)
    variables, x, ws = shallow_backbone
    jax_model, port = _backbone((2, 2, 2, 2))

    def loss(params):
        out = jax_model.apply({"params": params}, jnp.asarray(x))
        return sum(jnp.sum(o * w) for o, w in zip(out, ws))

    want = state_dict_from_jax({"params": jax.jit(jax.grad(loss))(variables["params"])})
    jax.clear_caches()
    load_port(port, variables)
    out = port(torch.from_numpy(x))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, ws)).backward()
    grads = dict(port.named_parameters())
    assert set(grads) == set(want)
    for name, p in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_videoswins_config_matches_jax():
    got, want = get_config("videoswins").model, jax_get_config("videoswins").model
    assert got.motion_encoder == want.motion_encoder == "videoswins"
    assert (got.embed_dims, got.pyramid_tdims, got.lateral_bool) == \
        (want.embed_dims, want.pyramid_tdims, want.lateral_bool)
    for f in dataclasses.fields(VideoSwinConfig):
        assert getattr(got.videoswin, f.name) == getattr(want.videoswin, f.name), f.name


def test_inference_cli_takes_motion_encoder():
    args = inference.parse_args(["--motion_encoder", "videoswins", "--bf16"])
    assert args.motion_encoder == "videoswins"
    assert get_config(args.motion_encoder).model.motion_encoder == "videoswins"
    assert inference.parse_args([]).motion_encoder == "mvitv2s"


def test_pretrained_videoswin_strips_backbone_prefix(rng, tmp_path):
    """An mmaction checkpoint ('backbone.'-prefixed keys) loads into visnet."""
    cfg = get_config("videoswins")
    model = torch.nn.Module()
    model.visnet = videoswin.VideoSwinFeatures(
        dataclasses.replace(cfg.model.videoswin, depths=(1, 1, 1, 1)))
    sd = {"backbone." + k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in model.visnet.state_dict().items()}
    sd["cls_head.fc_cls.weight"] = torch.zeros(400, 768)
    path = tmp_path / "swin_small_patch244_window877_kinetics400_1k.pth"
    torch.save({"state_dict": sd}, path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, motion_encoder_weight=str(path)))
    load_pretrained_encoders(cfg, model)
    for k, v in model.visnet.state_dict().items():
        torch.testing.assert_close(v, sd["backbone." + k], rtol=0, atol=0)
