"""The ported slice as a whole against the JAX package on the CPU:

- the full MViTv2-S AudioVisualSaliencyModel (production depth 16) at
  32x64, batch 1, uint8 clips; JAX runs its default CPU path (Pallas off);
- the inference post-processing, window schedule and host spectrogram;
- the port's imports (inference, training and data modules) stay free of
  jax, flax and mspi_tpu.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inference as jax_inference
from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.data import audio as jax_audio
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu.models.fusion import VisualSaliencyModel as JaxVisualModel
from mspi_tpu_torch import inference
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.data import audio
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel, VisualSaliencyModel
from tests.torch_port_utils import (SHALLOW_MVIT, assert_imports_no_jax,  # noqa: F401
                                    assert_tree_declared, cpu_share,
                                    declared_leaves, jit_fast, load_port, port_variables,
                                    skipped_init)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (32, 64)  # every level still halves exactly down to /32


def test_flagship_forward_matches_jax(rng, monkeypatch):
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    cfg = {"data": {"resolution": RES}}
    jax_model = JaxModel(cfg=jax_get_config("mvitv2s", overrides=cfg))
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    auds = rng.standard_normal((1, 257, 111, 1)).astype(np.float32)
    with skipped_init():
        port = AudioVisualSaliencyModel(get_config("mvitv2s", cfg), device="cpu")
    variables = port_variables(port, rng)
    with declared_leaves() as declared:
        want, want_loss = jit_fast(jax_model.apply, variables, jnp.asarray(clips),
                                   jnp.asarray(auds))
    assert_tree_declared(declared, variables)
    load_port(port, variables)
    with torch.no_grad():
        got, got_loss = port(torch.from_numpy(clips), torch.from_numpy(auds))

    assert got.shape == (1, *RES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    assert abs(float(got_loss) - float(want_loss)) < 1e-4
    np.testing.assert_allclose(float(got.exp().sum()), 1.0, atol=1e-4)


def test_visual_model_matches_jax(rng, monkeypatch):
    """The video-only twin shares every part but the audio branch."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    cfg = {"data": {"resolution": RES}}
    jax_model = JaxVisualModel(cfg=jax_get_config("mvitv2s", overrides=cfg))
    clips = rng.integers(0, 256, (1, 16, *RES, 3), dtype=np.uint8)
    with skipped_init():
        port = VisualSaliencyModel(get_config("mvitv2s", cfg), device="cpu")
    variables = port_variables(port, rng)
    with declared_leaves() as declared:
        want, _ = jit_fast(jax_model.apply, variables, jnp.asarray(clips))
    assert_tree_declared(declared, variables)
    load_port(port, variables)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(clips))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)


def test_device_post_matches_jax(rng):
    """Log-density maps sit near -11 with a range of ~0.03 (the precision
    trap of the blur); allow at most one uint8 step."""
    y, x = np.mgrid[0:56, 0:96].astype(np.float32)
    maps = []
    for _ in range(3):
        cy, cx = rng.uniform(0, 56), rng.uniform(0, 96)
        bump = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 400.0)
        maps.append(-11.0 + 0.03 * bump + 1e-3 * rng.standard_normal(bump.shape))
    maps = np.stack(maps).astype(np.float32)
    want = np.asarray(jax_inference.make_device_post()(jnp.asarray(maps)))
    got = inference.make_device_post()(torch.from_numpy(maps)).numpy()
    assert got.shape == want.shape == (3, 480, 640) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("n_frames,len_temporal", [(31, 16), (40, 16), (9, 4)])
def test_sliding_window_jobs_match(n_frames, len_temporal):
    assert (inference.sliding_window_jobs(n_frames, len_temporal)
            == jax_inference.sliding_window_jobs(n_frames, len_temporal))


@pytest.mark.parametrize("flip", [False, True])
def test_host_spectrogram_matches(rng, flip):
    wave = rng.standard_normal(3 * 16000).astype(np.float32)
    for start in (0, 7, 40):
        want = jax_audio.get_audio_spectrogram(None, start, 30.0, len_snippet=32, flip=flip,
                                               audio_cache=wave)
        got = audio.get_audio_spectrogram(None, start, 30.0, len_snippet=32, flip=flip,
                                          audio_cache=wave)
        assert got.shape == (257, 111)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio.get_audio_spectrogram(None, 0, 30.0),
                                  jax_audio.get_audio_spectrogram(None, 0, 30.0))


def test_predict_video_shapes_and_order(rng):
    """predict_video on the CPU at a tiny size: every frame gets a map, the
    flipped windows fill the first len-1 frames. 31 frames are the fewest
    predict_video takes (2 * 16 - 1, as the reference inference): fewer
    leave frames without a window. The model is the four-block MViT at
    32x32 (every level still halves exactly, down to 1x1 at /32), since the
    window schedule, not the backbone, is what this checks."""
    res = (32, 32)
    cfg = get_config("mvitv2s", {"data": {"resolution": res}, "model": {"mvit": SHALLOW_MVIT}})
    model = AudioVisualSaliencyModel(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    frames = rng.integers(0, 256, (9, *res, 3), dtype=np.uint8)
    out = inference.predict_video(model, np.concatenate([frames] * 4)[:31], None, 30.0,
                                  window_batch=8, img_size=(32, 24))
    assert out.shape == (31, 24, 32) and out.dtype == np.uint8
    assert (out.reshape(31, -1).max(axis=1) == 255).all()
    assert (out.reshape(31, -1).min(axis=1) == 0).all()


def test_port_imports_no_jax():
    """The slice's modules (the package, inference, training and data)
    import neither JAX, flax nor the JAX package (`assert_imports_no_jax`,
    which imports every module of the port)."""
    assert_imports_no_jax((
        "", "inference", "convert", "models.fusion", "models.videoswin", "models.uniformer",
        "models.s3d", "ops.kernels.window_attention", "data.video", "data.datasets",
        "data.loader", "train.engine", "train.loss", "train.metrics", "train.checkpoints",
        "train.synthetic", "train.__main__", "evaluate", "data.native", "models.x3d",
        "models.resnet3d"))
