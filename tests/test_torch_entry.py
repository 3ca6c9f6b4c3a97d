"""The port's entry points and host data stages against the JAX package on
the CPU:

- the inference CLI's output files: `main` of both CLIs on a tiny synthetic
  tree with stubbed models leaves the same file names (each frame's own
  basename, an empty directory for a video with too few frames) and, with
  the host post-processing, the same decoded pixels to the last bit;
- `--use_sound` parsed with `type=bool` in both CLIs (the quirk: `False`
  keeps the sound on, only '' turns it off), and the model it picks;
  `--device_post/--no-device_post`, `--native_loader`;
- the host post-processing (`blur_exp_resize`) bit-equal to the JAX CLI's,
  and `predict_video` with a `VisualSaliencyModel` and the host path;
- `python -m mspi_tpu_torch.evaluate` against `evaluate.py`: every metric
  to 1e-6, `frames` equal;
- `spectrogram_torch` against `spectrogram_jax` and `stft_power` (1e-4 of
  the spectrogram's scale);
- the port's native loader: built into build/, bit-equal to the JAX
  binding, within `tests/test_native_loader.py`'s bound of PIL, and raising
  where the JAX binding returns None.
"""

import json
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

import evaluate as jax_evaluate
import inference as jax_inference
import mspi_tpu.models.fusion as jax_fusion
from mspi_tpu.data import audio as jax_audio
from mspi_tpu.data import native as jax_native
from mspi_tpu_torch import evaluate, inference
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.data import audio, native
from mspi_tpu_torch.data.video import load_frame
from mspi_tpu_torch.models import fusion
from mspi_tpu_torch.train import __main__ as train_cli
from tests.synthetic_data import build_avsp_tree
from tests.torch_port_utils import SHALLOW_MVIT, cpu_share  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

CLIP = 4  # --clip_size: 2 * 4 - 1 = 7 frames are enough


def _stub_map(last_frame_red):
    """A log-density map both frameworks compute exactly: red / 256 - 11."""
    return last_frame_red * (1.0 / 256) - 11.0


class _JaxStub(linen.Module):
    cfg: object = None

    def __call__(self, clips, audio=None, train=False):
        return _stub_map(clips[:, -1, :, :, 0].astype(jnp.float32)), jnp.zeros(())


class _TorchStub(torch.nn.Module):
    built = []

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros((), device=device))
        _TorchStub.built.append(type(self).__name__)

    def forward(self, clips, audios=None):
        return _stub_map(clips[:, -1, :, :, 0].float()), torch.zeros(())


class _TorchAVStub(_TorchStub):
    pass


class _TorchVisualStub(_TorchStub):
    pass


@pytest.fixture(scope="module")
def avsp_tree(tmp_path_factory):
    """AVAD split 1 with v1 (9 frames) and v2 (3 frames: too few)."""
    root = str(tmp_path_factory.mktemp("avsp"))
    build_avsp_tree(root, datasets=(("AVAD", "v1"), ("AVAD", "v2")), n_frames=9)
    for i in range(4, 10):
        os.remove(os.path.join(root, "video_frames", "AVAD", "v2", f"img_{i:05d}.jpg"))
    return root


def _written(save_path):
    return {v: sorted(os.listdir(os.path.join(save_path, v))) for v in os.listdir(save_path)}


def _run_jax_cli(monkeypatch, root, save_path, extra):
    monkeypatch.setattr(jax_fusion, "AudioVisualSaliencyModel", _JaxStub)
    monkeypatch.setattr(jax_fusion, "VisualSaliencyModel", _JaxStub)
    monkeypatch.setattr(sys, "argv", ["inference.py", "--path_data", root, "--dataset", "AVAD",
                                      "--split", "1", "--save_path", save_path,
                                      "--clip_size", str(CLIP), "--window_batch", "4", *extra])
    jax_inference.main()


def _run_port_cli(monkeypatch, root, save_path, extra):
    monkeypatch.setattr(fusion, "AudioVisualSaliencyModel", _TorchAVStub)
    monkeypatch.setattr(fusion, "VisualSaliencyModel", _TorchVisualStub)

    def no_spectrogram(*args, **kwargs):
        raise AssertionError("a spectrogram computed for the visual-only model")

    monkeypatch.setattr(inference, "get_audio_spectrogram", no_spectrogram)
    _TorchStub.built.clear()
    inference.main(["--path_data", root, "--dataset", "AVAD", "--split", "1", "--save_path",
                    save_path, "--clip_size", str(CLIP), "--window_batch", "4",
                    "--device", "cpu", *extra])


def test_cli_output_files_match_jax(avsp_tree, tmp_path, monkeypatch):
    """Both CLIs' `main` on the same tree and the same maps (--use_sound ''
    and --no-device_post: the visual-only stubs, the cv2 host path): the
    same directories and file names, each frame's basename, and the same
    decoded pixels. The port's device post-processing leaves the same
    names."""
    flags = ["--use_sound", "", "--no-device_post"]
    _run_jax_cli(monkeypatch, avsp_tree, str(tmp_path / "jax"), flags)
    _run_port_cli(monkeypatch, avsp_tree, str(tmp_path / "port"), flags)
    assert _TorchStub.built == ["_TorchVisualStub"]
    want, got = _written(str(tmp_path / "jax")), _written(str(tmp_path / "port"))
    assert got == want == {"v1": [f"img_{i:05d}.jpg" for i in range(1, 10)], "v2": []}
    for name in want["v1"]:
        a = cv2.imread(str(tmp_path / "jax" / "v1" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "port" / "v1" / name), cv2.IMREAD_UNCHANGED)
        assert a.shape == (480, 640) and a.dtype == np.uint8
        np.testing.assert_array_equal(b, a, err_msg=name)
    _run_port_cli(monkeypatch, avsp_tree, str(tmp_path / "port_dev"), ["--use_sound", ""])
    assert _written(str(tmp_path / "port_dev")) == want


@pytest.mark.parametrize("value,want", [(None, True), ("True", True), ("False", True),
                                        ("0", True), ("", False)])
def test_use_sound_parses_as_the_jax_cli(monkeypatch, value, want):
    """`type=bool`: any non-empty string is True, `False` too; only ''
    serves the visual-only model. The other new flags parse alike in both
    CLIs where both have them."""
    argv = [] if value is None else ["--use_sound", value]
    monkeypatch.setattr(sys, "argv", ["inference.py", *argv, "--no-device_post"])
    jax_args = jax_inference.parse_args()
    args = inference.parse_args([*argv, "--no-device_post"])
    assert args.use_sound is jax_args.use_sound is want
    assert args.device_post is jax_args.device_post is False
    assert inference.parse_args(argv).device_post is True
    assert inference.parse_args(argv).native_loader is False
    assert inference.parse_args(["--native_loader"]).native_loader is True


def test_train_cli_native_loader_and_remat():
    assert train_cli.parse_args([]).native_loader is False
    args = train_cli.parse_args(["--native_loader", "--remat"])
    assert args.native_loader is True
    assert train_cli.config_from_args(args).model.remat is True
    assert train_cli.config_from_args(train_cli.parse_args([])).model.remat is False


def test_blur_exp_resize_bit_equal_to_jax(rng):
    for shape in ((224, 384), (56, 96)):
        m = (-11.0 + 0.03 * rng.random(shape)).astype(np.float32)
        np.testing.assert_array_equal(inference.blur_exp_resize(m),
                                      jax_inference.blur_exp_resize(m))
    m = np.log(rng.random((56, 96)).astype(np.float32) + 1e-3)
    np.testing.assert_array_equal(inference.blur_exp_resize(m, (96, 72)),
                                  jax_inference.blur_exp_resize(m, (96, 72)))


def test_predict_video_visual_model_host_post(rng, monkeypatch):
    """The visual-only model (four-block MViT at 32x32) through
    predict_video on clips alone (no spectrogram is computed), host and
    device post-processing within one uint8 step of each other, the host
    path equal to blur_exp_resize on the model's maps."""
    res = (32, 32)
    cfg = get_config("mvitv2s", {"data": {"resolution": res}, "model": {"mvit": SHALLOW_MVIT}})
    model = fusion.VisualSaliencyModel(cfg, device="cpu",
                                       generator=torch.Generator().manual_seed(0))

    def no_spectrogram(*args, **kwargs):
        raise AssertionError("a spectrogram computed for the visual-only model")

    monkeypatch.setattr(inference, "get_audio_spectrogram", no_spectrogram)
    frames = rng.integers(0, 256, (31, *res, 3), dtype=np.uint8)
    host = inference.predict_video(model, frames, None, 30.0, window_batch=16,
                                   img_size=(32, 24), device_post=False)
    dev = inference.predict_video(model, frames, None, 30.0, window_batch=16,
                                  img_size=(32, 24))
    assert host.shape == dev.shape == (31, 24, 32) and host.dtype == np.uint8
    assert np.abs(host.astype(int) - dev.astype(int)).max() <= 1
    with torch.no_grad():
        pred, _ = model(torch.from_numpy(np.ascontiguousarray(frames[15:31][None])))
    np.testing.assert_array_equal(host[30], inference.blur_exp_resize(pred[0].numpy(), (32, 24)))


@pytest.fixture(scope="module")
def eval_tree(avsp_tree, tmp_path_factory):
    """Predicted PNGs for v1 (one with no eye map, one over an empty eye
    map) beside the tree's eye maps and fixations; no predictions for v2;
    a centre-prior baseline map."""
    rng = np.random.default_rng(7)
    pred_root = tmp_path_factory.mktemp("pred")
    os.makedirs(pred_root / "v1")
    y, x = np.mgrid[0:60, 0:80]
    for i in (*range(1, 10), 99):
        cy, cx = rng.uniform(10, 50), rng.uniform(10, 70)
        m = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 300.0) + 0.1 * rng.random((60, 80))
        cv2.imwrite(str(pred_root / "v1" / f"img_{i:05d}.png"),
                    np.round(255 * m / m.max()).astype(np.uint8))
    empty = os.path.join(avsp_tree, "annotations", "AVAD", "v1", "maps", "eyeMap_00005.jpg")
    cv2.imwrite(empty, np.zeros((48, 64), np.uint8))
    base = str(pred_root / "center.png")
    cv2.imwrite(base, np.round(255 * np.exp(-((y - 30) ** 2 + (x - 40) ** 2) / 800.0))
                .astype(np.uint8))
    return str(pred_root), base


def test_evaluate_matches_jax(avsp_tree, eval_tree, monkeypatch, capsys):
    pred_root, base = eval_tree
    argv = ["--pred_path", pred_root, "--path_data", avsp_tree, "--dataset", "AVAD",
            "--split", "1", "--metrics", "kld", "cc", "sim", "nss", "aucj", "sauc", "ig",
            "--baseline_map", base]
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
    jax_evaluate.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    evaluate.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    got = json.loads(out[-1])
    assert "[eval] missing predictions for v2, skipping" in out
    assert got["frames"] == want["frames"] == 8
    assert set(got) == set(want) == {"kld", "cc", "sim", "nss", "aucj", "sauc", "ig", "frames"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (k, got[k], want[k])


def test_evaluate_default_metrics_parse(avsp_tree, eval_tree, monkeypatch):
    """The JAX CLI's defaults, and the port's own `--device`, which
    defaults to the card and refuses when there is none."""
    args = evaluate.parse_args(["--pred_path", "p", "--path_data", "d"])
    assert args.metrics == ["kld", "cc", "sim", "nss", "aucj"] and args.split == 1
    assert args.device == "cuda"
    with pytest.raises(SystemExit):
        evaluate.parse_args(["--pred_path", "p", "--path_data", "d", "--metrics", "auc"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        evaluate.main(["--pred_path", eval_tree[0], "--path_data", avsp_tree])


@pytest.mark.parametrize("n", [1600, 16000 * 32 // 30 + 11])
def test_spectrogram_torch_matches_jax(rng, n):
    wave = rng.standard_normal(n).astype(np.float32)
    got = audio.spectrogram_torch(torch.from_numpy(wave)).numpy()
    want_jax = np.asarray(jax_audio.spectrogram_jax(jnp.asarray(wave)))
    want_np = audio.stft_power(wave)
    assert got.shape == want_jax.shape == want_np.shape == (257, 1 + n // 160)
    for want in (want_jax, want_np):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def jpeg_file(tmp_path_factory):
    """tests/test_native_loader.py's smooth 320x480 frame."""
    from PIL import Image

    base = np.random.default_rng(0).random((8, 12, 3))
    img = (np.kron(base, np.ones((40, 40, 1))) * 255).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("jpg") / "frame.jpg")
    Image.fromarray(img).save(path, quality=95)
    return path


def test_native_loader_matches_jax_binding(jpeg_file):
    """Built from native/mspi_loader.cc into build/, bit-equal to the JAX
    binding's frame and clip, within test_native_loader.py's mean bound of
    PIL, and load_frame(native=True) takes it."""
    assert native.LIB_PATH.parent.name == "mspi_tpu_torch"
    assert native.LIB_PATH.parent.parent.name == "build"
    for size in ((224, 384), (112, 192), (320, 480)):
        got = native.load_frame_native(jpeg_file, size)
        np.testing.assert_array_equal(got, jax_native.load_frame_native(jpeg_file, size))
        np.testing.assert_array_equal(load_frame(jpeg_file, size, native=True), got)
        pil = load_frame(jpeg_file, size)
        assert np.abs(got.astype(np.int32) - pil.astype(np.int32)).mean() < 2.0
    clip = native.load_clip_native([jpeg_file] * 5, (112, 192), n_threads=3)
    np.testing.assert_array_equal(
        clip, jax_native.load_clip_native([jpeg_file] * 5, (112, 192), n_threads=3))
    assert clip.shape == (5, 112, 192, 3)


def test_native_loader_raises_naming_the_file(jpeg_file, tmp_path, monkeypatch):
    """No quiet fall-back: an undecodable file raises naming it, in a clip
    too, a failed build raises with the compiler's output, and a library
    that does not load raises naming it."""
    bad = str(tmp_path / "not_a.jpg")
    with open(bad, "wb") as f:
        f.write(b"no jpeg here")
    with pytest.raises(OSError, match="not_a.jpg"):
        native.load_frame_native(bad, (32, 32))
    with pytest.raises(OSError, match="not_a.jpg"):
        native.load_clip_native([jpeg_file, bad, jpeg_file], (32, 32))
    with pytest.raises(OSError, match="missing.jpg"):
        load_frame(str(tmp_path / "missing.jpg"), (32, 32), native=True)
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib" / "libmspi_loader.so")
    with pytest.raises(RuntimeError, match="broken.cc"):
        native.build()
    assert not (tmp_path / "lib" / "libmspi_loader.so").exists()
    (tmp_path / "lib" / "libmspi_loader.so").write_bytes(b"not a library")
    monkeypatch.setattr(native, "SOURCE", native.REPO_DIR / "native" / "mspi_loader.cc")
    native.lib.cache_clear()
    try:
        os.utime(tmp_path / "lib" / "libmspi_loader.so")
        with pytest.raises(OSError, match="libmspi_loader.so"):
            native.lib()
    finally:
        native.lib.cache_clear()
