"""The port's `utils/visualization.py`, `utils/logging.py`, `utils/demo.py`
and the two tools `python -m mspi_tpu_torch.tools.demo_net` and
`tools.visualize` against the JAX package on the CPU (the grad_cam,
ScalarWriter and VideoVisualizer cases of `tests/test_aux_components.py`).

- `grad_cam` on a toy and on the mvitv2s classifier (`SHALLOW_MVIT`, 10
  classes, [1, 16, 32, 32, 3]) against the JAX function: CAMs 1e-4, scores
  1e-5; `activation_stats` names each shared module's outputs as flax's
  `capture_intermediates` does, with the same statistics (1e-4);
- ScalarWriter's files and VideoVisualizer's frames equal to JAX's;
- MetricLogger's statistics and lines equal to JAX's on the same updates;
- AsyncDemo writes every result in order, in batches of `batch_size`;
  FrameDirSource reads JAX's frames;
- both tools' `main` with `--device cpu` on tiny frame trees.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.config import MViTConfig as JaxMViTConfig
from mspi_tpu.models import video_zoo as jax_zoo
from mspi_tpu.utils import demo as jax_demo
from mspi_tpu.utils import logging as jax_logging
from mspi_tpu.utils import visualization as jax_vis
from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.models import video_zoo
from mspi_tpu_torch.utils import demo, logging, visualization
from tests.torch_port_utils import (SHALLOW_MVIT, assert_imports_no_jax,  # noqa: F401
                                    cpu_share, load_port, port_variables, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


def _write_frames(d, n, rng, size=(48, 64)):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.random((*size, 3)) * 255).astype(np.uint8)).save(
            os.path.join(d, f"img_{i:05d}.jpg"))


def test_grad_cam_on_toy_model(rng):
    """Identity features, a linear head: the JAX function's CAMs and
    scores; CAMs in [0, 1]."""
    w = rng.standard_normal((6, 5)).astype(np.float32)
    clips = rng.random((2, 2, 4, 4, 6)).astype(np.float32)
    want_cam, want_scores = jax_vis.grad_cam(lambda c: [c], lambda f: f[0].mean(axis=(1, 2, 3))
                                             @ jnp.asarray(w), jnp.asarray(clips))
    cam, scores = visualization.grad_cam(lambda c: [c], lambda f: f[0].mean(dim=(1, 2, 3))
                                         @ torch.from_numpy(w), torch.from_numpy(clips))
    assert cam.shape == (2, 2, 4, 4) and scores.shape == (2, 5)
    assert float(cam.min()) >= 0.0 and float(cam.max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(to_np(cam), np.asarray(want_cam), atol=1e-5)
    np.testing.assert_allclose(to_np(scores), np.asarray(want_scores), atol=1e-6)


@pytest.fixture(scope="module")
def mvit_classifier():
    """The port's four-block mvitv2s classifier with seeded weights, the
    JAX classifier and its variables, and a clip."""
    rng = np.random.default_rng(5)
    port = video_zoo.MViTClassifier(MViTConfig(**SHALLOW_MVIT), 10)
    variables = port_variables(port, rng)
    return (load_port(port, variables), jax_zoo.MViTClassifier(JaxMViTConfig(**SHALLOW_MVIT), 10),
            variables, rng.standard_normal((1, 16, 32, 32, 3)).astype(np.float32))


def test_grad_cam_on_mvit_classifier_matches_jax(mvit_classifier, monkeypatch):
    """The tools' call on mvitv2s (the head gets the last level itself):
    the CAM of the last level ([1, 8, 1, 1]) and of tap 2 ([1, 8, 2, 2])
    against JAX's (the backbone and head jitted on its side)."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    port, jax_model, variables, clips = mvit_classifier
    backbone = jax.jit(lambda c: jax_model.apply(variables, c, method=lambda m, x: m.backbone(x)))
    head = jax.jit(lambda f: jax_model.apply(variables, f, method=lambda m, x: m.head(x[-1])))
    for tap in (-1, 2):
        want_cam, want_scores = jax_vis.grad_cam(backbone, head, jnp.asarray(clips), tap=tap)
        cam, scores = visualization.grad_cam(port.backbone, lambda f: port.head(f[-1]),
                                             torch.from_numpy(clips), tap=tap)
        assert cam.shape == want_cam.shape
        np.testing.assert_allclose(to_np(cam), np.asarray(want_cam), atol=1e-4)
        np.testing.assert_allclose(to_np(scores), np.asarray(want_scores), atol=1e-5)


def test_activation_and_weight_stats_match_jax(mvit_classifier, monkeypatch):
    """The modules whose outputs the two packages share (the classifier,
    its backbone's pyramid, each block with its (T, H, W), each block's
    attention output, q / k norms, projection and first norm, the head)
    carry the same names, shapes, means and stds; the weight statistics are
    keyed by the torch names."""
    monkeypatch.delenv("MSPI_PALLAS_INTERPRET", raising=False)
    port, jax_model, variables, clips = mvit_classifier

    class Jitted:  # the JAX function's apply, compiled (it runs it eagerly)
        apply = staticmethod(jax.jit(jax_model.apply, static_argnames=("capture_intermediates",)))

    want = jax_vis.activation_stats(Jitted(), variables, jnp.asarray(clips))
    got = visualization.activation_stats(port, torch.from_numpy(clips))
    shared = set(want) & set(got)
    assert {"__call__/[0]", "head/__call__/[0]", "backbone/__call__/[0]/[3]",
            "backbone/blocks/layers_3/__call__/[0]/[0]",
            "backbone/blocks/layers_3/__call__/[0]/[1]/[2]"} <= shared
    for part in ("attn/norm_q", "attn/norm_k", "attn/proj", "norm1"):
        assert all(f"backbone/blocks/layers_{i}/{part}/__call__/[0]" in shared
                   for i in range(4)), part
    for name in shared:
        assert got[name]["shape"] == want[name]["shape"], name
        for k in ("mean", "std"):
            assert abs(got[name][k] - want[name][k]) <= 1e-4 * max(1.0, abs(want[name][k])), name
    only_attn = visualization.activation_stats(port, torch.from_numpy(clips),
                                               filter_fn=lambda n: "/attn/" in n)
    assert only_attn and all("/attn/" in n for n in only_attn)
    stats = visualization.weight_stats(port)
    assert stats.keys() == dict(port.named_parameters()).keys()
    w = port.head.projection.weight.detach().numpy()
    assert stats["head.projection.weight"] == {"shape": [10, 768], "mean": float(w.mean()),
                                               "std": float(w.std()), "min": float(w.min()),
                                               "max": float(w.max())}


def test_scalar_writer_matches_jax(tmp_path):
    hist = np.random.default_rng(0).standard_normal(100)
    for d, module in (("port", visualization), ("jax", jax_vis)):
        w = module.ScalarWriter(str(tmp_path / d))
        w.add_scalars({"loss": 1.0, "acc": 0.5}, 3)
        w.add_histogram("weights", hist, 3)
        cm = w.plot_confusion_matrix(np.array([0, 1]), np.array([0, 0]), 2, 3)
        assert cm[0, 0] == 1 and cm[0, 1] == 1
    for name in ("histograms.jsonl", "confusion_3.npy", "confusion_3.png"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got, want = (json.loads((tmp_path / d / "scalars.jsonl").read_text()) for d in ("port", "jax"))
    assert got.keys() == want.keys() and {k: got[k] for k in got if k != "time"} == \
        {k: want[k] for k in want if k != "time"}


def test_video_visualizer_boxes_match_jax(rng):
    frames = (rng.random((3, 48, 64, 3)) * 60).astype(np.uint8)
    boxes = np.array([[4, 4, 30, 40], [32, 8, 60, 44]], np.float32)
    preds = np.array([[0.1, 0.9, 0, 0, 0], [0, 0, 0.2, 0.8, 0]], np.float32)
    vis = visualization.VideoVisualizer(num_classes=5, class_names=list("abcde"), top_k=2)
    ref = jax_vis.VideoVisualizer(num_classes=5, class_names=list("abcde"), top_k=2)
    out = vis.draw_clip(frames, preds, bboxes=boxes)
    np.testing.assert_array_equal(out, ref.draw_clip(frames, preds, bboxes=boxes))
    assert out.shape == frames.shape and out.dtype == np.uint8
    assert out[0, 4, 4:30].max() > 120
    out2 = vis.draw_clip(frames, preds[0], keyframe_idx=1)
    np.testing.assert_array_equal(out2, ref.draw_clip(frames, preds[0], keyframe_idx=1))
    assert (out2[1] != frames[1]).any() and (out2[0] == frames[0]).all()
    thres = visualization.VideoVisualizer(5, mode="thres", thres=0.5)
    assert thres._pick(preds[0]) == jax_vis.VideoVisualizer(5, mode="thres", thres=0.5)._pick(
        preds[0]) == [(1, pytest.approx(0.9))]


def test_metric_logger_matches_jax(tmp_path):
    """The same updates through `log_every` over 5 items: the same global
    averages, medians, iteration headers and JSON-lines record."""
    out = {}
    for name, module in (("port", logging), ("jax", jax_logging)):
        logger, buf = module.MetricLogger(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            for i in logger.log_every(range(5), 2, "Epoch: [0]"):
                logger.update(loss=1.0 / (i + 1), lr=0.1, skipped=None)
        module.append_jsonl(str(tmp_path / name / "log.txt"), {"train_loss": logger.loss.global_avg})
        lines = [ln.split(" eta:")[0] for ln in buf.getvalue().splitlines()]
        out[name] = (logger.stats(), logger.loss.median, str(logger.meters["lr"]), lines[:-1])
    assert out["port"] == out["jax"]
    assert out["port"][3] == ["Epoch: [0] [0/5]", "Epoch: [0] [2/5]", "Epoch: [0] [4/5]"]
    assert (tmp_path / "port" / "log.txt").read_text() == (tmp_path / "jax" / "log.txt").read_text()


def test_async_demo_writes_in_order(tmp_path, rng):
    """10 clips in batches of 4, 4, 2 through the predictor thread layout;
    every result written once, in order. FrameDirSource reads the JAX
    source's frames and windows."""
    batches, written = [], []

    def predict(clips):
        batches.append(len(clips))
        return clips.reshape(len(clips), -1).sum(-1)

    items = [(i, np.full((2, 3), i, np.float32)) for i in range(10)]
    demo.AsyncDemo(predict, lambda i, p: written.append((i, float(p))), batch_size=4,
                   queue_size=3).run(iter(items))
    assert batches == [4, 4, 2] and written == [(i, 6.0 * i) for i in range(10)]
    _write_frames(str(tmp_path), 6, rng)
    port, ref = demo.FrameDirSource(str(tmp_path), 4, (24, 40)), \
        jax_demo.FrameDirSource(str(tmp_path), 4, (24, 40))
    got, want = list(port), list(ref)
    assert [i for i, _ in got] == [i for i, _ in want] == [3, 4, 5]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_demo_net_main_on_cpu(tmp_path, rng, monkeypatch):
    """`demo_net.main` on 17 frames (two 16-frame clips) with the s3d model
    at 32x64 (its config's resolution swapped in): one PNG per clip, named
    by its last frame, each the heatmap of the map the pipeline predicted,
    and that map the model's direct forward of the same clip."""
    import cv2

    from mspi_tpu_torch import config
    from mspi_tpu_torch.tools import demo_net

    real, build = config.get_config, demo_net.build_predictor
    monkeypatch.setattr(config, "get_config",
                        lambda name: real(name, {"data": {"resolution": (32, 64)}}))
    kept = {}

    def keeping(*args, **kwargs):
        kept["model"], predict = build(*args, **kwargs)

        def predict_and_keep(clips):
            kept["maps"] = predict(clips)
            return kept["maps"]
        return kept["model"], predict_and_keep

    monkeypatch.setattr(demo_net, "build_predictor", keeping)
    frames_dir, out_dir = tmp_path / "frames", tmp_path / "out"
    _write_frames(str(frames_dir), 17, rng)
    demo_net.main(["--frames", str(frames_dir), "--out", str(out_dir), "--device", "cpu"])
    assert sorted(os.listdir(out_dir)) == ["sal_00015.png", "sal_00016.png"]
    clips = np.stack([c for _, c in demo.FrameDirSource(str(frames_dir), 16, (32, 64))])
    with torch.no_grad():
        direct, _ = kept["model"](torch.from_numpy(clips),
                                  torch.full((2, *demo_net.SPECTRO, 1), 0.02))
    np.testing.assert_array_equal(kept["maps"], direct.numpy())
    for idx, pred in zip((15, 16), kept["maps"]):
        sal = np.exp(pred)
        sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-12)
        want = cv2.applyColorMap((sal * 255).astype(np.uint8), cv2.COLORMAP_JET)
        np.testing.assert_array_equal(cv2.imread(str(out_dir / f"sal_{idx:05d}.png")), want)


def test_visualize_main_on_cpu(tmp_path, rng):
    """`visualize.main --model mvitv2s` on 16 frames at 64x64: one CAM
    frame per level-4 time step (8), finite, in [0, 1]."""
    from mspi_tpu_torch.tools import visualize

    _write_frames(str(tmp_path / "frames"), 16, rng)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cams, scores = visualize.main(["--model", "mvitv2s", "--frames", str(tmp_path / "frames"),
                                       "--out", str(tmp_path / "cams"), "--crop_size", "64",
                                       "--device", "cpu"])
    assert cams.shape == (8, 2, 2) and scores.shape == (400,)
    assert np.isfinite(cams).all() and cams.min() >= 0.0 and cams.max() <= 1.0
    assert sorted(os.listdir(tmp_path / "cams")) == [f"cam_{t:03d}.png" for t in range(8)]
    assert f"predicted class {int(np.argmax(scores))}; wrote 8 CAM frames" in buf.getvalue()


def test_new_modules_import_no_jax_and_tools_default_to_the_card():
    """This slice's modules import neither JAX, flax nor the JAX package;
    both tools run on the card unless told otherwise."""
    from mspi_tpu_torch.tools import demo_net, visualize

    assert_imports_no_jax(("models.roi_head", "train.detection", "utils.ava_eval", "data.ava",
                           "ops.subbn", "data.rand_augment", "data.extra_datasets",
                           "convert", "convert.inflate", "utils.logging",
                           "utils.visualization", "utils.demo", "tools.demo_net",
                           "tools.visualize"))
    assert demo_net.parse_args(["--frames", "f", "--out", "o"]).device == "cuda"
    assert visualize.parse_args(["--frames", "f", "--out", "o"]).device == "cuda"
