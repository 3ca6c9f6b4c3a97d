"""AVA detection in the port (`mspi_tpu_torch.models.roi_head`,
`train.detection`, `utils.ava_eval`, `data.ava`) against the JAX package on
the CPU.

- `roi_align` and `ResNetRoIHead`: forward and gradients against the JAX
  functions (boxes inside, across and outside the map, and a degenerate
  one), 1e-5; the pre-port cases of `tests/test_detection.py`.
- `VideoDetector` on the four-block MViT trunk (`SHALLOW_MVIT`, the head on
  tap 2, 384 channels, `pool_size` 2, no head dropout, drop-path on fixed
  masks) at [2, 16, 32, 32, 3] with 4 padded boxes a clip: the eval step's
  box probabilities and `run_ava_eval`'s mAP against JAX's on the same
  batch; one AdamW train step against `make_det_train_step(jit=True)` at
  weight decay 0 and 1e-2 (the JAX program compiled once, the decay an
  injected hyperparameter): the loss within 1e-5, each first moment (0.1 g)
  within 2e-3 of its largest magnitude (`_assert_leaves_close`), and the
  trunk's last block, which feeds nothing, decayed as optax decays it
  (two fp32 roundings, 2.4e-7 relative; the decay moves it by 1e-5).
- `AvaDataset`: every train and val sample bit for bit equal to the JAX
  dataset's on a synthetic AVA tree (the same seeded draws); the pre-port
  cases of `tests/test_ava_pipeline.py`, its end-to-end run on a toy trunk
  included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mspi_tpu.models.mvit as jax_mvit
from mspi_tpu.config import MViTConfig as JaxMViTConfig
from mspi_tpu.data import ava as jax_ava
from mspi_tpu.models import roi_head as jax_roi
from mspi_tpu.models.mvit import MViTFeatures as JaxMViTFeatures
from mspi_tpu.train import detection as jax_det
from mspi_tpu_torch.config import MViTConfig
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.data import ava
from mspi_tpu_torch.models.mvit import MViTFeatures
from mspi_tpu_torch.models.roi_head import ResNetRoIHead, roi_align
from mspi_tpu_torch.ops import layers
from mspi_tpu_torch.train import detection
from mspi_tpu_torch.utils.ava_eval import AVAMeter, average_precision, box_iou
from tests.test_torch_train import _assert_leaves_close
from tests.torch_port_utils import (SHALLOW_MVIT, FixedDropPathJax, assert_tree_declared,
                                    cpu_share, declared_leaves, fixed_drop_path_port,
                                    jax_module_variables, load_port, port_variables,
                                    skipped_init, to_np)

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

TOL = dict(atol=1e-5, rtol=1e-5)
CLIP = (16, 32, 32)
MAX_BOXES, NUM_CLASSES, POOL = 4, 10, 2
LR = 1e-3
WEIGHT_DECAYS = (0.0, 1e-2)


# ------------------------------------------------------------- ROI align

def test_roi_align_vs_torchvision_free_reference():
    """A dense bilinear crop of an axis-aligned box on a smooth map: the
    constant channel stays constant, the first bin's y is its centre's."""
    H, W = 16, 16
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    fmap = np.stack([yy, xx, yy + xx, yy * 0 + 1], -1).astype(np.float32)
    box = torch.tensor([[2.0, 3.0, 10.0, 11.0]])
    out = roi_align(torch.from_numpy(fmap), box, 4, spatial_scale=1.0).numpy()
    assert out.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(out[0, ..., 3], 1.0, atol=1e-5)
    np.testing.assert_allclose(out[0, 0, 0, 0], 3.0 + (11.0 - 3.0) / 4 / 2, atol=0.2)


def _boxes():
    """Inside, across the border, wholly outside, degenerate (x1 < x0)."""
    return np.array([[1.0, 2.0, 20.0, 30.0], [-8.0, 10.0, 40.0, 70.0],
                     [70.0, 70.0, 90.0, 95.0], [30.0, 12.0, 30.0, 11.0]], np.float32)


@pytest.mark.parametrize("out,ratio", [(3, 2), (2, 1), (4, 3)])
def test_roi_align_forward_and_grads_match_jax(rng, out, ratio):
    """On [B=2, 5, 6, C=3] maps with `_boxes` (scale 1/8, out x out bins,
    ratio x ratio samples each), the batched form against the JAX function
    on each box's map: values and the gradient of sum(w * out) in the
    features and the boxes, 1e-5."""
    fmap = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    boxes, idx = _boxes(), np.array([0, 1, 1, 0])
    w = rng.standard_normal((4, out, out, 3)).astype(np.float32)

    def jax_loss(f, b):
        out_ = jax.vmap(lambda m, bb: jax_roi.roi_align(m, bb[None], out, 1 / 8, ratio)[0])(
            f[idx], b)
        return jnp.sum(out_ * w), out_

    (_, want), (gf, gb) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(fmap), jnp.asarray(boxes))
    f, b = torch.from_numpy(fmap).requires_grad_(), torch.from_numpy(boxes).requires_grad_()
    got = roi_align(f, b, out, 1 / 8, ratio, batch_idx=torch.from_numpy(idx))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_roi_head_matches_jax(rng, train):
    """ResNetRoIHead (dim 8, 5 classes, pool 3, scale 1/2, no dropout) on
    [2, 4, 8, 8, 8] features: the sigmoid scores in [0, 1] and, in
    training, the gradients of sum(w * scores) in the projection and the
    features, 1e-5."""
    jax_head = jax_roi.ResNetRoIHead(dim_in=8, num_classes=5, pool_size=3, spatial_scale=0.5,
                                     dropout_rate=0.0)
    feats = rng.standard_normal((2, 4, 8, 8, 8)).astype(np.float32)
    boxes = np.array([[0, 0, 8, 8], [4, 4, 14, 14], [2, 2, 12, 12]], np.float32)
    idx = np.array([0, 0, 1])
    w = rng.standard_normal((3, 5)).astype(np.float32)
    args = (jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(idx))
    variables = jax_module_variables(jax_head, rng, *args)

    def jax_loss(params, f):
        out = jax_head.apply({"params": params}, f, *args[1:], train=train)
        return jnp.sum(out * w), out

    (_, want), (gp, gf) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        variables["params"], args[0])
    head = load_port(ResNetRoIHead(8, 5, 3, 0.5, 0.0), variables).train(train)
    f = torch.from_numpy(feats).requires_grad_()
    got = head(f, torch.from_numpy(boxes), torch.from_numpy(idx))
    assert got.shape == (3, 5) and bool(((got >= 0) & (got <= 1)).all())
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    if train:
        (got * torch.from_numpy(w)).sum().backward()
        want_g = state_dict_from_jax({"params": gp})
        for name, p in head.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), **TOL)
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf), **TOL)


def test_box_iou():
    a = np.array([[0, 0, 2, 2]], np.float32)
    b = np.array([[1, 1, 3, 3], [0, 0, 2, 2], [5, 5, 6, 6]], np.float32)
    np.testing.assert_allclose(box_iou(a, b)[0], [1 / 7, 1.0, 0.0], atol=1e-6)


def test_average_precision_perfect_and_random():
    scores = np.array([0.9, 0.8, 0.7])
    assert abs(average_precision(scores, np.array([1, 1, 1]), num_gt=3) - 1.0) < 1e-6
    assert average_precision(scores, np.array([0, 0, 0]), num_gt=3) == 0.0


def test_ava_meter_map():
    m = AVAMeter(num_classes=3)
    m.update_groundtruth("img0", np.array([[0, 0, 10, 10], [20, 20, 30, 30]]),
                         np.array([0, 1]))
    scores = np.zeros((2, 3), np.float32)
    scores[0, 0] = 0.9
    scores[1, 1] = 0.8
    m.update_predictions("img0", np.array([[0, 0, 10, 10], [50, 50, 60, 60]]), scores)
    stats = m.finalize_metrics()
    assert stats["num_classes_evaluated"] == 2
    assert 0.4 < stats["mAP"] <= 1.0


def test_masked_bce_in_fp32_from_bf16():
    """The loss runs in fp32: a saturated bf16 probability (1 - 1e-7 rounds
    to 1 in bf16) gives a finite loss, where JAX's bf16 BCE gives inf;
    padded boxes count nothing."""
    probs = torch.tensor([[1.0, 0.0], [0.5, 0.5]], dtype=torch.bfloat16)
    labels = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    loss = detection.masked_bce(probs, labels, torch.tensor([True, False]))
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    eps = np.float32(1e-7)  # both classes saturated on the wrong side, the clamp in fp32
    want = -(np.log(np.float32(1) - (np.float32(1) - eps)) + np.log(eps)) / 2
    assert abs(loss.item() - want) < 1e-4
    assert not bool(jnp.isfinite(jax_det.masked_bce(
        jnp.asarray([[1.0, 0.0]], jnp.bfloat16), jnp.asarray([[0.0, 1.0]], jnp.bfloat16),
        jnp.asarray([True]))))


# ------------------------------------------------- the detector against JAX

def _det_batch(rng):
    """Two clips, boxes in clip pixels, two real boxes in clip 0 and one in
    clip 1 (the rest padding), multi-hot labels, AVA metadata."""
    B = 2
    boxes = np.zeros((B, MAX_BOXES, 4), np.float32)
    boxes[0, :2] = [[2, 3, 20, 28], [10, 0, 31, 16]]
    boxes[1, :1] = [[0, 5, 24, 31]]
    mask = np.zeros((B, MAX_BOXES), bool)
    mask[0, :2] = mask[1, :1] = True
    labels = (rng.random((B, MAX_BOXES, NUM_CLASSES)) < 0.3).astype(np.int32) * mask[..., None]
    metadata = np.zeros((B, MAX_BOXES, 2), np.int32)
    metadata[0, :2] = [0, 902]
    metadata[1, :1] = [1, 904]
    return {"clips": rng.standard_normal((B, *CLIP, 3)).astype(np.float32), "boxes": boxes,
            "ori_boxes": boxes / 32.0, "labels": labels, "box_mask": mask,
            "metadata": metadata}


def _port_detector():
    with skipped_init():
        return detection.VideoDetector(MViTFeatures(MViTConfig(**SHALLOW_MVIT)), dim_in=384,
                                       num_classes=NUM_CLASSES, pool_size=POOL,
                                       dropout_rate=0.0)


@pytest.fixture(scope="module")
def jax_detector():
    """JAX's side, computed once: seeded variables over the port's tree,
    the batch, the eval step's probabilities with `run_ava_eval`'s stats,
    and for each weight decay the train step's loss, new params and first
    moments (one compiled program, weight decay injected)."""
    rng = np.random.default_rng(11)
    variables = port_variables(_port_detector(), rng)
    batch = _det_batch(rng)
    jbatch = jax.tree.map(jnp.asarray, batch)
    model = jax_det.VideoDetector(trunk=JaxMViTFeatures(cfg=JaxMViTConfig(**SHALLOW_MVIT)),
                                  dim_in=384, num_classes=NUM_CLASSES, pool_size=POOL,
                                  dropout_rate=0.0)
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=LR, weight_decay=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mvit, "DropPath", FixedDropPathJax)
        mp.delenv("MSPI_PALLAS_INTERPRET", raising=False)
        state = jax_det.DetTrainState(params=variables["params"], batch_stats={},
                                      opt_state=tx.init(variables["params"]),
                                      rng=jax.random.PRNGKey(0))
        eval_step = jax_det.make_det_eval_step(model)
        with declared_leaves() as declared:
            probs = np.asarray(eval_step(state, jbatch))
        assert_tree_declared(declared, variables)
        stats = jax_det.run_ava_eval(state, eval_step, [jbatch], num_classes=NUM_CLASSES)
        step = jax_det.make_det_train_step(model, tx, jit=True)
        steps = {}
        for wd in WEIGHT_DECAYS:  # a fresh state each: the jitted step donates it
            s = jax_det.DetTrainState(params=variables["params"], batch_stats={},
                                      opt_state=tx.init(variables["params"]),
                                      rng=jax.random.PRNGKey(0))
            s.opt_state.hyperparams["weight_decay"] = jnp.float32(wd)
            s, loss = step(s, jbatch, jnp.float32(LR))
            (adam,) = [t for t in jax.tree.leaves(
                s.opt_state, is_leaf=lambda t: hasattr(t, "mu")) if hasattr(t, "mu")]
            steps[wd] = (float(loss), jax.tree.map(np.asarray, s.params),
                         jax.tree.map(np.asarray, adam.mu))
    jax.clear_caches()
    return variables, batch, probs, stats, steps


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_detector_eval_and_ava_eval_match_jax(jax_detector):
    """The eval step's box probabilities [8, 10] within 1e-5, and
    `run_ava_eval`'s mAP and class count equal to JAX's on the same batch
    (image ids "{video},{sec:04d}", each label of a multi-hot box a
    ground-truth row)."""
    variables, batch, want_probs, want_stats, _ = jax_detector
    state = detection.create_det_state(load_port(_port_detector(), variables),
                                       lambda p: torch.optim.AdamW([t for _, t in p], lr=LR))
    eval_step = detection.make_det_eval_step()
    tb = _torch_batch(batch)
    np.testing.assert_allclose(to_np(eval_step(state, tb)), want_probs, **TOL)
    stats = detection.run_ava_eval(state, eval_step, [tb], num_classes=NUM_CLASSES)
    assert stats["num_classes_evaluated"] == want_stats["num_classes_evaluated"]
    assert abs(stats["mAP"] - want_stats["mAP"]) <= 1e-6


@pytest.mark.parametrize("weight_decay", WEIGHT_DECAYS)
def test_det_train_step_matches_jax(jax_detector, monkeypatch, weight_decay):
    """One AdamW step (LR 1e-3 passed to the step) against JAX's jitted
    step: the loss, every first moment (the unused block's zeros included),
    and the unused last trunk block and norm's parameters after the update,
    which only the weight decay moves (torch's AdamW would skip a tensor
    without a gradient)."""
    variables, batch, _, _, steps = jax_detector
    want_loss, want_params, want_mu = steps[weight_decay]
    monkeypatch.setattr(layers.DropPath, "forward", fixed_drop_path_port)
    model = load_port(_port_detector(), variables)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = detection.create_det_state(model, lambda p: torch.optim.AdamW(
        [t for _, t in p], lr=0.5, weight_decay=weight_decay))
    loss = detection.make_det_train_step()(state, _torch_batch(batch), LR)
    assert abs(loss - want_loss) <= 1e-5
    params = dict(model.named_parameters())
    names = list(params)
    moments = {names[i]: st["exp_avg"] for i, st in state.optimizer.state_dict()["state"].items()}
    _assert_leaves_close(moments, dict(state_dict_from_jax({"params": want_mu})), 2e-3, "mu")
    want_p = state_dict_from_jax({"params": want_params})
    unused = [n for n in names if n.startswith("trunk.blocks.3.")]
    assert len(unused) > 10
    for n in unused:
        # p (1 - lr wd) against optax's p - lr wd p: two fp32 roundings apart
        np.testing.assert_allclose(to_np(params[n]), want_p[n].numpy(), rtol=2.4e-7, atol=1e-9,
                                   err_msg=n)
        assert torch.equal(params[n], before[n]) == (weight_decay == 0.0), n


def test_detector_state_dict_round_trips_through_jax_converter():
    """Every key of the detector's state dict has a JAX leaf and comes back
    (`convert_state_dict` then `state_dict_from_jax`)."""
    from mspi_tpu.convert import convert_state_dict

    sd = _port_detector().state_dict()
    back = state_dict_from_jax(convert_state_dict(sd))
    assert set(back) == set(sd)
    assert {k for k in sd if k.startswith("head.")} == {"head.projection.weight",
                                                         "head.projection.bias"}


# -------------------------------------------------------------- the dataset

@pytest.fixture(scope="module")
def ava_tree(tmp_path_factory):
    """tests/test_ava_pipeline.py's synthetic AVA tree: 2 videos of 150
    48x64 JPEG frames, frame lists, GT and predicted box CSVs."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("ava")
    frame_dir, list_dir, ann_dir = root / "frames", root / "frame_lists", root / "annotations"
    for d in (frame_dir, list_dir, ann_dir):
        d.mkdir()
    rng = np.random.default_rng(0)
    header = "original_vido_id video_id frame_id path labels\n"
    lines = [header]
    for vi, vid in enumerate(("vidA", "vidB")):
        (frame_dir / vid).mkdir()
        for i in range(150):
            path = f"{vid}/{vid}_{i:06d}.jpg"
            cv2.imwrite(str(frame_dir / path), (rng.random((48, 64, 3)) * 255).astype(np.uint8))
            lines.append(f'{vid} {vi} {i} {path} ""\n')
    (list_dir / "train.csv").write_text("".join(lines))
    (list_dir / "val.csv").write_text("".join(lines))
    (ann_dir / "gt.csv").write_text("".join([
        "vidA,902,0.1,0.1,0.5,0.5,7\n", "vidA,904,0.2,0.2,0.6,0.7,12\n",
        "vidA,904,0.2,0.2,0.6,0.7,25\n", "vidB,904,0.3,0.1,0.9,0.8,3\n"]))
    (ann_dir / "pred.csv").write_text("".join([
        "vidA,904,0.2,0.2,0.6,0.7,,0.95\n", "vidA,904,0.0,0.0,0.2,0.2,,0.10\n",
        "vidB,904,0.3,0.1,0.9,0.8,,0.99\n"]))
    return dict(frame_list_dir=str(list_dir), frame_dir=str(frame_dir),
                annotation_dir=str(ann_dir))


def _make_ds(module, ava_tree, split, **kw):
    return module.AvaDataset(
        split=split, train_lists=("train.csv",), test_lists=("val.csv",),
        train_gt_box_lists=("gt.csv",), test_predict_box_lists=("pred.csv",),
        num_frames=4, sampling_rate=2, crop_size=32, jitter_scales=(36, 44),
        max_boxes=4, full_test_on_val=True, **ava_tree, **kw)


def test_parse_bboxes_and_keyframes(ava_tree):
    boxes, count, uniq = ava.parse_bboxes_file(
        [os.path.join(ava_tree["annotation_dir"], "gt.csv")], [True], 0.9)
    assert (uniq, count) == (3, 4)
    assert [b[1] for b in boxes["vidA"][904]] == [[12, 25]]
    assert ava.sec_to_frame(902) == 60
    assert 902 in ava.AVA_VALID_FRAMES and 1799 not in ava.AVA_VALID_FRAMES
    assert ava.get_sequence(2, 8, 2, num_frames=100) == jax_ava.get_sequence(2, 8, 2, 100)


@pytest.mark.parametrize("split", ["train", "val"])
def test_ava_samples_bit_equal_to_jax(ava_tree, split):
    """Every sample of two passes over the split (the train draws advance
    the seeded generator) equals the JAX dataset's bit for bit; the
    pre-port semantics hold (train: label 7 -> index 6, one box; val: the
    predicted boxes above the 0.9 threshold, no labels)."""
    port, ref = _make_ds(ava, ava_tree, split), _make_ds(jax_ava, ava_tree, split)
    assert len(port) == len(ref) == (3 if split == "train" else 2)
    for _ in range(2):
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s = port[0]
    assert s["clips"].shape == (4, 32, 32, 3) and s["box_mask"].sum() == 1
    if split == "train":
        assert s["labels"][0, 6] == 1 and port[1]["metadata"][0].tolist() == [0, 904]
    else:
        assert s["labels"].sum() == 0 and 0 <= s["boxes"][0, 0] <= s["boxes"][0, 2] <= 31


class TinyTrunk(torch.nn.Module):
    """Stride-16 toy pyramid trunk (tests/test_ava_pipeline.py's)."""

    def __init__(self):
        super().__init__()
        self.c1 = layers.Conv3d(3, 8, (1, 4, 4), stride=(1, 4, 4))
        self.c2 = layers.Conv3d(8, 8, (1, 2, 2), stride=(1, 2, 2))
        self.c3 = layers.Conv3d(8, 16, (1, 2, 2), stride=(1, 2, 2))

    def forward(self, clips):
        x = self.c2(torch.relu(self.c1(clips)))
        v3 = torch.relu(self.c3(x))
        return [x, x, v3, v3]


def test_detection_train_and_eval_end_to_end(ava_tree):
    """Four steps on a batch of the dataset lower the loss; the eval's mAP
    lies in [0, 1] over the 3 classes with ground truth."""
    ds = _make_ds(ava, ava_tree, "train")
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)])) for k in ds[0]}
    torch.manual_seed(0)
    model = detection.VideoDetector(TinyTrunk(), dim_in=16, num_classes=80, pool_size=2,
                                    dropout_rate=0.0)
    state = detection.create_det_state(model, lambda p: torch.optim.AdamW(
        [t for _, t in p], lr=1e-3, weight_decay=0.0))
    step = detection.make_det_train_step()
    losses = [step(state, batch, 1e-2) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    stats = detection.run_ava_eval(state, detection.make_det_eval_step(), [batch])
    assert np.isfinite(stats["mAP"]) and 0.0 <= stats["mAP"] <= 1.0
    assert stats["num_classes_evaluated"] == 3


def test_head_dropout_draws_from_the_step_generator(ava_tree):
    """With head dropout the step's mask comes from the state's generator:
    two states of one seed take identical steps, another seed another."""
    ds = _make_ds(ava, ava_tree, "train")
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)])) for k in ds[0]}

    def run(seed):
        torch.manual_seed(0)
        model = detection.VideoDetector(TinyTrunk(), dim_in=16, pool_size=2, dropout_rate=0.5)
        state = detection.create_det_state(
            model, lambda p: torch.optim.AdamW([t for _, t in p], lr=1e-3), seed=seed)
        return detection.make_det_train_step()(state, batch, 1e-3)

    assert run(0) == run(0) != run(1)

