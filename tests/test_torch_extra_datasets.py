"""The port's `data/extra_datasets.py` (SSv2, Charades, ImageNet folders)
against the JAX package on synthetic trees (the cases of
`tests/test_extra_datasets.py`): every sample, the seeded draws included,
bit for bit equal to the JAX dataset's of the same seed, and the pre-port
semantics."""

import json
import os

import numpy as np
import pytest

from mspi_tpu.data import extra_datasets as jax_extra
from mspi_tpu_torch.data import extra_datasets as extra
from tests.torch_port_utils import cpu_share  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


def _write_frames(d, n, rng, size=(64, 80)):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.random((*size, 3)) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:06d}.jpg"))


def _same_samples(port, ref, passes=2):
    """Every sample of `passes` passes equal (clip, label and index)."""
    assert len(port) == len(ref)
    for _ in range(passes):
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert got.clip.dtype == want.clip.dtype == np.uint8
            np.testing.assert_array_equal(got.clip, want.clip)
            np.testing.assert_array_equal(got.label, want.label)
            assert got.index == want.index == i


def test_segment_indices():
    for train in (False, True):
        a, b = np.random.default_rng(0), np.random.default_rng(0)
        for n, k in ((100, 8), (4, 8), (17, 16)):
            np.testing.assert_array_equal(extra.segment_indices(n, k, train, a),
                                          jax_extra.segment_indices(n, k, train, b))
    idx = extra.segment_indices(100, 8, train=False, rng=np.random.default_rng(0))
    assert len(idx) == 8 and idx[0] < idx[-1] < 100
    assert extra.segment_indices(4, 8, train=False, rng=np.random.default_rng(0)).max() <= 3


@pytest.mark.parametrize("split", ["train", "val"])
def test_ssv2(tmp_path, rng, split):
    root = tmp_path / "ssv2"
    os.makedirs(root)
    with open(root / "labels.json", "w") as f:
        json.dump({"pushing something": 0, "pulling something": 1}, f)
    with open(root / f"{split}.json", "w") as f:
        json.dump([{"id": "123", "template": "[pushing] something"},
                   {"id": "7", "label": "pulling something"}], f)
    _write_frames(str(root / "frames" / "123"), 20, rng)
    _write_frames(str(root / "frames" / "7"), 11, rng)
    kw = dict(num_frames=8, crop_size=56, jitter_scales=(64, 72), seed=3)
    port = extra.SSv2Frames(str(root), split, **kw)
    _same_samples(port, jax_extra.SSv2Frames(str(root), split, **kw))
    s = port[0]
    assert s.clip.shape == (8, 56, 56, 3) and int(s.label) == 0 and int(port[1].label) == 1


def test_charades(tmp_path, rng):
    root = tmp_path / "charades"
    os.makedirs(root)
    with open(root / "train.csv", "w") as f:
        f.write("VID1,24.0,c005 0.0 2.0;c083 1.0 3.0\n")
    _write_frames(str(root / "frames" / "VID1"), 48, rng)
    kw = dict(num_frames=4, sampling_rate=2, crop_size=56, jitter_scales=(64, 72), seed=5)
    port = extra.CharadesFrames(str(root), "train", **kw)
    _same_samples(port, jax_extra.CharadesFrames(str(root), "train", **kw), passes=3)
    s = port[0]
    assert s.clip.shape == (4, 56, 56, 3) and s.label.shape == (157,)
    assert s.label[5] == 1.0 and s.label[83] == 1.0 and s.label.sum() == 2.0


def test_imagenet_folder(tmp_path, rng):
    from PIL import Image

    for cls in ("cat", "dog"):
        d = tmp_path / "train" / cls
        os.makedirs(d)
        for name in ("a", "b"):
            Image.fromarray((rng.random((80, 90, 3)) * 255).astype(np.uint8)).save(
                d / f"{name}.jpg")
    kw = dict(crop_size=56, jitter_scales=(64, 72), seed=2)
    port = extra.ImageNetFolder(str(tmp_path), "train", **kw)
    _same_samples(port, jax_extra.ImageNetFolder(str(tmp_path), "train", **kw))
    assert len(port) == 4 and port[0].clip.shape == (56, 56, 3)
    assert port.class_to_idx == {"cat": 0, "dog": 1}
