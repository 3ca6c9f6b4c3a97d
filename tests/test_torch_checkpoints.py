"""The port's checkpoint loading against the JAX package: caffe2 pickles
(`mspi_tpu_torch.caffe2`, SlowFast's released weights) and the non-strict
merges' message (`train.checkpoints.load_non_strict`, behind
`inference.load_weights` and `load_pretrained_encoders`).

Keys and values are held exactly: the loaders only rename and cast.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import caffe2 as jax_caffe2
from mspi_tpu.convert.torch_convert import convert_state_dict, merge_converted
from mspi_tpu.models.slowfast import SlowFastFeatures as JaxSlowFastFeatures
from mspi_tpu.train import checkpoints as jax_checkpoints
from mspi_tpu_torch import caffe2, inference
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models.slowfast import SlowFastFeatures
from mspi_tpu_torch.train import checkpoints
from tests.test_caffe2_convert import BLOBS
from tests.torch_port_utils import cpu_share, seeded_variables  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

DROPPED = ["conv1_w_momentum", "lr", "model_iter", "pred_w", "pred_b", "res2_0_branch2a_q"]


@pytest.mark.parametrize("blob", BLOBS + DROPPED)
def test_caffe2_blob_key_matches_jax(blob):
    assert caffe2.caffe2_blob_to_torch_key(blob) == jax_caffe2.caffe2_blob_to_torch_key(blob)


def test_load_caffe2_pickle_matches_jax(rng, tmp_path):
    """Every blob name of tests/test_caffe2_convert.py and the solver /
    head blobs in one pickle: the same keys, the same values and dtypes."""
    blobs = {name: rng.standard_normal((3, 2)).astype(np.float32) for name in BLOBS + DROPPED}
    blobs["conv1_w"] = rng.standard_normal((4, 3, 1, 7, 7))  # float64, as some releases hold
    path = str(tmp_path / "release.pkl")
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    got, want = caffe2.load_caffe2_pickle(path), jax_caffe2.load_caffe2_pickle(path)
    assert sorted(got) == sorted(want) and len(got) == len(BLOBS)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


# caffe2 blobs that land in a depth-18 SlowFast, solver state, and one blob
# whose key the model lacks (stage 9)
RELEASE = ["conv1_w", "res_conv1_bn_s", "res_conv1_bn_b", "res_conv1_bn_rm", "res_conv1_bn_riv",
           "t_conv1_w", "t_res_conv1_bn_s", "res2_0_branch1_w", "res2_0_branch1_bn_rm",
           "res2_1_branch2b_w", "res2_1_branch2b_bn_riv", "t_res3_1_branch2a_w",
           "t_pool1_subsample_w", "t_pool1_subsample_bn_s",
           "t_res2_1_branch2c_bn_subsample_w", "lr", "pred_w", "res9_0_branch2a_w"]


class _Model(torch.nn.Module):
    def __init__(self, visnet):
        super().__init__()
        self.visnet = visnet


@pytest.mark.parametrize("name", ["release.pkl", "release.pyth"])
def test_slowfast_caffe2_weights_load_as_in_jax(rng, tmp_path, capsys, name):
    """`load_pretrained_encoders` for slowfast4x16 (depth 18) reads a caffe2
    pickle whatever its file name: the port's visnet takes the same values
    at the same keys as the JAX loader's merged variables (float64 blobs
    cast to the model's float32), the tensors it does not name stay, and it
    prints the JAX merge's message (1 unused key, the stage-9 blob)."""
    cfg = get_config("slowfast4x16", {"model": {"slowfast": {"depth": 18}}})
    torch.manual_seed(0)
    visnet = SlowFastFeatures(cfg.model.slowfast)
    before = {k: v.clone() for k, v in visnet.state_dict().items()}
    keys = {b: caffe2.caffe2_blob_to_torch_key(b) for b in RELEASE}
    blobs = {b: rng.standard_normal(tuple(before[k].shape) if k in before else (2, 2))
             for b, k in keys.items()}
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)

    jcfg = jax_get_config("slowfast4x16", {"model": {"slowfast": {"depth": 18},
                                                     "motion_encoder_weight": path}})
    shapes = jax.eval_shape(lambda: JaxSlowFastFeatures(cfg=jcfg.model.slowfast).init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 16, 64, 64, 3))))
    jvars = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    merged = jax_checkpoints.load_pretrained_encoders(
        jcfg, {c: {"visnet": tree} for c, tree in jvars.items()})
    want = state_dict_from_jax({c: tree["visnet"] for c, tree in merged.items()})
    capsys.readouterr()

    model = _Model(visnet)
    cfg.model.motion_encoder_weight = path
    checkpoints.load_pretrained_encoders(cfg, model)
    got = visnet.state_dict()
    loaded = {k for k in keys.values() if k is not None and k in before}
    assert len(loaded) == 15
    for k in loaded:
        assert torch.equal(got[k], want[k].float()), k
    for k, v in before.items():
        if k not in loaded:
            assert torch.equal(got[k], v), k
    n_left = sum(1 for k in before if k not in loaded and not k.endswith("num_batches_tracked"))
    assert capsys.readouterr().out.splitlines() == [
        f"[convert] non-strict merge: 1 checkpoint keys unused, {n_left} model leaves left "
        f"at init; first unused: s9.pathway0_res0.branch2.a.weight"]


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)
        self.ln = torch.nn.LayerNorm(3)


@pytest.mark.parametrize("loader", ["load_weights", "load_pretrained_encoders"])
def test_non_strict_merge_message_matches_jax(tmp_path, capsys, loader):
    """A state dict with one stray key and without `ln.bias`: both port
    merges print JAX's `merge_converted(strict=False)` line, with the port's
    key names; the tensors it carries load."""
    src = _Tiny()
    sd = {k: v.detach().clone() + 1 for k, v in src.state_dict().items() if k != "ln.bias"}
    sd["stray.weight"] = torch.zeros(2, 2)
    target = {"fc": {"kernel": np.zeros((4, 3), np.float32), "bias": np.zeros(3, np.float32)},
              "ln": {"scale": np.ones(3, np.float32), "bias": np.zeros(3, np.float32)}}
    merge_converted(target, convert_state_dict({k: v.numpy() for k, v in sd.items()})["params"],
                    strict=False)
    want = capsys.readouterr().out.strip()
    assert want.endswith("; first unused: stray/kernel")

    model = _Tiny()
    path = str(tmp_path / "weights.pth")
    torch.save({"model_state": sd}, path)
    if loader == "load_weights":
        inference.load_weights(model, path)
    else:
        holder = torch.nn.Module()
        holder.audnet = model
        cfg = get_config("mvitv2s", {"model": {"audio_encoder_weight": path}})
        checkpoints.load_pretrained_encoders(cfg, holder)
    got = capsys.readouterr().out.strip()
    assert got == want.replace("stray/kernel", "stray.weight")
    assert torch.equal(model.fc.weight, sd["fc.weight"]) and torch.equal(model.ln.weight,
                                                                        sd["ln.weight"])
