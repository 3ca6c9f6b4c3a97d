"""The port's inference CLI loads `--weight` as the JAX CLI does
(`inference.py:163-170`): the state dict out of the reference's checkpoint
containers, merged with strict=False.

A small AV model's state dict is saved inside {"model_state": ...}, inside
{"state_dict": ...} and inside a port training checkpoint ({"model": ...},
written by `save_checkpoint`), each with one key the model does not have.
Each file is loaded through `inference.load_weights` into a model drawn
from another seed, whose tensors must then equal the saved ones.
"""

import pytest
import torch

from mspi_tpu_torch import inference
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.train import engine
from mspi_tpu_torch.train.checkpoints import save_checkpoint
from tests.torch_port_utils import SHALLOW_MVIT, cpu_share

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

CFG = get_config("mvitv2s", {"data": {"resolution": (64, 96)},
                             "model": {"mvit": SHALLOW_MVIT, "sync_num_blocks": 1,
                                       "simsiam_hidden": 128}})
EXTRA = "head.unused_in_this_model"


def _model(seed):
    return AudioVisualSaliencyModel(CFG, device="cpu", generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def saved():
    return _model(1)


def _write(tmp_path, container, saved):
    sd = dict(saved.state_dict())
    sd[EXTRA] = torch.zeros(3)
    path = tmp_path / f"weights_{container}.pth"
    if container == "model":  # a port training checkpoint
        state = engine.create_train_state(CFG, saved)
        path = save_checkpoint(str(tmp_path), state, 1)
        blob = torch.load(path, weights_only=False)
        blob["model"] = sd
        torch.save(blob, path)
    else:
        torch.save({container: sd}, path)
    return path


@pytest.mark.parametrize("container", ["model_state", "state_dict", "model"])
def test_weight_containers_load_non_strictly(tmp_path, saved, container):
    path = _write(tmp_path, container, saved)
    model = _model(2)
    want = saved.state_dict()
    assert any(not torch.equal(model.state_dict()[k], v) for k, v in want.items())
    inference.load_weights(model, str(path))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
