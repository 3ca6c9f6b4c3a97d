"""`mspi_tpu_torch.convert.state_dict_from_jax` is the exact inverse of the
JAX package's `convert_state_dict` on the flagship's variables: JAX tree ->
port state_dict -> `load_state_dict(strict=True)` -> `convert_state_dict`
gives back the same tree, leaf for leaf, with no key left over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.config import get_config as jax_get_config
from mspi_tpu.convert import convert_state_dict
from mspi_tpu.models.fusion import AudioVisualSaliencyModel as JaxModel
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.convert import state_dict_from_jax
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from tests.torch_port_utils import cpu_share, seeded_variables, skipped_init

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

RES = (64, 96)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_flagship_round_trip_is_exact(rng):
    model = JaxModel(cfg=jax_get_config("mvitv2s", overrides={"data": {"resolution": RES}}))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, *RES, 3)), jnp.zeros((1, 257, 111, 1))))
    variables = seeded_variables(shapes, rng)
    variables = jax.tree.map(np.asarray, dict(variables))

    with skipped_init():
        port = AudioVisualSaliencyModel(get_config("mvitv2s", {"data": {"resolution": RES}}),
                                        device="cpu")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    back = convert_state_dict(port.state_dict())

    want, got = _flat(variables), _flat(back)
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg="/".join(key))


@pytest.mark.parametrize("variables", [
    {"params": {"fc": {"kernel": np.zeros((2, 3, 4, 5, 6, 7), np.float32)}}},
    {"params": {"ln": {"scale": np.zeros((2, 3), np.float32)}}},
    {"params": {"bn": {"running_mean": np.zeros(3, np.float32)}}},
    {"batch_stats": {"bn": {"count": np.zeros(3, np.float32)}}},
    {"cache": {"x": np.zeros(3, np.float32)}},
])
def test_unplaceable_leaf_raises(variables):
    with pytest.raises(ValueError):
        state_dict_from_jax(variables)


def test_layer_names_and_layouts():
    variables = {
        "params": {"seq": {"layers_0": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                                        "bias": np.zeros(3, np.float32)}},
                   "conv": {"kernel": np.zeros((3, 5, 7, 2, 4), np.float32)}},
        "batch_stats": {"bn": {"mean": np.ones(4, np.float32), "var": np.ones(4, np.float32)}},
    }
    sd = state_dict_from_jax(variables)
    assert sd["seq.0.weight"].shape == (3, 2)
    torch.testing.assert_close(sd["seq.0.weight"], torch.arange(6.0).reshape(2, 3).T)
    assert sd["conv.weight"].shape == (4, 2, 3, 5, 7)
    assert int(sd["bn.num_batches_tracked"]) == 0
    assert set(sd) == {"seq.0.weight", "seq.0.bias", "conv.weight", "bn.running_mean",
                       "bn.running_var", "bn.num_batches_tracked"}
