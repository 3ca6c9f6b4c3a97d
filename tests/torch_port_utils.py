"""Shared helpers of the tests that hold the PyTorch port (mspi_tpu_torch)
against the JAX package: seeded variable trees and their transfer into port
modules."""

import jax
import numpy as np
import torch

from mspi_tpu_torch.convert import state_dict_from_jax


def _leaf(rng, path, shape):
    name = path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1])) or 1
        return rng.standard_normal(shape) / np.sqrt(fan_in)
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name.startswith("rel_pos"):
        return 0.1 * rng.standard_normal(shape)
    if name == "gamma":
        return rng.uniform(0.05, 0.3, shape)
    return 0.05 * rng.standard_normal(shape)


def seeded_variables(shapes, rng):
    """Fill a tree of ShapeDtypeStructs (from jax.eval_shape of init) with
    seeded numpy values at fan-in scale; BatchNorm variances positive."""
    def fill(path, s):
        keys = tuple(getattr(k, "key", str(k)) for k in path)
        return _leaf(rng, keys, s.shape).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_module_variables(module, rng, *args, **kwargs):
    """Seeded variables for a flax module called with `args`."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return seeded_variables(shapes, rng)


def load_port(port: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into a port module (strict) and switch to eval."""
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port.eval()


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()
