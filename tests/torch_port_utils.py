"""Shared helpers of the tests that hold the PyTorch port (mspi_tpu_torch)
against the JAX package: seeded variable trees and their transfer into port
modules."""

import contextlib
import functools
import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from mspi_tpu_torch.convert import state_dict_from_jax
from tests.torch_dist_worker import fixed_drop_path as fixed_drop_path_port  # noqa: F401
from tests.torch_dist_worker import skipped_init  # noqa: F401


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


def xdist_thread_share() -> int:
    """Under pytest-xdist, each worker's share of the CPU cores (1 for 6
    workers on 8 cores); 0 outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    return max(1, (os.cpu_count() or 1) // workers) if workers else 0


@pytest.fixture
def cpu_share():
    """Run the test on the worker's share of torch CPU threads. Every xdist
    worker otherwise starts one torch thread per core, which oversubscribes
    the cores several times over (the port's tests took 297 s and 33 CPU
    minutes under 6 workers, 162 s and 11 with one thread each). Outside
    xdist nothing changes."""
    n = xdist_thread_share()
    if not n:
        yield
        return
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def count_calls(fns, counts, monkeypatch):
    """Wrap each (module, name) function so that its calls add up in
    counts[name]: the kernel functions of both packages in the routing
    tests."""
    for module, name in fns:
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)


# A four-block MViT config with the flagship's four widths (96, 192, 384, 768):
# each block is a stage and a tap, blocks 1-3 draw drop-path in training.
# For the tests whose subject is not the backbone's depth.
SHALLOW_MVIT = {"depth": 4, "dim_mul": ((1, 2.0), (2, 2.0), (3, 2.0)),
                "head_mul": ((1, 2.0), (2, 2.0), (3, 2.0)),
                "pool_q_stride": ((0, 1, 1, 1), (1, 1, 2, 2), (2, 1, 2, 2), (3, 1, 2, 2)),
                "out_indices": (0, 1, 2, 3)}


class FixedDropPathJax(fnn.Module):
    """Drop-path with a fixed mask, for a step compared across the two
    frameworks: in train mode, blocks with rate > 0.1 drop sample 1 and
    every kept sample is scaled by 1 / (1 - rate). Patch it over
    `mspi_tpu.models.mvit.DropPath`, and `fixed_drop_path_port` (the same
    masks, `tests.torch_dist_worker.fixed_drop_path`) over the port's
    `DropPath.forward`."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        if deterministic or self.rate == 0.0:
            return x
        mask = np.array([not (b == 1 and self.rate > 0.1) for b in range(x.shape[0])])
        mask = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return jax.numpy.where(mask, x / (1.0 - self.rate), jax.numpy.zeros_like(x))



# XLA's backend (LLVM) optimisation off for the JAX reference programs of the
# port's tests: a full training step compiles in about two thirds of the
# time, and runs as fast, to the same results within rounding (its loss
# moves by 1e-7 relative)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def compile_fast(jitted, *args):
    """`jitted` (a `jax.jit` function) compiled for `args` with
    FAST_COMPILE; call the result with the same args."""
    return jitted.lower(*args).compile(compiler_options=FAST_COMPILE)


def jit_fast(fn, *args):
    """fn(*args) as one JAX program compiled with FAST_COMPILE (every
    argument a pytree of arrays)."""
    return compile_fast(jax.jit(fn), *args)(*args)



def port_variables(port: torch.nn.Module, rng):
    """Seeded numpy variables over the port module's own tree (its state
    dict through the JAX package's converter), at `seeded_variables`'
    scales. This spares tracing the JAX model's init; hold the JAX model's
    tree against it with `declared_leaves` around the JAX program's trace."""
    from mspi_tpu.convert import convert_state_dict

    return jax.tree.map(np.asarray, dict(seeded_variables(convert_state_dict(port.state_dict()),
                                                          rng)))


@contextlib.contextmanager
def declared_leaves():
    """Record every parameter and BatchNorm statistic that flax modules
    declare while traced inside the block, as (collection, *path, name):
    a JAX program traced on `port_variables` declares each leaf of the JAX
    model's own tree (apply raises on a declared leaf that is missing, and
    on one of another shape), so `assert_tree_declared` holds the two trees
    leaf for leaf, as a strict load from JAX's init tree would."""
    from flax.core import scope as flax_scope

    found = set()
    reserve = flax_scope.Scope.reserve

    def recording(self, name, col=None):
        if col in ("params", "batch_stats"):
            found.add((col, *self.path, name))
        return reserve(self, name, col)

    flax_scope.Scope.reserve = recording
    try:
        yield found
    finally:
        flax_scope.Scope.reserve = reserve


def assert_tree_declared(declared, variables) -> None:
    """The leaves of `variables` are exactly those `declared_leaves`
    recorded."""
    want = {(col, *path) for col, tree in variables.items()
            for path, _ in _tree_leaves(tree)}
    assert declared == want, (f"port-only leaves {sorted(want - declared)[:5]}, "
                              f"JAX-only leaves {sorted(declared - want)[:5]}")


def _tree_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _tree_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value



_IMPORT_CHECK = """
import importlib, json, pkgutil, sys
bad = {}
names = ["mspi_tpu_torch"]
for name in names:
    before = set(sys.modules)
    importlib.import_module(name)
    new = sorted(m for m in set(sys.modules) - before
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "mspi_tpu"))
    if new:
        bad[name] = new
    if name == "mspi_tpu_torch":
        pkg = sys.modules[name]
        names += sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, name + "."))
print(json.dumps({"modules": names, "bad": bad}))
"""


@functools.lru_cache(maxsize=None)
def port_import_check():
    """Every module of `mspi_tpu_torch`, imported one after another in one
    fresh interpreter: ({module names}, {module: the JAX, flax or
    mspi_tpu modules its import added}). Computed once per test process
    and shared by the tests that hold the port free of JAX."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], check=True, timeout=300,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    result = json.loads(out.stdout.strip().splitlines()[-1])
    return set(result["modules"]), result["bad"]


def assert_imports_no_jax(modules) -> None:
    """The port imports neither JAX, flax nor the JAX package: no module of
    `mspi_tpu_torch` (the package first) adds one when imported, and
    `modules` (names under mspi_tpu_torch; "" the package) are among those
    imported."""
    names, bad = port_import_check()
    assert not bad, bad
    missing = sorted(m for m in modules if ("mspi_tpu_torch." + m).rstrip(".") not in names)
    assert not missing, missing
