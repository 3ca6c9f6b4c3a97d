"""JAX variables -> the port's torch state_dict.

`state_dict_from_jax` is the exact inverse of the JAX package's
`mspi_tpu.convert.convert_state_dict` (torch state_dict -> flax variables):

  flax leaf                       torch key
  params/a/layers_3/conv/kernel   a.3.conv.weight   (axes transposed back)
  params/bn/scale                 bn.weight
  batch_stats/bn/mean, var        bn.running_mean, bn.running_var
                                  (+ bn.num_batches_tracked = 0, which the
                                  forward converter drops)
  anything else (bias, rel_pos_*, gamma, ...) verbatim

Kernels: [I, O] -> [O, I] (Linear), [k, I, O] -> [O, I, k] (Conv1d),
[kh, kw, I, O] -> [O, I, kh, kw], [kt, kh, kw, I, O] -> [O, I, kt, kh, kw].

`adamw_state_dict_from_jax` carries the training state across as well: the
optax AdamW moments of a JAX TrainState (`count`, `mu`, `nu`, trees shaped
like the trainable params) become a `torch.optim.AdamW.state_dict()` through
the same name and axis mapping, so a JAX run resumes in the port.
The inputs are nested dicts of numpy arrays; nothing here imports JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_scope(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path:
        idx = p[len("layers_"):]
        parts.append(idx if p.startswith("layers_") and idx.isdigit() else p)
    return ".".join(parts)


def state_dict_from_jax(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """{'params': ..., 'batch_stats': ...} of numpy arrays -> state_dict.
    Raises on a collection or leaf it cannot place."""
    sd: Dict[str, torch.Tensor] = OrderedDict()

    def put(key: str, arr: np.ndarray) -> None:
        if key in sd:
            raise ValueError(f"two JAX leaves map to torch key {key!r}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))

    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"cannot place JAX collection {collection!r}")
        for path, value in _leaves(tree):
            *scope, leaf = path
            prefix = _torch_scope(tuple(scope))
            arr = np.asarray(value)
            where = "/".join((collection,) + path)
            if collection == "batch_stats":
                if leaf not in ("mean", "var"):
                    raise ValueError(f"cannot place batch_stats leaf {where}")
                put(f"{prefix}.running_{leaf}", arr)
                if leaf == "mean":
                    put(f"{prefix}.num_batches_tracked", np.zeros((), np.int64))
            elif leaf == "kernel":
                if arr.ndim not in _KERNEL_AXES:
                    raise ValueError(f"cannot place {arr.ndim}-D kernel {where}")
                put(f"{prefix}.weight", arr.transpose(_KERNEL_AXES[arr.ndim]))
            elif leaf == "scale":
                if arr.ndim != 1:
                    raise ValueError(f"cannot place {arr.ndim}-D scale {where}")
                put(f"{prefix}.weight", arr)
            elif leaf in ("weight", "running_mean", "running_var", "num_batches_tracked"):
                # convert_state_dict would not send such a torch key back here
                raise ValueError(f"cannot place params leaf {where}")
            else:
                put(f"{prefix}.{leaf}" if prefix else leaf, arr)
    return sd


def adamw_state_dict_from_jax(count, mu: Mapping[str, Any], nu: Mapping[str, Any],
                              optimizer: torch.optim.Optimizer, param_names) -> Dict[str, Any]:
    """optax AdamW state -> `optimizer.state_dict()` for the port's AdamW
    over the trainable parameters `param_names` (in the optimizer's order).
    count: the Adam step count; mu, nu: first and second moments with the
    params' tree structure. The optimizer's param_groups (LR, betas, eps,
    weight decay) are kept."""
    exp_avg = state_dict_from_jax({"params": mu})
    exp_avg_sq = state_dict_from_jax({"params": nu})
    names = list(param_names)
    if set(exp_avg) != set(names):
        missing, extra = set(names) - set(exp_avg), set(exp_avg) - set(names)
        raise ValueError(f"moments do not match the trainable parameters: missing "
                         f"{sorted(missing)[:5]}, extra {sorted(extra)[:5]}")
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": exp_avg[n].float(),
                       "exp_avg_sq": exp_avg_sq[n].float()} for i, n in enumerate(names)}
    return sd
