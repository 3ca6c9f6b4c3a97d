"""Process groups and the data / model split: counterpart of
`mspi_tpu/parallel/mesh.py`.

The JAX package builds a (data, model) `jax.sharding.Mesh` and lets XLA
insert the collectives. The port says the same in PyTorch's own idiom: one
process per device, `torch.distributed` process groups, collectives the
step issues itself. Global rank r sits at (r // tp, r % tp) of a (dp, tp)
grid, as `create_mesh` reshapes its device list:

- the data group of rank r holds the ranks with its model index: the
  replicas of one model shard, over which the DDP step averages its
  gradients (`train.engine.make_ddp_train_step`);
- the model group holds the ranks with its data index: the shards of one
  replica, over which the tensor-parallel SyncBlock reduces its activations
  (`parallel.tensor_parallel`).

NCCL carries CUDA tensors, gloo CPU tensors. `maybe_init_distributed` is
the multi-host entry, as in the JAX package: MSPI_COORDINATOR (host:port),
MSPI_NUM_PROCESSES and MSPI_PROCESS_ID.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its two groups."""

    dp: int
    tp: int
    rank: int
    data_group: Any
    model_group: Any
    device: torch.device

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def create_mesh(mesh_shape: Optional[Tuple[int, int]] = None, device=None) -> Mesh:
    """The (dp, tp) grid over the initialised process group (default: every
    rank on the data axis). dp * tp must be the world size, as the JAX
    `create_mesh` asserts it of its devices. Every rank must call it: each
    group is created on all ranks in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed.init_process_group first "
                           "(maybe_init_distributed, or the training CLI's --dp/--tp)")
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, tp = mesh_shape if mesh_shape is not None else (world, 1)
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"mesh ({dp}, {tp}) needs dp * tp == the world size {world}")
    data_group = model_group = None
    for m in range(tp):  # every rank creates every group, in one order
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model_group = g
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
        else torch.device("cpu"))
    return Mesh(dp, tp, rank, data_group, model_group, device)


def data_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of n (the leading axis split over
    the data axis, as `batch_sharding` shards it); all n without a mesh.
    The loaders take it to the sample indices, so a rank decodes only its
    own samples."""
    if mesh is None or mesh.dp == 1:
        return slice(0, n)
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} rows does not split over dp = {mesh.dp}")
    per = n // mesh.dp
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def batch_shard(batch: Mapping[str, Any], mesh: Optional[Mesh]) -> dict:
    """This rank's slice (`data_rows`) of a global batch already loaded."""
    if mesh is None or mesh.dp == 1:
        return dict(batch)
    return {k: v[data_rows(v.shape[0], mesh)] for k, v in batch.items()}


def replicated(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Make `tensors` equal over the data group, in place: each takes the
    value of the group's first rank (which holds the same model shard)."""
    if mesh.dp == 1:
        return
    src = mesh.model_rank  # global rank of data index 0 with this model index
    for t in tensors:
        dist.broadcast(t.data, src, group=mesh.data_group)


def free_port() -> int:
    """A free TCP port on localhost for `init_process_group`."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, dp: int, tp: int, device: str, port: int, args) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), init_method=f"tcp://localhost:{port}",
                            world_size=dp * tp, rank=rank)
    try:
        fn(create_mesh((dp, tp), device), *args)
    finally:
        dist.destroy_process_group()


def launch(fn, dp: int, tp: int, device, *args) -> None:
    """Run fn(mesh, *args) on dp * tp ranks of one host, each a process of
    its own (`torch.multiprocessing.spawn`) in a group over
    tcp://localhost: rank r on GPU r with NCCL, or on the CPU with gloo.
    fn and args must pickle."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    if device.type == "cuda" and dp * tp > torch.cuda.device_count():
        raise SystemExit(f"dp {dp} x tp {tp} needs {dp * tp} GPUs, found "
                         f"{torch.cuda.device_count()}")
    mp.spawn(_rank_main, args=(fn, dp, tp, str(device), free_port(), args), nprocs=dp * tp)


def maybe_init_distributed(backend: Optional[str] = None) -> bool:
    """Multi-process initialisation from MSPI_COORDINATOR (host:port),
    MSPI_NUM_PROCESSES and MSPI_PROCESS_ID: `init_process_group` over TCP,
    NCCL where a card is present, else gloo. A no-op (False) unless
    MSPI_COORDINATOR is set."""
    addr = os.environ.get("MSPI_COORDINATOR")
    if not addr:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(os.environ["MSPI_NUM_PROCESSES"]),
                            rank=int(os.environ["MSPI_PROCESS_ID"]))
    return True
