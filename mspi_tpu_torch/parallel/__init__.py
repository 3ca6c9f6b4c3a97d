"""Data and tensor parallelism of the port (`torch.distributed`):
counterpart of `mspi_tpu/parallel/`."""

from mspi_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    backend_for,
    batch_shard,
    create_mesh,
    data_rows,
    free_port,
    launch,
    maybe_init_distributed,
    replicated,
)
from mspi_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    gather_sync_block,
    shard_sync_block,
)
