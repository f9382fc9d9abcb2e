"""Data parallelism of the port over a ``torch.distributed`` group (the JAX
package's ``parallel``: a 1-D ``data`` mesh)."""

from repmode_tpu_torch.parallel.mesh import (
    Mesh,
    launch,
    make_mesh,
    replicate,
    shard_batch,
    sync_batch_norm,
)

__all__ = ["Mesh", "launch", "make_mesh", "replicate", "shard_batch", "sync_batch_norm"]
