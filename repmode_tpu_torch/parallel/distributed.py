"""Process-group bootstrap of the port's data parallelism.

The counterpart of ``repmode_tpu/parallel/distributed.py``. Where JAX's
``jax.distributed.initialize`` finds its coordinator on a TPU slice, nothing
tells a process of its peers here: the caller gives the rendezvous address,
the world size, its rank and the backend. ``parallel.launch`` calls
``initialize`` in every rank it starts.

The backend is always the caller's: ``nccl`` where each rank has its own
card, ``gloo`` on the CPU, and ``gloo`` where ranks share one card (gloo runs
``all_reduce`` and ``broadcast`` on CUDA tensors, staged through the host).
No backend is picked after another fails.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str,
    timeout_s: Optional[float] = None,
) -> None:
    """``torch.distributed.init_process_group`` with an explicit rendezvous.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``,
    or ``file:///path`` where several groups start at once, as under a test
    runner's workers); a bare ``host:port`` is taken as ``tcp://``.
    ``timeout_s`` bounds every collective of the group."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} must be one of {BACKENDS}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method=url, world_size=num_processes,
                            rank=process_id, **kwargs)


def process_info() -> dict:
    """This process's rank and the group's size, under JAX's names; each rank
    drives one device."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1}
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world, "local_devices": 1,
            "global_devices": world}


def shutdown() -> None:
    """Tear the process group down (after the rank's last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()
