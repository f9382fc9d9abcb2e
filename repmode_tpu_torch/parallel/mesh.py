"""Data parallelism over a ``torch.distributed`` group: a 1-D ``data`` mesh.

The counterpart of ``repmode_tpu/parallel/mesh.py``. JAX builds one program
over a mesh of devices; here each device is driven by a rank of its own,
started by ``launch`` (one process a rank, spawn start method). The
semantics are JAX's, and so is the property it states for itself: a run on W
ranks computes what a run on one computes on the same global batch.

  * every rank draws the same global batch and keeps its contiguous slice
    (``shard_batch``: JAX's ``P("data")``);
  * parameters and buffers start equal (``replicate`` broadcasts rank 0's);
  * batch norm takes global batch statistics (sync-BN, ``sync_batch_norm``
    marks the net's ``BatchNorm3d`` modules; ``ops/norm.batch_norm_train``
    all-reduces their sums), a documented deviation from the reference's
    per-GPU statistics, as in JAX;
  * gradients are averaged over the ranks before the optimizer step
    (``all_reduce_mean_``), so parameters, BN statistics and Adam state stay
    bit-equal on every rank.

The only collectives are ``all_reduce`` and ``broadcast``: what gloo runs on
CUDA tensors, so two gloo ranks may share one card. Where a rank's device
comes from: ``device`` ``"cuda"`` gives rank r the card ``cuda:r`` (one card
a rank, NCCL's case); ``"cuda:K"`` puts every rank on card K (ranks sharing
a card, gloo); ``"cpu"`` runs every rank on the CPU (gloo).
"""

from __future__ import annotations

import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp
from torch import nn

from repmode_tpu_torch.parallel.distributed import initialize, shutdown

DeviceSpec = Any  # a str or torch.device: "cpu", "cuda" or "cuda:K"


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data mesh: its rank, the mesh size, the
    device it drives and the process group."""

    rank: int
    size: int
    device: torch.device
    group: Any

    @property
    def is_main(self) -> bool:
        """Rank 0, the one rank that writes files."""
        return self.rank == 0


def rank_device(device: DeviceSpec, rank: int) -> torch.device:
    """The device rank ``rank`` drives: ``cuda`` -> ``cuda:rank``; an indexed
    card or the CPU as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def check_devices(num_devices: int, device: DeviceSpec) -> None:
    """Raise, as JAX's ``make_mesh`` does, when ``num_devices`` ranks of one
    card each need more cards than the machine has."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    have = torch.cuda.device_count()
    if dev.index is None and num_devices > have:
        raise ValueError(f"requested {num_devices} devices, have {have}")
    if dev.index is not None and dev.index >= have:
        raise ValueError(f"requested device {dev}, have {have}")


def make_mesh(num_devices: int, device: DeviceSpec = "cuda") -> Mesh:
    """This rank's 1-D ``data`` mesh over ``num_devices`` ranks. The group
    must have been started by ``launch`` (or ``distributed.initialize``)
    with that many ranks."""
    check_devices(num_devices, device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != num_devices:
        raise RuntimeError(
            f"a {num_devices}-device mesh needs a process group of {num_devices} ranks, "
            f"this process is in one of {world}: launch the run through "
            "repmode_tpu_torch.parallel.launch (the CLIs do so for --num_devices > 1)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(rank, num_devices, rank_device(device, rank), group)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """This rank's contiguous slice of a global batch (numpy arrays or
    tensors, leading axis the batch), on the rank's device."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} does not split over {mesh.size} devices")
        b = n // mesh.size
        part = v[mesh.rank * b:(mesh.rank + 1) * b]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out[k] = part.to(mesh.device)
    return out


@torch.no_grad()
def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def sync_batch_norm(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Mark every ``BatchNorm3d`` of ``module`` to take its training-mode
    statistics over the mesh's global batch (``models/repmode._bn`` passes the
    mark to ``ops/norm.batch_norm_train``), as ``convert_sync_batchnorm``
    does, without replacing the modules."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm3d):
            m.sync_group = mesh.group
    return module


@torch.no_grad()
def all_reduce_mean_(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks: one ``all_reduce`` of
    the tensors flattened together."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    for t, f in zip(tensors, torch._utils._unflatten_dense_tensors(flat, tensors)):
        t.copy_(f)


def all_reduce_sum_(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place; returns it."""
    dist.all_reduce(tensor, group=mesh.group)
    return tensor


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an ``all_reduce`` of one element on the rank's
    device, so a barrier is one of the two collectives too)."""
    all_reduce_sum_(mesh, torch.zeros(1, device=mesh.device))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, num_devices: int, device: DeviceSpec, backend: str,
               init_method: str, timeout_s: Optional[float], threads: int, args: tuple,
               results) -> None:
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        initialize(init_method, num_devices, rank, backend, timeout_s)
        try:
            out = fn(*args)
        finally:
            shutdown()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def launch(fn: Callable, num_devices: int, device: DeviceSpec, backend: str, args: tuple = (),
           init_method: Optional[str] = None, timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``num_devices`` ranks of one process group and
    return their results in rank order.

    Each rank is a process of its own (``torch.multiprocessing``, spawn: the
    caller may have started CUDA already, which fork would break). It drives
    ``rank_device(device, rank)`` and joins the group through ``init_method``
    (default ``tcp://localhost:<a free port>``; ``file://`` where several
    launches may run at once) with ``backend``, given by the caller. Ranks
    on the CPU share the caller's intra-op threads between them. ``fn`` is a
    module-level function and its result is pickled back, so it returns
    no CUDA tensor. A rank that fails, or a run past ``timeout_s``, stops
    every rank and raises with each failed rank's traceback; a rank that
    exits with another code than 0 raises too."""
    check_devices(num_devices, device)
    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    ctx = torch_mp.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // num_devices)
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, fn, num_devices, device, backend, init_method, timeout_s,
                               threads, args, results))
             for r in range(num_devices)]
    for p in procs:
        p.start()
    outs: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(outs) < num_devices and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in outs and p.exitcode not in (None, 0):
                        errors[r] = f"rank {r} exited with code {p.exitcode} and no result"
                if deadline is not None and time.monotonic() > deadline:
                    errors[-1] = f"the ranks ran past {timeout_s} s"
                continue
            if ok:
                outs[rank] = value
            else:
                errors[rank] = value
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("data-parallel run failed:\n" + "\n".join(
            errors[r] for r in sorted(errors)))
    bad = [f"rank {r} exited with code {p.exitcode}" for r, p in enumerate(procs)
           if p.exitcode != 0]
    if bad:
        raise RuntimeError("data-parallel run failed: " + "; ".join(bad))
    return [outs[r] for r in range(num_devices)]


__all__ = ["Mesh", "all_reduce_mean_", "all_reduce_sum_", "barrier",
           "check_devices", "launch", "make_mesh", "rank_device", "replicate", "shard_batch",
           "sync_batch_norm"]
