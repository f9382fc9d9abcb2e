"""Batch normalization with torch BatchNorm3d semantics, on NDHWC.

The port of ``repmode_tpu/ops/norm.py``. In training mode the batch
statistics are computed as the JAX package computes them: in fp32 (fp64
stays fp64), the variance as E[x^2] - E[x]^2 clamped at 0. The output uses
the biased variance and the running variance the unbiased one, momentum 0.1.
Plain PyTorch ops: autograd gives the backward, as XLA's AD does in JAX.

``phases=4`` normalizes a space-to-depth tensor (N,D,h',w',4C), phase-major:
it is viewed as (..., 4, C), so statistics and parameters are per native
channel, as for the native tensor (``repmode_tpu/models/repmode.py``
``BatchNorm3d(phases=4)``).

Under data parallelism (``group``) the statistics are the global batch's,
as JAX's mesh computes them (``repmode_tpu/parallel/mesh.py``: sync-BN):
each rank's per-channel sums of x and x^2 and its count are all-reduced, with
autograd, and the same E[x^2] - E[x]^2 follows. ``nn.SyncBatchNorm`` is not
used: it computes another variance, needs ``all_gather`` (which gloo does not
run on CUDA tensors) and has no CPU path.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; its backward sums the cotangents the same
    way. (``torch.distributed.nn.functional.all_reduce`` is this, deprecated
    in recent torch.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def _global_moments(x32: torch.Tensor, axes, group) -> tuple:
    """(E[x], E[x^2], n / (n - 1)) per channel over every rank's batch of n
    positions: one all-reduce of the local sums and count, in fp64 (the count
    exact), with no host sync."""
    n = x32.numel() // x32.shape[-1]
    local = torch.cat([x32.sum(dim=axes), torch.square(x32).sum(dim=axes)]).double()
    count = torch.full((1,), float(n), dtype=torch.float64, device=x32.device)
    tot = _AllReduceSum.apply(torch.cat([local, count]), group)
    c = x32.shape[-1]
    total_n = tot[-1]
    mean = (tot[:c] / total_n).to(x32.dtype)
    mean_sq = (tot[c:2 * c] / total_n).to(x32.dtype)
    return mean, mean_sq, (total_n / (total_n - 1).clamp(min=1)).detach().to(x32.dtype)


def batch_norm_apply(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    phases: int = 1,
) -> torch.Tensor:
    """Normalize the last (channel) axis with given statistics, in fp32
    (fp64 stays fp64): (x - mean) * rsqrt(var + eps) * scale + bias."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xv = x.reshape(*x.shape[:-1], phases, -1) if phases > 1 else x
    inv = torch.rsqrt(var.to(dt) + eps)
    y = (xv.to(dt) - mean.to(dt)) * inv * scale.to(dt) + bias.to(dt)
    return y.reshape(x.shape)


def batch_norm_train(
    x: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    momentum: float = 0.1,
    eps: float = 1e-5,
    num_batches_tracked: Optional[torch.Tensor] = None,
    phases: int = 1,
    group: Optional[Any] = None,
) -> torch.Tensor:
    """Training mode: normalize by the batch statistics over (N, D, H, W).

    Updates ``running_mean`` and ``running_var`` in place (no autograd) to
    (1 - momentum) * running + momentum * batch, with the unbiased batch
    variance, and adds one to ``num_batches_tracked`` when given, as
    torch.nn.BatchNorm3d does. With a process ``group`` the batch is every
    rank's together (sync-BN). Returns the normalized x.
    """
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if phases > 1:
        x32 = x32.reshape(*x.shape[:-1], phases, -1)
    axes = tuple(range(x32.dim() - 1))
    if group is None:
        bmean = x32.mean(dim=axes)
        mean_sq = torch.square(x32).mean(dim=axes)
        n = x32.numel() // x32.shape[-1]
        unbias = n / max(n - 1, 1)
    else:
        bmean, mean_sq, unbias = _global_moments(x32, axes, group)
    bvar = torch.clamp(mean_sq - torch.square(bmean), min=0.0)
    y = batch_norm_apply(x32, bmean, bvar, scale, bias, eps).reshape(x.shape)
    with torch.no_grad():
        unbiased = bvar * unbias
        running_mean.mul_(1.0 - momentum).add_(momentum * bmean.to(running_mean.dtype))
        running_var.mul_(1.0 - momentum).add_(momentum * unbiased.to(running_var.dtype))
        if num_batches_tracked is not None:
            num_batches_tracked.add_(1)
    return y
