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
"""

from __future__ import annotations

from typing import Optional

import torch


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
) -> torch.Tensor:
    """Training mode: normalize by the batch statistics over (N, D, H, W).

    Updates ``running_mean`` and ``running_var`` in place (no autograd) to
    (1 - momentum) * running + momentum * batch, with the unbiased batch
    variance, and adds one to ``num_batches_tracked`` when given, as
    torch.nn.BatchNorm3d does. Returns the normalized x.
    """
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if phases > 1:
        x32 = x32.reshape(*x.shape[:-1], phases, -1)
    axes = tuple(range(x32.dim() - 1))
    bmean = x32.mean(dim=axes)
    bvar = torch.clamp(torch.square(x32).mean(dim=axes) - torch.square(bmean), min=0.0)
    y = batch_norm_apply(x32, bmean, bvar, scale, bias, eps).reshape(x.shape)
    n = x32.numel() // x32.shape[-1]
    with torch.no_grad():
        unbiased = bvar * (n / max(n - 1, 1))
        running_mean.mul_(1.0 - momentum).add_(momentum * bmean.to(running_mean.dtype))
        running_var.mul_(1.0 - momentum).add_(momentum * unbiased.to(running_var.dtype))
        if num_batches_tracked is not None:
            num_batches_tracked.add_(1)
    return y
