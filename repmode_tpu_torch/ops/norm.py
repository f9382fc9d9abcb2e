"""Batch normalization with torch BatchNorm3d eval semantics, on NDHWC.

Eval only: ``batch_norm_train`` (biased variance for the output, unbiased
for the running variance, momentum 0.1) comes with the training path.
"""

from __future__ import annotations

import torch


def batch_norm_apply(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Normalize the last (channel) axis with given statistics, in fp32
    (fp64 stays fp64): (x - mean) * rsqrt(var + eps) * scale + bias."""
    dt = torch.promote_types(x.dtype, torch.float32)
    inv = torch.rsqrt(var.to(dt) + eps)
    return (x.to(dt) - mean.to(dt)) * inv * scale.to(dt) + bias.to(dt)
