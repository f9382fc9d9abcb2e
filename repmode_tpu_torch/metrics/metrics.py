"""Per-volume evaluation metrics: MSE, MAE, R^2.

The reference's sklearn-based get_metric_stats (fnet/metric.py:7-34) on
flattened volumes, in float64 numpy: MSE = mean((p-t)^2), MAE = mean|p-t|,
R^2 = 1 - SS_res/SS_tot with SS_tot centered on the target mean; and the
same three in fp32 on the tensors' own device (``metric_stats_device``, no
host sync).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def metric_stats(pred, target) -> Dict[str, float]:
    """Host (numpy, float64) metrics on arbitrary-shaped arrays."""
    p = np.asarray(pred, np.float64).ravel()
    t = np.asarray(target, np.float64).ravel()
    err = p - t
    ss_res = float(np.sum(err**2))
    ss_tot = float(np.sum((t - t.mean()) ** 2))
    return {
        "MSE": float(np.mean(err**2)),
        "MAE": float(np.mean(np.abs(err))),
        "R2": 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0,
    }


def metric_stats_device(pred: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """fp32 metrics as 0-d tensors on the inputs' device (the JAX package's
    jitted ``metric_stats_device``)."""
    p = pred.float().flatten()
    t = target.float().flatten()
    err = p - t
    ss_res = torch.sum(err**2)
    ss_tot = torch.sum((t - torch.mean(t)) ** 2)
    r2 = torch.where(ss_tot > 0, 1.0 - ss_res / ss_tot, torch.zeros_like(ss_tot))
    return {"MSE": torch.mean(err**2), "MAE": torch.mean(torch.abs(err)), "R2": r2}
