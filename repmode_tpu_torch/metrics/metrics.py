"""Per-volume evaluation metrics: MSE, MAE, R^2.

The reference's sklearn-based get_metric_stats (fnet/metric.py:7-34) on
flattened volumes, in float64 numpy: MSE = mean((p-t)^2), MAE = mean|p-t|,
R^2 = 1 - SS_res/SS_tot with SS_tot centered on the target mean.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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
