"""Gaussian importance map for sliding-window stitching.

The reference's get_gaussian (fnet/fnet_model.py:242-252): a centered delta
filtered by scipy.ndimage.gaussian_filter(sigma = patch/8, mode='constant',
truncate=4.0), peak-normalized to 1, zeros clamped to the smallest positive
value. Filtering a delta with a separable filter gives the outer product of
the three 1-D kernels, which is what is built here. Pure numpy, computed once
per patch size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _gauss_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d(order=0): normalized taps."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return phi / phi.sum()


def _filtered_delta_1d(size: int, center: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """1-D constant-mode Gaussian filter of a delta at ``center``."""
    radius = int(truncate * sigma + 0.5)
    k = _gauss_kernel_1d(sigma, radius)
    out = np.zeros(size, dtype=np.float64)
    for i in range(size):
        d = i - center
        if -radius <= d <= radius:
            out[i] = k[radius + d]
    return out


def gaussian_importance_map(
    patch_size: Sequence[int],
    sigma_scale: float = 1 / 8,
    dtype=np.float32,
) -> np.ndarray:
    """(D,H,W) Gaussian blending weights, peak 1, strictly positive."""
    patch_size = tuple(int(p) for p in patch_size)
    axes = [
        _filtered_delta_1d(p, p // 2, p * sigma_scale) for p in patch_size
    ]
    g = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    g = (g / g.max()).astype(dtype)
    # zero weights would give 0/0 in the stitched divide (fnet_model.py:250-251)
    g[g == 0] = g[g > 0].min()
    return g
