"""Sliding-window prediction of a whole volume, as the published code does it.

A frozen copy of the reference's ``Model.predict`` logic
(``fnet/fnet_model.py:149-252``): the start grid (stride = ceil(patch x (1 -
overlap)), the last start moved inward so every patch is whole), a Gaussian
importance map (a centered delta filtered with sigma = patch / 8, truncate 4,
peak 1, zeros raised to the smallest positive value), and the stitch: every
patch's prediction times the map added into a sum, the map into a weight sum,
the sum divided by the weights. Float32 throughout.
"""

from __future__ import annotations

from math import ceil
from typing import Callable, Sequence

import numpy as np
import torch


def patch_starts(img_size: Sequence[int], patch_size: Sequence[int], overlap: float) -> np.ndarray:
    strides = [int(ceil(p * (1 - overlap))) for p in patch_size]
    steps = [int(ceil((i - p) / s + 1)) for i, p, s in zip(img_size, patch_size, strides)]
    starts = []
    for i in range(steps[0]):
        for j in range(steps[1]):
            for k in range(steps[2]):
                starts.append([max(min(idx * s + p, im) - p, 0) for idx, s, p, im
                               in zip((i, j, k), strides, patch_size, img_size)])
    return np.asarray(starts, np.int64)


def gaussian_map(patch_size: Sequence[int], sigma_scale: float = 1 / 8) -> np.ndarray:
    axes = []
    for p in patch_size:
        sigma = p * sigma_scale
        radius = int(4.0 * sigma + 0.5)
        x = np.arange(-radius, radius + 1, dtype=np.float64)
        k = np.exp(-0.5 / (sigma * sigma) * x * x)
        k /= k.sum()
        line = np.zeros(p)
        for i in range(p):
            d = i - p // 2
            if -radius <= d <= radius:
                line[i] = k[radius + d]
        axes.append(line)
    g = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    g = (g / g.max()).astype(np.float32)
    g[g == 0] = g[g > 0].min()
    return g


@torch.no_grad()
def predict_volume(forward: Callable, volume: torch.Tensor, patch_size, overlap: float,
                   batch: int) -> torch.Tensor:
    """``forward(patches (B,1,d,h,w)) -> (B,1,d,h,w)`` over the grid of a
    (D,H,W) float32 volume -> the stitched (D,H,W) prediction."""
    pd, ph, pw = patch_size
    starts = patch_starts(volume.shape, patch_size, overlap).tolist()
    gauss = torch.from_numpy(gaussian_map(patch_size)).to(volume.device)
    pred_sum = torch.zeros_like(volume)
    weight_sum = torch.zeros_like(volume)
    for b in range(0, len(starts), batch):
        chunk = starts[b:b + batch]
        patches = torch.stack([volume[d:d + pd, h:h + ph, w:w + pw] for d, h, w in chunk])
        preds = forward(patches[:, None])[:, 0]
        for (d, h, w), pred in zip(chunk, preds):
            pred_sum[d:d + pd, h:h + ph, w:w + pw] += pred * gauss
            weight_sum[d:d + pd, h:h + ph, w:w + pw] += gauss
    return pred_sum / weight_sum
