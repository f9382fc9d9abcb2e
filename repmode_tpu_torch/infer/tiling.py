"""Patch grid for sliding-window inference (reference fnet_model.py:155-193).

strides = ceil(patch * (1 - overlap)); steps = ceil((img - patch)/stride + 1);
candidate start = idx * stride, end clamped to the image, start moved inward
so every patch is full size.
"""

from __future__ import annotations

from math import ceil
from typing import Sequence

import numpy as np


def compute_patch_starts(
    img_size: Sequence[int],
    patch_size: Sequence[int],
    overlap: float = 0.5,
) -> np.ndarray:
    """All patch start corners, (P, 3) int32, in the reference's loop order
    (i over D, j over H, k over W)."""
    img_size = tuple(int(x) for x in img_size)
    patch_size = tuple(int(x) for x in patch_size)
    if any(i < p for i, p in zip(img_size, patch_size)):
        raise ValueError(f"volume {img_size} smaller than patch {patch_size}")

    strides = [int(ceil(p * (1 - overlap))) for p in patch_size]
    steps = [int(ceil((i - p) / s + 1)) for i, p, s in zip(img_size, patch_size, strides)]

    starts = []
    for i in range(steps[0]):
        for j in range(steps[1]):
            for k in range(steps[2]):
                starts.append([
                    max(min(idx * stride + p, im) - p, 0)
                    for idx, stride, p, im in zip((i, j, k), strides, patch_size, img_size)
                ])
    return np.asarray(starts, dtype=np.int32)
