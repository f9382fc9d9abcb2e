"""Synthetic SSP-like dataset (the port's copy of ``repmode_tpu.data.synthetic``).

Procedurally generated multi-task volumes so the entire pipeline (train /
val / test / tiled inference / benchmarks) runs end-to-end without the
~100GB Allen Institute CZI corpus. Each task's target is a distinct, learnable
transform of the shared signal (different blur radii / nonlinearities),
mimicking the reference setup where all 12 tasks share transmitted-light
input statistics but differ in the labeled structure.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repmode_tpu_torch.data.store import VolumeRecord, VolumeStore


def _box1d(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    pad = [(0, 0)] * 3
    lo = (k - 1) // 2
    pad[axis] = (lo, k - 1 - lo)
    xp = np.pad(x, pad, mode="edge")
    out = np.zeros_like(x)
    for i in range(k):
        sl = [slice(None)] * 3
        sl[axis] = slice(i, i + x.shape[axis])
        out += xp[tuple(sl)]
    return out / k


def _blur(x: np.ndarray, k: int) -> np.ndarray:
    return _box1d(_box1d(_box1d(x, k, 0), k, 1), k, 2)


def _task_transform(signal: np.ndarray, task: int) -> np.ndarray:
    """Task-specific learnable mapping signal -> target."""
    k = 3 + 2 * (task % 3)
    base = _blur(signal, k)
    if task % 4 == 0:
        t = np.maximum(base, 0.0)
    elif task % 4 == 1:
        t = base * 0.7 - 0.2 * signal
    elif task % 4 == 2:
        t = np.tanh(base)
    else:
        t = np.abs(base) - 0.3
    return t.astype(np.float32)


def synthetic_store(
    adopted_datasets: Sequence[str],
    volumes_per_task: int = 2,
    vol_shape: Tuple[int, int, int] = (32, 128, 128),
    seed: int = 0,
) -> VolumeStore:
    """Z-scored synthetic volumes for every task, shaped like post-ingest data."""
    datasets = tuple(sorted(adopted_datasets))
    rng = np.random.default_rng(seed)
    records = []
    for task, ds in enumerate(datasets):
        for v in range(volumes_per_task):
            raw = rng.standard_normal(vol_shape).astype(np.float32)
            signal = _blur(raw, 5)
            # z-score like transforms.normalize (transforms.py:9-14)
            signal = (signal - signal.mean()) / signal.std()
            target = _task_transform(signal, task)
            records.append(
                VolumeRecord(
                    signal=signal.astype(np.float32),
                    target=target,
                    dataset=ds,
                    task=task,
                    info={"dataset": ds, "path_czi": f"synthetic/{ds}_{v:03d}.czi"},
                )
            )
    return VolumeStore(records, datasets)
