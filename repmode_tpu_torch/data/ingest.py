"""Offline CZI -> VolumeStore ingest, without pandas: the port's copy of
``repmode_tpu.data.ingest``.

The reference's dataset slow path (fnet/data/SSPdataset.py:45-87): the
per-dataset CSVs (schema: path_czi, channel_signal, channel_target, ...) are
concatenated, each row's CZI is decoded, the signal/target channels
extracted, z-score normalized in float64 (fnet/transforms.py:9-14) and
XY-rescaled 0.108 -> 0.29 um/px with scipy.ndimage.zoom(..., mode='nearest')
(transforms.py:190-200, factors SSPdataset.py:22-25). Results land in an
in-RAM VolumeStore and can be saved as npz shards + a manifest
(``VolumeStore.save``, the JAX package's format).

A row is a dict typed as pandas types it (``data/csv_tools.read_csv``): an
empty ``channel_target`` is NaN, integers are ints, paths are strings. The
row goes into the record's ``info`` and so into the manifest.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from repmode_tpu_torch.config import Config
from repmode_tpu_torch.data.csv_tools import concat, read_csv
from repmode_tpu_torch.data.czi import CziVolumeReader
from repmode_tpu_torch.data.store import VolumeRecord, VolumeStore
from repmode_tpu_torch.data.transforms import Resizer, normalize

__all__ = ["normalize", "resize", "load_split_dataframe", "ingest_row", "ingest_split"]


def resize(img: np.ndarray, factors) -> np.ndarray:
    """scipy zoom, spline order 3, mode 'nearest' (transforms.py:197)."""
    return Resizer(factors)(img)


def load_split_dataframe(cfg: Config, split: str) -> List[Dict[str, Any]]:
    """The per-dataset CSVs of one split, concatenated, each row with a
    leading 'dataset' field (SSPdataset.py:46-53)."""
    tables = []
    for ds_name in cfg.data.adopted_datasets:
        columns, rows = read_csv(os.path.join(cfg.data.path_dataset_csv, ds_name, f"{split}.csv"))
        tables.append((["dataset", *columns], [{"dataset": ds_name, **r} for r in rows]))
    columns, rows = concat(tables)
    missing = [c for c in ("path_czi", "channel_signal", "channel_target") if c not in columns]
    if missing:
        raise ValueError(f"CSV missing columns: {missing}")
    return rows


def ingest_row(cfg: Config, row: Dict[str, Any]) -> VolumeRecord:
    """Decode + transform one CSV row."""
    # The reference strips the leading 'data' from path_czi (SSPdataset.py:61).
    # lstrip strips characters, not the prefix: kept as the JAX package has
    # it, so both packages read the same files.
    path_czi = cfg.data.path_dataset_czi + str(row["path_czi"]).lstrip("data")
    reader = CziVolumeReader(path_czi)

    has_target = not np.isnan(row["channel_target"])
    factors = cfg.data.resize_factors

    signal = resize(normalize(reader.get_volume(int(row["channel_signal"]))), factors)
    target = None
    if has_target:
        target = resize(
            normalize(reader.get_volume(int(row["channel_target"]))), factors
        ).astype(np.float32)

    ds = row["dataset"]
    return VolumeRecord(
        signal=signal.astype(np.float32),
        target=target,
        dataset=ds,
        task=cfg.task_index(ds),
        info=dict(row),
    )


def ingest_split(cfg: Config, split: str, logger=None) -> VolumeStore:
    """Decode a whole split; rows run in a thread pool (cfg.data.num_workers;
    numpy and scipy release the GIL for the heavy parts)."""
    rows = load_split_dataframe(cfg, split)
    workers = max(1, int(cfg.data.num_workers))
    if workers == 1 or len(rows) <= 1:
        records = [ingest_row(cfg, r) for r in rows]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            records = list(ex.map(lambda r: ingest_row(cfg, r), rows))
    if logger is not None:
        logger.info(f"[DATASET] {split} ingested with CziVolumeReader ({len(rows)} volumes)")
    return VolumeStore(records, cfg.data.adopted_datasets)
