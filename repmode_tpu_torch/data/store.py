"""In-RAM volume store (the port's copy of ``repmode_tpu.data.store``).

Every volume of every task is held in host RAM as float32 numpy, as the
reference does (fnet/data/SSPdataset.py:32-87). On disk a split is npz shards
plus a JSON manifest (``save``, ``load``), the JAX package's format.

Task id convention matches the reference: index into the *sorted* adopted
dataset tuple (SSPdataset.py:127, main.py:117).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VolumeRecord:
    signal: np.ndarray  # (D, H, W) float32, z-scored
    target: Optional[np.ndarray]  # (D, H, W) float32 or None (unlabeled)
    dataset: str
    task: int
    info: Dict  # at least {'dataset', 'path_czi'} (SSPdataset.get_information)


class VolumeStore:
    def __init__(self, records: List[VolumeRecord], adopted_datasets: Sequence[str]):
        self.records = records
        self.adopted_datasets = tuple(adopted_datasets)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> VolumeRecord:
        return self.records[i]

    def get_information(self, i: int) -> Dict:
        return self.records[i].info

    def filter_datasets(self, names: Sequence[str]) -> "VolumeStore":
        """Single/multi-task filtering (reference fliter_one_cat_data,
        SSPdataset.py:102-114, used for Multi-Net baselines)."""
        keep = set(names)
        return VolumeStore([r for r in self.records if r.dataset in keep], self.adopted_datasets)

    @classmethod
    def load(cls, path: str, split: str, adopted_datasets: Optional[Sequence[str]] = None) -> "VolumeStore":
        """Load `<path>/<split>.manifest.json` + npz shards written by ingest."""
        with open(os.path.join(path, f"{split}.manifest.json")) as f:
            manifest = json.load(f)
        datasets = tuple(adopted_datasets or manifest["adopted_datasets"])
        records: List[VolumeRecord] = []
        for entry in manifest["volumes"]:
            ds = entry["dataset"]
            if ds not in datasets:
                # single/multi-task filtering at load time (the reference's
                # fliter_one_cat_data, SSPdataset.py:102-114 — Multi-Net
                # baselines train on one task of a full manifest)
                continue
            z = np.load(os.path.join(path, entry["file"]))
            signal = z["signal"].astype(np.float32)
            target = z["target"].astype(np.float32) if "target" in z.files else None
            records.append(
                VolumeRecord(
                    signal=signal,
                    target=target,
                    dataset=ds,
                    task=datasets.index(ds),
                    info=entry.get("info", {"dataset": ds, "path_czi": entry["file"]}),
                )
            )
        return cls(records, datasets)

    def save(self, path: str, split: str) -> None:
        """Write `<path>/<split>_<i>.npz` shards and `<path>/<split>.manifest.json`
        (the JAX package's format: either package loads the other's)."""
        os.makedirs(path, exist_ok=True)
        volumes = []
        for i, r in enumerate(self.records):
            fname = f"{split}_{i:05d}.npz"
            arrays = {"signal": r.signal}
            if r.target is not None:
                arrays["target"] = r.target
            np.savez_compressed(os.path.join(path, fname), **arrays)
            volumes.append({"file": fname, "dataset": r.dataset, "info": r.info})
        manifest = {"adopted_datasets": list(self.adopted_datasets), "volumes": volumes}
        with open(os.path.join(path, f"{split}.manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
