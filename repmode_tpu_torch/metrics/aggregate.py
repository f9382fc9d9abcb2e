"""Per-task / overall metric aggregation and CSV export.

The reference's aggregation in run_eval (main.py:299-322): per-volume rows,
their mean per dataset, and the overall mean, written as comp_/spec_/final_
CSVs with the reference's columns. Written with the ``csv`` module (the
JAX package uses pandas; the port does not need it).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_METRICS = ("MSE", "MAE", "R2")


class MetricAggregator:
    def __init__(self):
        self.rows: List[Dict] = []

    def add(self, dataset: str, path_czi: str, stats: Dict[str, float]):
        self.rows.append({"dataset": dataset, "path_czi": path_czi, **stats})

    def _columns(self) -> List[str]:
        keys = list(self.rows[0]) if self.rows else ["dataset", "path_czi", *_METRICS]
        return [k for k in keys if k not in ("dataset", "path_czi")]

    def tables(self) -> Tuple[List[Dict], List[Dict], Dict[str, float]]:
        """(comp rows, spec rows sorted by dataset, final row)."""
        cols = self._columns()
        comp = [
            {"dataset": r["dataset"], "path_czi": r["path_czi"], "img_id": f"{i:0>3d}",
             **{c: r[c] for c in cols}}
            for i, r in enumerate(self.rows)
        ]
        spec = []
        for ds in sorted({r["dataset"] for r in self.rows}):
            mine = [r for r in self.rows if r["dataset"] == ds]
            spec.append({"dataset": ds,
                         **{c: float(np.mean([r[c] for r in mine])) for c in cols}})
        final = {c: float(np.mean([r[c] for r in self.rows])) for c in cols}
        return comp, spec, final

    def log_dict(self, eval_type: str, epoch: Optional[int] = None) -> Dict[str, float]:
        """Flat metric dict, reference key naming (main.py:305-309)."""
        _, spec, final = self.tables()
        out: Dict[str, float] = {}
        if epoch is not None:
            out["X-axis/epoch"] = epoch + 1
        for column, value in final.items():
            out[f"metric_{eval_type}/{column}"] = value
            for row in spec:
                out[f"metric_{eval_type}_{column}/{row['dataset']}"] = row[column]
        return out

    def to_csvs(self, metric_dir: str, exp_name: str):
        """comp_/spec_/final_ CSVs (main.py:319-322)."""
        comp, spec, final = self.tables()
        os.makedirs(metric_dir, exist_ok=True)
        cols = self._columns()
        for prefix, header, rows in (
            ("comp", ["dataset", "path_czi", "img_id", *cols], comp),
            ("spec", ["dataset", *cols], spec),
            ("final", cols, [final]),
        ):
            with open(os.path.join(metric_dir, f"{prefix}_{exp_name}.csv"), "w",
                      newline="") as f:
                writer = csv.DictWriter(f, fieldnames=header)
                writer.writeheader()
                writer.writerows(rows)
