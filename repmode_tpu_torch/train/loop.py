"""Experiment directories and the full-volume eval pass.

The eval half of ``repmode_tpu.train.loop`` (reference run_eval,
main.py:269-326): volumes are predicted one at a time by the tiled
predictor through the re-parameterized net, which is built once per task and
kept for the pass; per-volume MSE/MAE/R^2 are aggregated per dataset. The
training loop comes with the training path.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from repmode_tpu_torch.config import Config
from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.metrics.aggregate import MetricAggregator
from repmode_tpu_torch.metrics.metrics import metric_stats
from repmode_tpu_torch.models.reparam import StateDict, make_inference


class ExperimentDirs:
    """exps/<exp>/{logs,checkpoints,metrics,preds} (main.py:35-54)."""

    def __init__(self, cfg: Config):
        base = cfg.path_exp_dir or os.path.join("exps", cfg.exp_name)
        self.base = base
        self.logs = os.path.join(base, "logs")
        self.checkpoints = os.path.join(base, "checkpoints")
        self.metrics = os.path.join(base, "metrics")
        self.preds = os.path.join(base, "preds")
        for d in (self.logs, self.checkpoints, self.metrics, self.preds):
            os.makedirs(d, exist_ok=True)


def run_eval_pass(
    cfg: Config,
    state: StateDict,
    store: VolumeStore,
    predictor: TiledPredictor,
    eval_type: str,
    epoch: Optional[int] = None,
) -> tuple:
    """Full-volume eval of a reference-layout state_dict over a store.

    Returns (log_dict, aggregator).
    """
    t0 = time.perf_counter()
    agg = MetricAggregator()
    prepare, _ = make_inference(cfg)  # the predictor was built from the same cfg
    plain_cache: Dict[int, dict] = {}
    for i in range(len(store)):
        rec = store[i]
        if rec.task not in plain_cache:
            plain_cache[rec.task] = prepare(state, rec.task)
        pred = predictor(plain_cache[rec.task], rec.signal).cpu().numpy()
        agg.add(rec.dataset, rec.info.get("path_czi", str(i)), metric_stats(pred, rec.target))
    log = agg.log_dict(eval_type, epoch if eval_type == "val" else None)
    log[f"time/{eval_type}"] = time.perf_counter() - t0
    return log, agg
