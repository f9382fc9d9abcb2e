"""Experiment orchestration: train -> periodic val -> best checkpoint -> test.

The port of ``repmode_tpu.train.loop`` on one card (reference
main.py:21-234, run_train:240-266, run_eval:269-326):

  * epochs from the state's epoch counter (resume), validation every
    ``interval_val`` epochs, scheduled + best-on-val-MSE ``.p`` checkpoints;
  * one train step per batch of the device bank or the host sampler;
    per-task losses stay on the device and are read once per epoch;
  * eval predicts full volumes one at a time with the tiled predictor
    through the re-parameterized net (built once per task for the pass) and
    aggregates per-volume MSE/MAE/R^2 per dataset;
  * after training the best checkpoint is reloaded and tested, the
    comp_/spec_/final_ CSVs are written, and under ``save_test_preds`` /
    ``save_test_signals_and_targets`` each test volume's prediction (and its
    signal and target) is saved as a float32 TIFF under the JAX package's
    names;
  * the run record (``utils/tracking.Tracker``): every epoch's and val
    pass's log dict in ``metrics.jsonl``, the test metrics and the best
    checkpoint as summaries, at the JAX package's points.

The patch pipeline is the JAX package's choice (``on_device_pipeline``):
the device bank (``data/device_sampler``) when forced, or under auto when
the padded bank fits ``device_bank_budget_bytes``; else the host sampler.

Not ported: data parallelism (A10), which raises where it is asked for, and
the profiler hook (A12a).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repmode_tpu_torch.ckpt.checkpoint import CheckpointPolicy, load_train_state
from repmode_tpu_torch.config import Config
from repmode_tpu_torch.data.device_sampler import DeviceVolumeBank, make_device_sampler
from repmode_tpu_torch.data.sampler import PatchSampler
from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.metrics.aggregate import MetricAggregator
from repmode_tpu_torch.metrics.metrics import metric_stats
from repmode_tpu_torch.models.reparam import StateDict, make_inference
from repmode_tpu_torch.train.state import TrainState, create_train_state, param_count
from repmode_tpu_torch.train.step import make_train_step
from repmode_tpu_torch.utils import tiff
from repmode_tpu_torch.utils.tracking import Tracker


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
    pred_dir: Optional[str] = None,
) -> tuple:
    """Full-volume eval of a reference-layout state_dict over a store. A test
    pass with ``pred_dir`` saves the TIFFs its config asks for. A volume
    without a target (an empty ``channel_target``) is predicted and saved but
    left out of the metrics, where the JAX package scores it NaN and fails to
    save its target.

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
        if rec.target is not None:  # an unlabeled volume is predicted, not scored
            agg.add(rec.dataset, rec.info.get("path_czi", str(i)), metric_stats(pred, rec.target))
        if eval_type == "test" and pred_dir is not None:
            if cfg.eval.save_test_preds:
                _save_volume(pred_dir, i, "pred", rec, pred)
            if cfg.eval.save_test_signals_and_targets:
                _save_volume(pred_dir, i, "signal", rec, rec.signal)
                if rec.target is not None:
                    _save_volume(pred_dir, i, "target", rec, rec.target)
    log = agg.log_dict(eval_type, epoch if eval_type == "val" else None)
    log[f"time/{eval_type}"] = time.perf_counter() - t0
    return log, agg


def _save_volume(pred_dir: str, idx: int, kind: str, rec, arr: np.ndarray) -> None:
    """Save one volume as a multi-page float32 TIFF (reference format,
    main.py:288-297) named ``<idx>_<kind>_<dataset>_<image id>.tiff``."""
    # rstrip strips characters, not the suffix: kept as the JAX package has
    # it, so both packages write the same names
    img_id = os.path.basename(rec.info.get("path_czi", f"{idx}")).rstrip(".czi")
    base = os.path.join(pred_dir, f"{idx:0>3d}_{kind}_{rec.dataset}_{img_id}")
    tiff.imwrite(base + ".tiff", np.asarray(arr, np.float32))


def run_train_epoch(cfg: Config, state: TrainState, step_fn, sampler: PatchSampler,
                    epoch: int) -> dict:
    """One epoch from the host sampler; returns its log dict. The host reads
    the metrics once, at the epoch's end."""
    t0 = time.perf_counter()
    device = next(state.net.parameters()).device
    pending = [step_fn({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
               for batch in sampler.epoch()]
    return _epoch_log(cfg, state, pending, epoch, t0)


def run_train_epoch_device(cfg: Config, state: TrainState, step_fn, sample_fn, steps: int,
                           epoch: int) -> dict:
    """One epoch from the device sampler: ``sample_fn(epoch, step)`` feeds the
    step with no host work between steps (``data/device_sampler``)."""
    t0 = time.perf_counter()
    pending = [step_fn(sample_fn(epoch, s)) for s in range(steps)]
    return _epoch_log(cfg, state, pending, epoch, t0)


def _epoch_log(cfg: Config, state: TrainState, pending, epoch: int, t0: float) -> dict:
    """The epoch's log dict from its steps' metrics (the single sync point);
    counts the epoch."""
    num_tasks = cfg.num_tasks
    loss_sum = 0.0
    task_sums = np.zeros(num_tasks, np.float64)
    task_counts = np.zeros(num_tasks, np.float64)
    grad_norms = []
    for metrics in pending:  # single sync point
        loss_sum += float(metrics["loss"])
        task_sums += metrics["per_task_loss_sum"].double().cpu().numpy()
        task_counts += metrics["per_task_count"].double().cpu().numpy()
        if "grad_norm" in metrics:
            grad_norms.append(float(metrics["grad_norm"]))

    state.epoch += 1
    log = {"X-axis/epoch": epoch + 1, "loss/epoch": loss_sum / max(len(pending), 1)}
    for i, name in enumerate(cfg.data.adopted_datasets):
        if task_counts[i] > 0:
            log[f"loss_epoch/{name}"] = task_sums[i] / task_counts[i]
    if grad_norms:
        log["monitor/grad_norm"] = float(np.mean(grad_norms))
        log["monitor/param_norm"] = float(pending[-1]["param_norm"])
    log["time/train"] = time.perf_counter() - t0
    return log


def use_device_bank(cfg: Config, store: VolumeStore) -> Tuple[bool, int]:
    """(whether to sample from a device bank, its padded bytes): as
    ``on_device_pipeline`` says, or under auto (None) when the bank's padded
    size fits ``device_bank_budget_bytes``, as in the JAX package."""
    bank_bytes = DeviceVolumeBank.padded_nbytes(store)
    if cfg.train.on_device_pipeline is not None:
        return bool(cfg.train.on_device_pipeline), bank_bytes
    return 0 < bank_bytes <= cfg.train.device_bank_budget_bytes, bank_bytes


def run_experiment(
    cfg: Config,
    stores: Dict[str, VolumeStore],
    logger: Optional[logging.Logger] = None,
    device: DeviceLike = "cuda",
    tracker: Optional[Tracker] = None,
) -> Dict:
    """Full train + val + test experiment (reference main.main, main.py:21-234).
    Without a ``tracker`` an offline one writes ``<logs>/metrics.jsonl``.

    Returns {'state', 'best_path', 'train_log' (the last epoch's, when one
    ran), 'test_log' (when there is a test store)}.
    """
    logger = logger or logging.getLogger("SSP")
    device = resolve_device(device)
    if cfg.train.num_devices != 1:
        raise NotImplementedError("data-parallel training (num_devices > 1) is not ported (A10)")
    dirs = ExperimentDirs(cfg)
    tracker = tracker or Tracker(dirs.logs, offline=True)
    with open(os.path.join(dirs.logs, f"train_options_{cfg.exp_name}.json"), "w") as f:
        f.write(cfg.to_json())

    # model init / resume (main.py:129-138)
    state = create_train_state(cfg, torch.Generator().manual_seed(cfg.train.seed), device)
    if cfg.path_load_model and os.path.exists(cfg.path_load_model):
        load_train_state(cfg.path_load_model, state)
        logger.info(f"[MODEL]   Model loaded from: {cfg.path_load_model}")
    else:
        logger.info(f"[MODEL]   Model initialized as: {cfg.model.name}")
    logger.info(f"[MODEL]   Parameters: {param_count(state):,}")

    step_fn = make_train_step(cfg, state)
    sampler = device_sample = None
    if "train" in stores and len(stores["train"]):
        use_bank, bank_bytes = use_device_bank(cfg, stores["train"])
        if cfg.train.on_device_pipeline is None and not use_bank:
            logger.info(f"[DATA]    Device bank would need {bank_bytes / 1e9:.2f} "
                        "GB > budget — using the host pipeline")
        if use_bank:
            bank = DeviceVolumeBank.from_store(stores["train"], device)
            device_sample, steps_per_epoch = make_device_sampler(
                bank, cfg.train.batch_size, cfg.train.patch_size, cfg.train.random_flip_prob,
                seed=cfg.train.seed + 1)
            logger.info(f"[DATA]    On-device pipeline: bank of {bank.num_volumes} volumes "
                        f"padded to {bank.vol_shape} in device memory "
                        "(once-per-volume permutation epochs)")
        else:
            sampler = PatchSampler(stores["train"], cfg.train.batch_size, cfg.train.patch_size,
                                   seed=cfg.train.seed, flip_prob=cfg.train.random_flip_prob)
            logger.info("[DATA]    Host pipeline: PatchSampler")
    predictor = TiledPredictor(cfg, device=device)
    policy = CheckpointPolicy(cfg, dirs.checkpoints)
    results: Dict = {}

    # epoch loop (main.py:156-199)
    for epoch in range(state.epoch, cfg.train.num_epochs):
        if device_sample is not None:
            log = run_train_epoch_device(cfg, state, step_fn, device_sample, steps_per_epoch,
                                         epoch)
        elif sampler is not None:
            log = run_train_epoch(cfg, state, step_fn, sampler, epoch)
        else:
            raise ValueError("no train volumes: the train store is missing or empty")
        results["train_log"] = log
        logger.info("[TRAIN]   NO.{} epoch training | loss: {:.6f}".format(
            epoch + 1, log["loss/epoch"]))
        logger.debug(f"[TRAIN]   {log}")
        tracker.log(log)
        if (epoch + 1) % cfg.train.interval_val == 0 and "val" in stores:
            with torch.no_grad():
                val_log, _ = run_eval_pass(cfg, state.net.state_dict(), stores["val"],
                                           predictor, "val", epoch)
            logger.info("[VAL]     NO.{} epoch validation | MSE: {:.6f}".format(
                epoch + 1, val_log["metric_val/MSE"]))
            tracker.log(val_log)
            saved = policy.on_validation(epoch, val_log["metric_val/MSE"], state)
            for p in saved:
                logger.info(f"[MODEL]   Checkpoint saved to: {p}")
            if policy.best_path in saved:
                tracker.set_summary("metric_val/MSE_best@epoch", epoch + 1)
                tracker.set_summary("metric_val/MSE_best", policy.best_metric)

    # reload best + final test (main.py:209-225)
    if policy.best_path is not None:
        load_train_state(policy.best_path, state)
        logger.info(f"[ACTION]  Evaluate model: {policy.best_path}")
        tracker.set_summary("path_eval_model", policy.best_path)
    results.update(state=state, best_path=policy.best_path)
    if "test" in stores:
        with torch.no_grad():
            test_log, agg = run_eval_pass(cfg, state.net.state_dict(), stores["test"],
                                          predictor, "test", pred_dir=dirs.preds)
        logger.info("[TEST]    Test | MSE: {:.6f}".format(test_log["metric_test/MSE"]))
        agg.to_csvs(dirs.metrics, cfg.exp_name)
        for k, v in test_log.items():
            tracker.set_summary(k, v)
        results["test_log"] = test_log
    tracker.finish()
    logger.info("[ACTION]  Experiment ends.")
    return results
