"""Train + eval entry point (reference main.py), on the CUDA card.

    python -m repmode_tpu_torch.cli.train --path_load_dataset data/all_data \\
        --path_exp_dir exps/my_exp
    python -m repmode_tpu_torch.cli.train --synthetic --num_epochs 2 --device cpu \\
        --mult_chan 2

Trains the MoDE net (the per-sample merged kernels K2, K3 and K4 on the
card), validates every ``--interval_val`` epochs through the tiled predictor
(kernel K1), keeps the best checkpoint as a reference ``.p``, reloads it and
writes the test metric CSVs. ``--device cpu`` runs on the CPU; without it and
without a card the run raises.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from repmode_tpu_torch.cli.args import build_parser, to_config
from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.device import resolve_device
from repmode_tpu_torch.train.loop import ExperimentDirs, run_experiment
from repmode_tpu_torch.utils.logging import setup_logger

# flags of the JAX entry point whose features the port does not have yet
_NOT_PORTED = {
    "save_test_preds": "TIFF saving (--save_test_preds) is not ported yet",
    "save_test_signals_and_targets": "TIFF saving (--save_test_signals_and_targets) "
                                     "is not ported yet",
    "id": "the run tracker / wandb mirror (--id) is not ported yet",
    "path_save_dataset": "CZI ingest (--path_save_dataset) is not ported yet",
}


def build_stores(cfg, logger, synthetic: bool = False):
    """Train/val/test VolumeStores (reference main.py:118-120): synthetic, or
    the manifests an ingest wrote. CZI ingest is not ported."""
    stores = {}
    if synthetic:
        for i, split in enumerate(["train", "val", "test"]):
            stores[split] = synthetic_store(cfg.data.adopted_datasets, volumes_per_task=2,
                                            seed=cfg.train.seed + i)
            logger.info(f"[DATASET] Synthetic {split}: {len(stores[split])} volumes")
        return stores
    if not cfg.data.path_load_dataset:
        raise NotImplementedError(
            "CZI ingest is not ported yet: pass --path_load_dataset (an ingested "
            "dataset) or --synthetic"
        )
    for split in ["train", "val", "test"]:
        try:
            stores[split] = VolumeStore.load(cfg.data.path_load_dataset, split,
                                             cfg.data.adopted_datasets)
        except FileNotFoundError:
            logger.info(f"[DATASET] no {split} manifest — skipped")
            continue
        logger.info(f"[DATASET] {split} loaded from {cfg.data.path_load_dataset}: "
                    f"{len(stores[split])} volumes")
    return stores


def main(argv=None):
    t0 = time.time()
    ns = build_parser().parse_args(argv)
    for flag, msg in _NOT_PORTED.items():
        if getattr(ns, flag):
            raise NotImplementedError(msg)
    if ns.num_devices != 1:
        raise NotImplementedError("data-parallel training (--num_devices > 1) is not ported (A10)")
    if ns.on_device_pipeline == "on":
        raise NotImplementedError("--on_device_pipeline on: the on-device patch pipeline is "
                                  "not ported (A8)")
    device = resolve_device(ns.device)
    cfg = to_config(ns)

    # seed the host RNGs (main.py:28-32); the weights come from a generator
    # seeded in run_experiment
    random.seed(cfg.train.seed)
    np.random.seed(cfg.train.seed)
    torch.manual_seed(cfg.train.seed)

    dirs = ExperimentDirs(cfg)
    logger = setup_logger(dirs.logs, cfg.exp_name)
    logger.info("[CONFIG]  model.train_s2d=False: the native training layout; no benchmark "
                "cell compares it with the space-to-depth layout yet")
    logger.info("[ACTION]  Loading dataset ...")
    logger.info(f"[DATASET] Adopted datasets: {cfg.data.adopted_datasets}")
    stores = build_stores(cfg, logger, synthetic=ns.synthetic)
    logger.info("[TIME]    Elapsed time: {:.1f} s".format(time.time() - t0))
    results = run_experiment(cfg, stores, logger=logger, device=device)
    logger.info("[TIME]    Elapsed time: {:.1f} s".format(time.time() - t0))
    return results


if __name__ == "__main__":
    main()
