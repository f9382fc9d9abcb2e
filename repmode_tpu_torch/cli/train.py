"""Train + eval entry point (reference main.py), on the CUDA card.

    python -m repmode_tpu_torch.cli.train --path_dataset_csv data/csvs \\
        --path_dataset_czi data --path_save_dataset data/all_data \\
        --path_exp_dir exps/my_exp --save_test_preds
    python -m repmode_tpu_torch.cli.train --path_load_dataset data/all_data \\
        --path_exp_dir exps/my_exp
    python -m repmode_tpu_torch.cli.train --synthetic --num_epochs 2 --device cpu \\
        --mult_chan 2

Reads the datasets (synthetic; the manifests a previous run saved; else the
per-task CSVs and their CZI files, ingested on the host and saved under
``--path_save_dataset``), trains the MoDE net (the per-sample merged kernels
K2, K3 and K4 on the card) or, with ``--nn_module UNet`` or ``fnet_nn_3d``,
a plain U-Net baseline (its convs through cuDNN), from patches drawn on the
card out of a device bank of the train volumes or by the host sampler
(``--on_device_pipeline``), validates every ``--interval_val`` epochs through
the tiled predictor (kernel K1), keeps the best checkpoint as a reference
``.p``, reloads it, writes the test metric CSVs and, when asked, the test
predictions as TIFFs. The run record goes to ``<exp>/logs`` (``metrics.jsonl``,
``config.json``, ``code/``). ``--device cpu`` runs on the CPU; without it and
without a card the run raises. ``--num_devices N`` trains data-parallel on N
ranks (``train/loop.py``); rank 0 writes the logs, records, checkpoints and
the saved dataset.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time

import numpy as np
import torch

from repmode_tpu_torch.cli.args import build_parser, launch_ranks, to_config
from repmode_tpu_torch.data.ingest import ingest_split
from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.device import resolve_device
from repmode_tpu_torch.parallel.distributed import process_info
from repmode_tpu_torch.train.loop import ExperimentDirs, run_experiment
from repmode_tpu_torch.utils.logging import rank_logger, setup_logger
from repmode_tpu_torch.utils.tracking import Tracker


def build_stores(cfg, logger, synthetic: bool = False):
    """Train/val/test VolumeStores (reference main.py:118-120): synthetic; or
    the manifests under ``path_load_dataset`` when any split loads; else CZI
    ingest of every split, each saved under ``path_save_dataset`` when given."""
    stores = {}
    if synthetic:
        for i, split in enumerate(["train", "val", "test"]):
            stores[split] = synthetic_store(cfg.data.adopted_datasets, volumes_per_task=2,
                                            seed=cfg.train.seed + i)
            logger.info(f"[DATASET] Synthetic {split}: {len(stores[split])} volumes")
        return stores
    if cfg.data.path_load_dataset:
        for split in ["train", "val", "test"]:
            try:
                stores[split] = VolumeStore.load(cfg.data.path_load_dataset, split,
                                                 cfg.data.adopted_datasets)
            except FileNotFoundError:
                logger.info(f"[DATASET] no {split} manifest — skipped")
                continue
            logger.info(f"[DATASET] {split} loaded from {cfg.data.path_load_dataset}: "
                        f"{len(stores[split])} volumes")
        if stores:
            return stores

    # fall back to CZI ingest (reference SSPdataset slow path, SSPdataset.py:45-87)
    for split in ["train", "val", "test"]:
        stores[split] = ingest_split(cfg, split, logger)
        if cfg.data.path_save_dataset:
            stores[split].save(cfg.data.path_save_dataset, split)
            logger.info(f"[DATASET] {split} saved to {cfg.data.path_save_dataset}")
    return stores


def snapshot_sources(cfg):
    """Key source files of the port to snapshot into the run record (reference
    main.py:100-106 wandb.save of SSPdataset/fnet_model/<nn_module>/config)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(pkg, "data", "sampler.py"), os.path.join(pkg, "train", "step.py"),
             os.path.join(pkg, "config.py")]
    model_file = {"RepMode": "repmode.py", "UNet": "unet.py",
                  "fnet_nn_3d": "fnet.py"}.get(cfg.model.name)
    if model_file:
        files.insert(2, os.path.join(pkg, "models", model_file))
    return files


def main(argv=None):
    ns = build_parser().parse_args(argv)
    if ns.num_devices > 1:
        return launch_ranks(_train_rank, ns)
    return _train(ns)


def _train_rank(ns):
    """One rank of a data-parallel run; what it returns is pickled back."""
    return {k: v for k, v in _train(ns).items() if k != "state"}


def _train(ns):
    t0 = time.time()
    device = ns.device if ns.num_devices > 1 else resolve_device(ns.device)
    cfg = to_config(ns)
    # seed the host RNGs (main.py:28-32); the weights come from a generator
    # seeded in run_experiment
    random.seed(cfg.train.seed)
    np.random.seed(cfg.train.seed)
    torch.manual_seed(cfg.train.seed)
    rank = process_info()["process_index"]
    if rank != 0:
        # rank 0 alone writes: the logs, the run record, the saved dataset
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, path_save_dataset=None))
        stores = build_stores(cfg, rank_logger(rank), synthetic=ns.synthetic)
        return run_experiment(cfg, stores, device=device)

    dirs = ExperimentDirs(cfg)
    logger = setup_logger(dirs.logs, cfg.exp_name)
    logger.info("[CONFIG]  model.train_s2d=False: the native training layout; no benchmark "
                "cell compares it with the space-to-depth layout yet")
    logger.info("[ACTION]  Loading dataset ...")
    logger.info(f"[DATASET] Adopted datasets: {cfg.data.adopted_datasets}")
    tracker = Tracker(
        dirs.logs,
        run_name=cfg.run_name,
        config=json.loads(cfg.to_json()),
        tags=cfg.tags,
        offline=cfg.debugging or cfg.exp_name == "integ_dataset",
        run_id=ns.id,
        code_files=snapshot_sources(cfg),
    )
    stores = build_stores(cfg, logger, synthetic=ns.synthetic)
    logger.info("[TIME]    Elapsed time: {:.1f} s".format(time.time() - t0))
    results = run_experiment(cfg, stores, logger=logger, device=device, tracker=tracker)
    logger.info("[TIME]    Elapsed time: {:.1f} s".format(time.time() - t0))
    return results


if __name__ == "__main__":
    main()
