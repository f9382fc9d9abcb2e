"""CLI argument parsing -> Config (the port's copy of ``repmode_tpu.cli.args``).

The reference flag surface (config.py:4-82) plus the JAX package's additions
(--num_devices, --compute_dtype, --synthetic, ...) and the port's --device.
``to_config`` sets ``eval.s2d=False``: on an H100 the space-to-depth
route does 1.44x the native route's arithmetic (structured zeros), so the
CLI serves native. It sets ``model.train_s2d=False`` too, so the CLI keeps
training in the native layout: no benchmark cell compares the two training
routes yet (ROADMAP A12). The s2d routes are reached through a ``Config``
(``model.train_s2d``, ``eval.s2d``, ``eval.pallas_conv``,
``eval.predictor``), as in the JAX package; there is no flag.

``--num_devices N`` > 1 runs N data-parallel ranks (``launch_ranks``): one
card a rank over NCCL under ``--device cuda``, or N gloo ranks on the CPU
under ``--device cpu``.

The kernel size is the one ``--nn_module``'s published module fixes
(``models.kernel_size_of``: 3 for ``fnet_nn_3d``, else ``ModelConfig``'s
5); the reference CLI has no flag for it.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import torch

from repmode_tpu_torch.config import (
    Config,
    DataConfig,
    DEFAULT_DATASETS,
    EvalConfig,
    ModelConfig,
    TrainConfig,
)
from repmode_tpu_torch.models import kernel_size_of
from repmode_tpu_torch.parallel.mesh import launch


def build_parser(eval_only: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="repmode_tpu_torch — RepMode SSP on a CUDA card"
    )
    # dataset (config.py:9-28)
    p.add_argument("--adopted_datasets", nargs="+", default=list(DEFAULT_DATASETS))
    # training (config.py:31-35)
    p.add_argument("--nn_module", default="RepMode")
    p.add_argument("--num_epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--batch_size_eval", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    # paths (config.py:38-43)
    p.add_argument("--path_exp_dir", type=str, default=None)
    p.add_argument("--path_dataset_csv", type=str, default="data/csvs")
    p.add_argument("--path_dataset_czi", type=str, default="data")
    p.add_argument("--path_load_dataset", type=str, default=None)
    p.add_argument("--path_save_dataset", type=str, default=None)
    p.add_argument("--path_load_model", type=str, default=None)
    # device & seed (config.py:46-48)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel devices (replaces --gpu_ids): N > 1 runs N ranks, "
                        "one card each over NCCL (--device cuda) or on the CPU over gloo "
                        "(--device cpu)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="conv compute dtype (bf16 = AMP-equivalent; the CUDA "
                        "kernels compute in bf16 only)")
    # state flags (config.py:51-54)
    p.add_argument("--debugging", action="store_true")
    p.add_argument("--save_test_preds", action="store_true")
    p.add_argument("--save_test_signals_and_targets", action="store_true")
    p.add_argument("--monitor_model", action="store_true")
    # checkpoint cadence (config.py:57-58)
    p.add_argument("--epoch_checkpoint", nargs="+", type=int, default=[])
    p.add_argument("--interval_checkpoint", type=int, default=None)
    # val (config.py:61)
    p.add_argument("--interval_val", type=int, default=20)
    # logging (config.py:64-80)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--tags", nargs="+", type=str, default=[])
    p.add_argument("--id", type=str, default=None)
    # the JAX package's extras
    p.add_argument("--synthetic", action="store_true",
                   help="run on procedurally generated data (no CZI corpus)")
    p.add_argument("--mult_chan", type=int, default=32)
    p.add_argument("--on_device_pipeline", choices=["auto", "on", "off"],
                   default="auto",
                   help="patch pipeline: 'on' samples on the card from a bank of the "
                        "train volumes in device memory, 'off' runs the host sampler "
                        "(exact reference batching incl. ragged tails), 'auto' takes "
                        "the bank when its padded size fits the 4 GiB budget")
    p.add_argument("--train_impl", default="auto",
                   choices=["auto", "expert_sum", "merged_pallas", "merged"],
                   help="MoDE conv route of training (ModelConfig.train_impl), the JAX "
                        "package's choices: auto, merged_pallas and merged merge the experts "
                        "per sample and run the conv's forward, dx and dW through the port's "
                        "CUDA kernels K2, K3 and K4 (K6 for the s2d entry conv; their plain "
                        "versions on the CPU); expert_sum runs the five-conv sum, its convs "
                        "through F.conv3d with autograd")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def to_config(ns: argparse.Namespace, exp_name: Optional[str] = None) -> Config:
    datasets = tuple(sorted(ns.adopted_datasets))  # sort == task-id order (main.py:117)
    if exp_name is None:
        exp_name = (
            os.path.basename(ns.path_exp_dir.rstrip("/")) if ns.path_exp_dir else "exp"
        )
    return Config(
        model=ModelConfig(
            name=ns.nn_module, mult_chan=ns.mult_chan,
            kernel_size=kernel_size_of(ns.nn_module),
            train_impl=ns.train_impl, train_s2d=False,
        ),
        train=TrainConfig(
            num_epochs=ns.num_epochs,
            batch_size=ns.batch_size,
            batch_size_eval=ns.batch_size_eval,
            lr=ns.lr,
            seed=ns.seed,
            compute_dtype=ns.compute_dtype,
            interval_val=ns.interval_val,
            epoch_checkpoint=tuple(ns.epoch_checkpoint),
            interval_checkpoint=ns.interval_checkpoint,
            num_devices=ns.num_devices,
            on_device_pipeline={"auto": None, "on": True, "off": False}[
                ns.on_device_pipeline
            ],
        ),
        eval=EvalConfig(
            s2d=False,
            save_test_preds=ns.save_test_preds,
            save_test_signals_and_targets=ns.save_test_signals_and_targets,
        ),
        data=DataConfig(
            adopted_datasets=datasets,
            path_dataset_csv=ns.path_dataset_csv,
            path_dataset_czi=ns.path_dataset_czi,
            path_load_dataset=ns.path_load_dataset,
            path_save_dataset=ns.path_save_dataset,
            num_workers=ns.num_workers,
        ),
        path_exp_dir=ns.path_exp_dir,
        path_load_model=ns.path_load_model,
        exp_name=exp_name,
        run_name=ns.run_name or f"[{exp_name}] [{ns.nn_module}]",
        tags=tuple(ns.tags),
        debugging=ns.debugging,
        monitor_model=ns.monitor_model,
    )


def launch_ranks(fn: Callable, ns: argparse.Namespace):
    """``fn(ns)`` on ``--num_devices`` ranks (``parallel.launch``): rank r on
    ``cuda:r`` over NCCL, or every rank on the CPU over gloo; rank 0's
    result. Fewer cards than ranks raise, as JAX's ``make_mesh`` does."""
    dev = torch.device(ns.device)
    if dev.type == "cuda" and dev.index is not None:
        raise ValueError(f"--num_devices {ns.num_devices} runs one card a rank: pass "
                         f"--device cuda, not {ns.device}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    return launch(fn, ns.num_devices, dev, backend, args=(ns,))[0]
