"""Eval-only entry point (reference eval.py), on the CUDA card.

    python -m repmode_tpu_torch.cli.evaluate --torch_checkpoint model_best.p \\
        --path_load_dataset data/all_data --path_exp_dir exps/torch_eval

Loads a reference ``.p`` checkpoint into the net of ``--nn_module``
(``RepModeNet`` or ``UNet3D``, strict names), re-parameterizes a RepMode net
once per task (a UNet serves as it is) and runs the tiled test pass,
writing the comp_/spec_/final_ metric CSVs and, when asked, the test
predictions as TIFFs. The datasets come as ``cli.train`` builds them
(synthetic, saved manifests, else CZI ingest). ``--device cpu`` runs on the
CPU; without it and without a card the run raises. ``--num_devices N`` runs
N ranks, as the JAX entry point's mesh does: the tiled predictor becomes the
sharded two_phase one (each rank predicts its block of patch batches) and
rank 0 writes the logs, CSVs and TIFFs.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from repmode_tpu_torch.cli.args import build_parser, launch_ranks, to_config
from repmode_tpu_torch.cli.train import build_stores
from repmode_tpu_torch.ckpt.checkpoint import ORBAX_CONVERTER
from repmode_tpu_torch.compat.weights import load_reference_checkpoint
from repmode_tpu_torch.device import resolve_device
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models import build_model
from repmode_tpu_torch.parallel.mesh import make_mesh
from repmode_tpu_torch.train.loop import ExperimentDirs, run_eval_pass
from repmode_tpu_torch.utils.logging import rank_logger, setup_logger
from repmode_tpu_torch.utils.tracking import Tracker

# flags of the JAX entry point whose features the port does not have yet
_NOT_PORTED = {
    "path_load_model": "the port reads no Orbax checkpoint (--path_load_model): convert it "
                       f"where JAX and Orbax are installed with '{ORBAX_CONVERTER}' and "
                       "pass the .p with --torch_checkpoint",
}


def main(argv=None):
    parser = build_parser(eval_only=True)
    parser.add_argument("--torch_checkpoint", type=str, default=None,
                        help="a reference PyTorch .p checkpoint")
    ns = parser.parse_args(argv)
    for flag, msg in _NOT_PORTED.items():
        if getattr(ns, flag):
            raise NotImplementedError(msg)
    if not ns.torch_checkpoint:
        parser.error("no checkpoint source: pass --torch_checkpoint <reference .p file>")
    if ns.num_devices > 1:
        return launch_ranks(_evaluate, ns)
    return _evaluate(ns)


def _evaluate(ns):
    t0 = time.time()
    cfg = to_config(ns)
    mesh = None
    pred_mode = cfg.eval.predictor
    if ns.num_devices > 1:
        mesh = make_mesh(ns.num_devices, ns.device)
        device = mesh.device
        pred_mode = "two_phase"
    else:
        device = resolve_device(ns.device)
    main_rank = mesh is None or mesh.is_main

    loaded = load_reference_checkpoint(ns.torch_checkpoint)
    if loaded["adopted_datasets"]:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, adopted_datasets=tuple(loaded["adopted_datasets"])))

    dirs = ExperimentDirs(cfg)
    if main_rank:
        logger = setup_logger(dirs.logs, cfg.exp_name)
        tracker = Tracker(dirs.logs, run_name=cfg.run_name, config=json.loads(cfg.to_json()),
                          offline=cfg.debugging, run_id=ns.id, entry_point="evaluate")
    else:  # rank 0 alone writes
        logger, tracker = rank_logger(mesh.rank), None
    logger.info("[CONFIG]  eval.s2d=False: the native route; the space-to-depth route "
                "does 1.44x its arithmetic on this card")
    if mesh is not None:
        logger.info(f"[EVAL]    DP mesh over {mesh.size} devices: predictor "
                    f"{cfg.eval.predictor} -> two_phase (patch grid sharded over all devices)")

    net = build_model(cfg, device=device)
    net.load_state_dict(loaded["state_dict"], strict=True)
    net.eval()
    logger.info(f"[MODEL]   Imported torch checkpoint: {ns.torch_checkpoint}")

    stores = build_stores(cfg, logger, synthetic=ns.synthetic)
    predictor = TiledPredictor(cfg, device=device, mode=pred_mode, mesh=mesh)
    with torch.no_grad():
        test_log, agg = run_eval_pass(cfg, net.state_dict(), stores["test"], predictor, "test",
                                      pred_dir=dirs.preds if main_rank else None)
    logger.info("[TEST]    Test | MSE: {:.6f}".format(test_log["metric_test/MSE"]))
    if main_rank:
        agg.to_csvs(dirs.metrics, cfg.exp_name)
        for k, v in test_log.items():
            tracker.set_summary(k, v)
        tracker.finish()
    logger.info("[TIME]    Elapsed time: {:.1f} s".format(time.time() - t0))
    return test_log


if __name__ == "__main__":
    main()
