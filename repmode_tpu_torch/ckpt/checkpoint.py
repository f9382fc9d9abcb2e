"""Checkpoints in the reference ``.p`` layout, and the checkpoint policy.

The port of ``repmode_tpu/ckpt/checkpoint.py``. Where the JAX package writes
Orbax directories, the port writes what the reference's Model.save_state
writes (fnet_model.py:57-65): one ``torch.save`` of

    {"nn_module", "opts", "nn_state", "optimizer_state", "count_iter", "count_epoch"}

with ``nn_state`` the reference-named ``state_dict`` and ``optimizer_state``
``torch.optim.Adam.state_dict()``. So a port checkpoint loads in
``cli.evaluate --torch_checkpoint`` and in the JAX package's
``load_torch_checkpoint``. Orbax directories are not read: the port cannot
import JAX; ``convert_orbax_checkpoint.py`` at the repo's root turns one into
a ``.p`` where JAX and Orbax are installed. The policy is the reference's:
scheduled checkpoints plus a rolling best on validation MSE
(main.py:183-198).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from repmode_tpu_torch.compat.weights import load_reference_checkpoint
from repmode_tpu_torch.config import Config, expanded_checkpoint_epochs
from repmode_tpu_torch.train.state import TrainState

# the command that turns an Orbax checkpoint into a .p (run where JAX is installed)
ORBAX_CONVERTER = "python convert_orbax_checkpoint.py <orbax checkpoint dir> <out.p>"


def save_checkpoint(path: str, state: TrainState, cfg: Config) -> None:
    """Write the train state as a reference ``.p`` file. ``opts`` carries the
    task list (what the reference's loaders read) and the port's config."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    opts = argparse.Namespace(adopted_datasets=list(cfg.data.adopted_datasets),
                              config_json=cfg.to_json())
    torch.save({
        "nn_module": cfg.model.name,
        "opts": opts,
        "nn_state": {k: v.detach().cpu() for k, v in state.net.state_dict().items()},
        "optimizer_state": state.optimizer.state_dict(),
        "count_iter": state.step,
        "count_epoch": state.epoch,
    }, path)


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Resume ``state`` in place from a ``.p`` checkpoint: weights and BN
    stats (strict names), the optimizer's moments and step, the counters.
    A directory (an Orbax checkpoint of the JAX package) raises."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an Orbax checkpoint of the JAX package), which the port "
            f"does not read: convert it where JAX and Orbax are installed with "
            f"'{ORBAX_CONVERTER}' and resume from the .p"
        )
    loaded = load_reference_checkpoint(path)
    state.net.load_state_dict(loaded["state_dict"], strict=True)
    if loaded["optimizer_state"]:
        state.optimizer.load_state_dict(loaded["optimizer_state"])
    state.step = int(loaded["count_iter"])
    state.epoch = int(loaded["count_epoch"])
    return state


class CheckpointPolicy:
    """Scheduled + best-on-val-MSE checkpointing (main.py:183-198)."""

    def __init__(self, cfg: Config, checkpoint_dir: str):
        self.cfg = cfg
        self.dir = checkpoint_dir
        self.scheduled = set(expanded_checkpoint_epochs(cfg))
        self.best_metric = float(np.inf)
        self.best_path: Optional[str] = None

    def on_validation(self, epoch: int, val_mse: float, state: TrainState) -> List[str]:
        """Called after each validation pass; returns the paths written."""
        saved = []
        exp = self.cfg.exp_name
        if (epoch + 1) in self.scheduled:
            p = os.path.join(self.dir, f"model_{exp}_{epoch + 1:04d}.p")
            save_checkpoint(p, state, self.cfg)
            saved.append(p)
        if val_mse < self.best_metric:
            self.best_metric = val_mse
            p = os.path.join(self.dir, f"model_best_{exp}.p")
            save_checkpoint(p, state, self.cfg)
            self.best_path = p
            saved.append(p)
        return saved
