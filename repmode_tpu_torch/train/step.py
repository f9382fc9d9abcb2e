"""The train step (reference do_train_iter, fnet/fnet_model.py:96-132).

The port of ``repmode_tpu/train/step.py:make_train_step``: MSE meaned over
all elements, backward, one Adam step, BN running stats updated by the
train-mode forward. Per-task losses are segment sums over the task axis
computed on the device; the step returns device tensors and never syncs the
host, which reads them once per epoch. ``make_eval_loss_step`` is the
eval-mode forward and its MSE, with no update.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repmode_tpu_torch.config import Config
from repmode_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]  # signal (N,D,H,W,C), target (N,D,H,W,C), task (N,)


def _global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.detach().float()) for t in tensors]))


def make_train_step(cfg: Config, state: TrainState) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """step(batch) -> metrics: ``loss``, ``per_task_loss_sum`` and
    ``per_task_count`` (T,), and under ``cfg.monitor_model`` ``grad_norm``
    and ``param_norm`` (after the update). Updates ``state`` in place; the
    step's gradients stay in the parameters' ``.grad`` until the next step."""
    net, opt = state.net, state.optimizer
    num_tasks = cfg.num_tasks
    params = [p for p in net.parameters() if p.requires_grad]

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        net.train()
        opt.zero_grad(set_to_none=True)
        out = net(batch["signal"], batch["task"])
        err = (out - batch["target"]) ** 2
        loss = err.mean()
        loss.backward()
        opt.step()
        with torch.no_grad():
            # per-sample mean loss (reference loss_diff, fnet_model.py:119)
            per_sample = err.detach().mean(dim=tuple(range(1, err.dim())))
            onehot = F.one_hot(batch["task"].long(), num_tasks).to(per_sample.dtype)
            metrics = {
                "loss": loss.detach(),
                "per_task_loss_sum": onehot.T @ per_sample,
                "per_task_count": onehot.sum(dim=0),
            }
            if cfg.monitor_model:
                metrics["grad_norm"] = _global_norm([p.grad for p in params if p.grad is not None])
                metrics["param_norm"] = _global_norm(params)
        state.step += 1
        return metrics

    return step


def make_eval_loss_step(cfg: Config) -> Callable[[TrainState, Batch], torch.Tensor]:
    """step(state, batch) -> the MSE of the eval-mode forward (running BN
    stats, no parameter update), a 0-d tensor on the net's device. The net is
    left in eval mode; the train step sets train mode again."""

    def step(state: TrainState, batch: Batch) -> torch.Tensor:
        state.net.eval()
        with torch.no_grad():
            out = state.net(batch["signal"], batch["task"])
            return torch.mean((out - batch["target"]) ** 2)

    return step
