"""The plain reference the benchmark holds the program to.

Plain PyTorch in float32 with TF32 off (``precision.exact``): the nets
(``nets.py``, ``models/``), the whole-volume prediction (``tiling.py``) and,
here, the training step with Adam. It imports nothing of the program and takes nothing
the program made: the benchmark gives it the same seeded weights and inputs
it gave the program, and it works out again what the program derived from
them (the expert sums, BN, the tiling and the stitch, the gradients and
Adam's update).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import nets, tiling
from benchmark.reference.precision import BF16, FP32, Precision, exact


@torch.no_grad()
def record_bn_statistics(state: nets.State, patches: torch.Tensor, task: torch.Tensor,
                         cfg: dict) -> None:
    """Write the batch statistics of a train-mode forward on ``patches``
    (N,1,D,H,W) into ``state``'s BN running statistics, as a trained net's
    statistics follow its activations."""
    with exact():
        nets.forward(state, patches, task, cfg, FP32, train="record")


def predict_volume(state: nets.State, volume: torch.Tensor, task: int, cfg: dict, traffic: dict,
                   prec: Precision = FP32) -> torch.Tensor:
    """The eval-mode net's stitched prediction of one (D,H,W) volume."""
    task_ids = torch.full((traffic["batch_size_eval"],), task, dtype=torch.long,
                          device=volume.device)

    def forward(patches):
        return nets.forward(state, patches, task_ids[:patches.shape[0]], cfg, prec, train=False)

    with exact():
        return tiling.predict_volume(forward, volume, traffic["patch_size"], traffic["overlap"],
                                     traffic["batch_size_eval"])


@torch.no_grad()
def train_output(state: nets.State, batch: Dict[str, np.ndarray], cfg: dict,
                 prec: Precision = BF16) -> torch.Tensor:
    """The train-mode forward's output (NDHWC, on the host) on one batch."""
    dev = next(iter(state.values())).device
    x = torch.from_numpy(batch["signal"]).to(dev).permute(0, 4, 1, 2, 3)
    task = torch.from_numpy(batch["task"]).to(dev)
    with exact():
        out = nets.forward(state, x, task, cfg, prec, train=True)
    return out.permute(0, 2, 3, 4, 1).cpu()


def train_steps(state: nets.State, batches: Sequence[Dict[str, np.ndarray]], cfg: dict,
                prec: Precision = FP32) -> dict:
    """Train-mode steps from ``state`` on ``batches`` (NDHWC numpy, as the
    program's sampler gives them): loss = mean squared error over every
    element, backward, then Adam (betas 0.9 / 0.999, eps 1e-8, the config's
    lr, bias-corrected). Returns each step's loss, each parameter's gradient
    norm at the first step and its change's norm after the last."""
    dev = next(iter(state.values())).device
    names = nets.parameter_names(cfg)
    params = {n: state[n].detach().clone().requires_grad_(True) for n in names}
    start = {n: p.detach().clone() for n, p in params.items()}
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    lr, b1, b2, eps = cfg["lr"], 0.9, 0.999, 1e-8
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    out1 = None
    with exact():
        for t, batch in enumerate(batches, start=1):
            x = torch.from_numpy(batch["signal"]).to(dev).permute(0, 4, 1, 2, 3)
            y = torch.from_numpy(batch["target"]).to(dev).permute(0, 4, 1, 2, 3)
            task = torch.from_numpy(batch["task"]).to(dev)
            full = {**state, **params}
            out = nets.forward(full, x, task, cfg, prec, train=True)
            loss = torch.mean((out - y) ** 2)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            losses.append(float(loss.detach()))
            if t == 1:
                out1 = out.detach().permute(0, 2, 3, 4, 1).cpu()
            del out, loss
            with torch.no_grad():
                for n, g in zip(names, grads):
                    if t == 1:
                        grad1[n] = float(torch.linalg.vector_norm(g.double()))
                    m, v = moments[n]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    step = lr / (1 - b1 ** t)
                    denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
                    params[n].addcdiv_(m, denom, value=-step)
            del grads
    delta = {n: float(torch.linalg.vector_norm((params[n].detach() - start[n]).double()))
             for n in names}
    return {"losses": losses, "out1": out1, "grad1": grad1, "delta": delta}
