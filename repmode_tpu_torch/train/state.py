"""Train state: the net (parameters and BN running stats), Adam, counters.

The port of ``repmode_tpu/train/state.py`` (reference Model wrapper,
fnet_model.py:16-55). The JAX package ships ``flat_adam``, Adam over one
raveled fp32 buffer, element for element ``torch.optim.Adam``; the port uses
``torch.optim.Adam`` itself, as the reference does: lr from the config, betas
(0.9, 0.999), eps 1e-8, no weight decay, no scheduler, no clipping. bf16
needs no loss scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repmode_tpu_torch.config import Config
from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.models import build_model


@dataclasses.dataclass
class TrainState:
    net: torch.nn.Module  # the registry's model (RepModeNet or UNet3D)
    optimizer: torch.optim.Adam
    step: int = 0   # iteration counter (count_iter, fnet_model.py:30)
    epoch: int = 0  # epoch counter (count_epoch, fnet_model.py:31)


def make_optimizer(cfg: Config, net: torch.nn.Module) -> torch.optim.Adam:
    return torch.optim.Adam(net.parameters(), lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> TrainState:
    """A fresh net of ``cfg.model.name`` in training mode (weights drawn from
    ``generator``) and its optimizer (reference _init_model, fnet_model.py:48-55)."""
    net = build_model(cfg, generator, resolve_device(device))
    net.train()
    return TrainState(net=net, optimizer=make_optimizer(cfg, net))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.net.parameters())
