"""The model registry (the port of ``repmode_tpu/models/__init__.py``).

Models register under a string name; ``build_model(cfg)`` builds the one
``cfg.model.name`` names, so a checkpoint's ``nn_module`` identifies its
architecture (the reference's importlib-by-name loading, fnet_model.py:52).
Registered: "RepMode" (the MoDE U-Net) and "UNet" (the plain baseline).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repmode_tpu_torch.config import Config
from repmode_tpu_torch.device import DeviceLike

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build_model(cfg: Config, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> torch.nn.Module:
    """The ``nn.Module`` of ``cfg.model.name``, its weights drawn from
    ``generator``, on ``device``."""
    name = cfg.model.name
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg, generator, device)


def available_models():
    return sorted(_REGISTRY)


from repmode_tpu_torch.models.repmode import RepModeNet  # noqa: E402
from repmode_tpu_torch.models.unet import UNet3D  # noqa: E402


@register_model("RepMode")
def _build_repmode(cfg: Config, generator, device) -> RepModeNet:
    return RepModeNet(cfg.model, cfg.num_tasks, compute_dtype=cfg.train.compute_dtype,
                      generator=generator, device=device)


@register_model("UNet")
def _build_unet(cfg: Config, generator, device) -> UNet3D:
    return UNet3D(cfg.model, cfg.num_tasks, compute_dtype=cfg.train.compute_dtype,
                  generator=generator, device=device)


__all__ = ["register_model", "build_model", "available_models", "RepModeNet", "UNet3D"]
