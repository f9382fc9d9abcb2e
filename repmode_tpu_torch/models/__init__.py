"""The model registry (the port of ``repmode_tpu/models/__init__.py``).

Models register under a string name; ``build_model(cfg)`` builds the one
``cfg.model.name`` names, so a checkpoint's ``nn_module`` identifies its
architecture (the reference's importlib-by-name loading, fnet_model.py:52).
Registered: "RepMode" (the MoDE U-Net), "UNet" (the plain baseline) and
"fnet_nn_3d" (pytorch_fnet's label-free U-Net, RepMode's Multi-Net baseline,
under pytorch_fnet's ``nn_module`` name). A model whose published module
fixes its kernel size registers it; ``kernel_size_of`` gives it to the CLI.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repmode_tpu_torch.config import Config, ModelConfig
from repmode_tpu_torch.device import DeviceLike

_REGISTRY: Dict[str, Callable] = {}
_KERNEL_SIZE: Dict[str, int] = {}


def register_model(name: str, kernel_size: Optional[int] = None):
    def deco(fn):
        _REGISTRY[name] = fn
        if kernel_size is not None:
            _KERNEL_SIZE[name] = kernel_size
        return fn

    return deco


def kernel_size_of(name: str) -> int:
    """The kernel size of model ``name``: the one its published module
    fixes, else ``ModelConfig``'s."""
    return _KERNEL_SIZE.get(name, ModelConfig.kernel_size)


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


from repmode_tpu_torch.models.fnet import KERNEL_SIZE as _FNET_K, FNet3D  # noqa: E402
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


@register_model("fnet_nn_3d", kernel_size=_FNET_K)
def _build_fnet(cfg: Config, generator, device) -> FNet3D:
    return FNet3D(cfg.model, cfg.num_tasks, compute_dtype=cfg.train.compute_dtype,
                  generator=generator, device=device)


__all__ = ["register_model", "build_model", "available_models", "kernel_size_of", "RepModeNet",
           "UNet3D", "FNet3D"]
