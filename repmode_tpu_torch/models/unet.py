"""The plain (task-agnostic) 3-D U-Net baseline as PyTorch modules.

The port of ``repmode_tpu/models/unet.py``: the paper's Multi-Net /
task-blind baseline, RepModeNet's encoder/decoder skeleton with ordinary
convs (k^3 conv, BN, ReLU, twice a level; k2s2 conv + BN + ReLU down; k2s2
transposed conv + BN + ReLU up, skip concatenated first; a final k^3 conv).
Submodules carry the JAX package's flax names (``enc{i}_conv{1,2}``,
``down{i}_w``/``down{i}_bn``, ``bottle_conv{1,2}``, ``up{i}_w``/``up{i}_bn``,
``dec{i}_conv{1,2}``, ``out_w``; the BN of a ``ConvBNReLU``, flax's
``BatchNorm3d_0``, is ``bn``), and every weight keeps the torch layout the
port's RepModeNet uses, so ``compat/weights.unet_from_jax_variables`` is a
mechanical map.

The 'same' convs take one of two routes, both the JAX package's XLA
``conv3d_same`` with its fp32 output:

  * wherever autograd may record (training mode, or grad enabled):
    ``conv3d_same_autograd`` (``F.conv3d``, cuDNN on the card). In bf16 its
    output is bf16, which is widened to fp32 before BN: one bf16 rounding
    that JAX's fp32-output conv does not make;
  * in eval mode under ``torch.no_grad()``: ``conv3d_same`` with no bias and
    no ReLU, which on the card is one launch of kernel K1 with fp32 output,
    JAX's conv exactly. BN (running statistics) and the ReLU stay torch ops.

Activations between convs are fp32, as in JAX: every conv, down- and
upsample rounds its input to the compute dtype itself.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.models.repmode import _DTYPES, _bn, torch_uniform_init
from repmode_tpu_torch.ops.conv3d import (
    conv3d_same,
    conv3d_same_autograd,
    downsample2x_conv,
    upsample2x_convt,
)


def _conv(x: torch.Tensor, w: torch.Tensor, compute_dtype: Optional[torch.dtype],
          training: bool) -> torch.Tensor:
    """'same' conv of x (N,D,H,W,Ci) with w (k,k,k,Ci,Co) -> fp32 (fp64 stays fp64)."""
    if not training and not torch.is_grad_enabled():
        return conv3d_same(x, w, compute_dtype=compute_dtype)
    y = conv3d_same_autograd(x, w, compute_dtype=compute_dtype)
    return y.to(torch.promote_types(y.dtype, torch.float32))


class ConvBNReLU(nn.Module):
    """k^3 'same' conv (no bias), BN, ReLU (JAX ``ConvBNReLU``)."""

    def __init__(self, in_chan: int, out_chan: int, kernel: int = 3,
                 cfg: Optional[ModelConfig] = None, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel
        self.compute_dtype = compute_dtype
        self.w = nn.Parameter(torch_uniform_init((out_chan, in_chan, k, k, k), in_chan * k**3,
                                                 generator))
        self.bn = nn.BatchNorm3d(out_chan, eps=cfg.bn_eps if cfg else 1e-5,
                                 momentum=cfg.bn_momentum if cfg else 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(x, self.w.permute(2, 3, 4, 1, 0), self.compute_dtype, self.training)
        return torch.relu(_bn(y, self.bn))


class UNet3D(nn.Module):
    """Depth-N U-Net with RepModeNet's skeleton and plain convs.

    ``forward(x, task_id=None)``: x (N,D,H,W,Cin) -> (N,D,H,W,Cout) fp32
    (fp64 for an fp64 net); the task is ignored (``num_tasks`` is kept for
    the registry's uniform interface).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        num_tasks: int = 0,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype}")
        cdt = self.compute_dtype = _DTYPES[compute_dtype]
        self.cfg, self.num_tasks = cfg, num_tasks
        c = cfg.in_channels * cfg.mult_chan
        chans = [c * 2**i for i in range(cfg.depth + 1)]
        k, g = cfg.kernel_size, generator

        def subnet(cin, cout, name):
            setattr(self, f"{name}_conv1", ConvBNReLU(cin, cout, k, cfg, cdt, g))
            setattr(self, f"{name}_conv2", ConvBNReLU(cout, cout, k, cfg, cdt, g))

        in_ch = cfg.in_channels
        for i in range(1, cfg.depth + 1):
            subnet(in_ch, chans[i - 1], f"enc{i}")
            setattr(self, f"down{i}_w", nn.Parameter(torch_uniform_init(
                (chans[i - 1], chans[i - 1], 2, 2, 2), chans[i - 1] * 8, g)))
            setattr(self, f"down{i}_bn", nn.BatchNorm3d(chans[i - 1]))
            in_ch = chans[i - 1]
        subnet(chans[cfg.depth - 1], chans[cfg.depth], "bottle")
        for i in range(cfg.depth, 0, -1):
            # a transposed conv's weight (Ci, Co, 2, 2, 2), fan_in Co * 8
            setattr(self, f"up{i}_w", nn.Parameter(torch_uniform_init(
                (chans[i], chans[i - 1], 2, 2, 2), chans[i - 1] * 8, g)))
            setattr(self, f"up{i}_bn", nn.BatchNorm3d(chans[i - 1]))
            subnet(chans[i], chans[i - 1], f"dec{i}")
        self.out_w = nn.Parameter(torch_uniform_init((cfg.out_channels, c, k, k, k), c * k**3, g))
        self.to(dev)

    def forward(self, x: torch.Tensor, task_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        del task_id
        cfg, cdt = self.cfg, self.compute_dtype

        def subnet(h, name):
            return getattr(self, f"{name}_conv2")(getattr(self, f"{name}_conv1")(h))

        skips = []
        h = x
        for i in range(1, cfg.depth + 1):
            skip = subnet(h, f"enc{i}")
            skips.append(skip)
            w_down = getattr(self, f"down{i}_w").permute(2, 3, 4, 1, 0)
            h = torch.relu(_bn(downsample2x_conv(skip, w_down, compute_dtype=cdt),
                               getattr(self, f"down{i}_bn")))
        h = subnet(h, "bottle")
        for i in range(cfg.depth, 0, -1):
            w_up = getattr(self, f"up{i}_w").permute(2, 3, 4, 0, 1)
            h = torch.relu(_bn(upsample2x_convt(h, w_up, compute_dtype=cdt),
                               getattr(self, f"up{i}_bn")))
            h = subnet(torch.cat([skips[i - 1], h.to(skips[i - 1].dtype)], dim=-1), f"dec{i}")
        return _conv(h, self.out_w.permute(2, 3, 4, 1, 0), cdt, self.training)
