"""pytorch_fnet's label-free U-Net (``fnet_nn_3d``) as PyTorch modules.

The net of Ounkomol et al., Nature Methods 2018 (AllenCellModeling/
pytorch_fnet, ``fnet/nn_modules/fnet_nn_3d.py``), which RepMode
(arXiv:2212.10066) trains once a structure as its Multi-Net baseline.
``Net`` is ``net_recurse`` then ``conv_out``, a k^3 conv with bias and no BN
or ReLU. ``_Net_recurse(n_in, mult_chan, depth)`` has ``n_out = n_in *
mult_chan`` channels (``mult_chan`` at the top, 2 below it) and runs
``sub_2conv_more`` (two k^3 convs with bias, each then BN and ReLU); above
depth 0 it then runs ``conv_down`` (k2s2 conv with bias, ``bn0``, ReLU), the
recursion ``sub_u``, ``convt`` (k2s2 transposed conv with bias, ``bn1``,
ReLU), concatenates the skip first and runs ``sub_2conv_less``. The
published net fixes k = 3.

The modules and their parameters carry the published names, in torch's
layouts and registration order, so ``state_dict()`` is ``Net()``'s (184
entries and 23,280,769 parameters at mult_chan 32, depth 4) and a
pytorch_fnet state loads with ``strict=True``. Every weight and bias is
drawn as torch's default ``Conv3d`` / ``ConvTranspose3d`` init draws it,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), from ``generator``.

Activations are NDHWC, as everywhere in the port, and the convs take the
routes of ``models/unet.py`` (``_conv_bn_relu``, ``_resample_bn_relu``,
``_conv``): cuDNN through ``conv3d_same_autograd`` wherever autograd may
record; in eval mode under ``torch.no_grad()`` K1, with the bias, the BN
after it and the ReLU in its epilogue; the resamples are
``downsample2x_conv`` and ``upsample2x_convt`` with the bias added after
(served, folded into BN's shift).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.models.repmode import _DTYPES, torch_uniform_init
from repmode_tpu_torch.models.unet import _conv, _conv_bn_relu, _resample_bn_relu
from repmode_tpu_torch.ops.conv3d import downsample2x_conv, upsample2x_convt

KERNEL_SIZE = 3


class _Conv(nn.Module):
    """A conv's ``weight`` of ``shape`` and its ``bias`` of ``channels``,
    both U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, shape: Sequence[int], channels: int, fan_in: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = nn.Parameter(torch_uniform_init(shape, fan_in, generator))
        self.bias = nn.Parameter(torch_uniform_init((channels,), fan_in, generator))


def _same(n_in: int, n_out: int, g) -> _Conv:
    k = KERNEL_SIZE
    return _Conv((n_out, n_in, k, k, k), n_out, n_in * k**3, g)


def _batch_norm(c: int, cfg: ModelConfig) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=cfg.bn_eps, momentum=cfg.bn_momentum)


class SubNet2Conv(nn.Module):
    """Two k^3 'same' convs with bias, each then BN and ReLU."""

    def __init__(self, n_in: int, n_out: int, cfg: ModelConfig, cdt, g):
        super().__init__()
        self.cdt = cdt
        self.conv1 = _same(n_in, n_out, g)
        self.bn1 = _batch_norm(n_out, cfg)
        self.conv2 = _same(n_out, n_out, g)
        self.bn2 = _batch_norm(n_out, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = _conv_bn_relu(x, conv.weight.permute(2, 3, 4, 1, 0), self.cdt, self.training, bn,
                              conv.bias)
        return x


class _NetRecurse(nn.Module):
    """One level of the U-Net and, above depth 0, the levels below it."""

    def __init__(self, n_in: int, mult_chan: int, depth: int, cfg: ModelConfig, cdt, g):
        super().__init__()
        self.depth, self.cdt = depth, cdt
        n_out = n_in * mult_chan
        self.sub_2conv_more = SubNet2Conv(n_in, n_out, cfg, cdt, g)
        if depth > 0:
            self.sub_2conv_less = SubNet2Conv(2 * n_out, n_out, cfg, cdt, g)
            self.conv_down = _Conv((n_out, n_out, 2, 2, 2), n_out, n_out * 8, g)
            self.bn0 = _batch_norm(n_out, cfg)
            # a transposed conv's weight (Ci, Co, 2, 2, 2), fan_in Co * 8
            self.convt = _Conv((2 * n_out, n_out, 2, 2, 2), n_out, n_out * 8, g)
            self.bn1 = _batch_norm(n_out, cfg)
            self.sub_u = _NetRecurse(n_out, 2, depth - 1, cfg, cdt, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        more = self.sub_2conv_more(x)
        if self.depth == 0:
            return more
        cdt = self.cdt
        down = downsample2x_conv(more, self.conv_down.weight.permute(2, 3, 4, 1, 0),
                                 compute_dtype=cdt)
        h = self.sub_u(_resample_bn_relu(down, self.conv_down.bias, self.bn0, cdt, self.training))
        up = upsample2x_convt(h, self.convt.weight.permute(2, 3, 4, 0, 1), compute_dtype=cdt)
        up = _resample_bn_relu(up, self.convt.bias, self.bn1, cdt, self.training)
        return self.sub_2conv_less(torch.cat([more, up.to(more.dtype)], dim=-1))


class FNet3D(nn.Module):
    """pytorch_fnet's ``Net``: ``forward(x, task_id=None)``, x (N,D,H,W,Cin)
    -> (N,D,H,W,Cout) fp32 (fp64 for an fp64 net); the task is ignored
    (``num_tasks`` is kept for the registry's uniform interface)."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_tasks: int = 0,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = "cuda",
    ):
        super().__init__()
        if cfg.kernel_size != KERNEL_SIZE:
            raise ValueError(f"fnet_nn_3d's convs are {KERNEL_SIZE}^3, as the published Net "
                             f"fixes them; got kernel_size {cfg.kernel_size}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype}")
        self.compute_dtype = _DTYPES[compute_dtype]
        self.cfg, self.num_tasks = cfg, num_tasks
        self.net_recurse = _NetRecurse(cfg.in_channels, cfg.mult_chan, cfg.depth, cfg,
                                       self.compute_dtype, generator)
        self.conv_out = _same(cfg.in_channels * cfg.mult_chan, cfg.out_channels, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, task_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        del task_id
        return _conv(self.net_recurse(x), self.conv_out.weight.permute(2, 3, 4, 1, 0),
                     self.compute_dtype, self.training, self.conv_out.bias)
