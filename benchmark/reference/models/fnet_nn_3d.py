"""The plain reference of pytorch_fnet's label-free U-Net, ``fnet_nn_3d``.

Written from the published code (Ounkomol et al., Nature Methods 2018;
AllenCellModeling/pytorch_fnet ``fnet/nn_modules/fnet_nn_3d.py``, RepMode's
Multi-Net baseline, arXiv:2212.10066) in plain PyTorch, NCDHW: ``Net`` is
``net_recurse`` then ``conv_out`` (a 3^3 conv with bias, no BN or ReLU);
``_Net_recurse(n_in, mult_chan, depth)`` has ``n_out = n_in * mult_chan``
channels (``mult_chan`` at the top, 2 below it) and runs ``sub_2conv_more``
(two 3^3 convs with bias, each then BN and ReLU); above depth 0 it then runs
``conv_down`` (k2s2 conv with bias, ``bn0``, ReLU), the recursion
``sub_u``, ``convt`` (k2s2 transposed conv with bias, ``bn1``, ReLU),
concatenates the skip first and runs ``sub_2conv_less``. The task is
ignored: the deployment holds one such net a structure.

``spec`` lists the state in ``Net().state_dict()``'s order, every conv's
weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as torch's default init
draws them. Each bias is added after ``Precision.conv``, in float32.
``convs`` is the U-Net's conv list at 3^3 taps (the biases' adds are not
counted).
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.reference.nets import Conv, Entry, State
from benchmark.reference.precision import Precision
from benchmark.reference.unet import bn_relu, bn_spec, conv, convt, levels, sub

# a level-2 weight, whose gradient cuDNN's wgrad computes
FAULT_LEAF = "net_recurse.sub_u.sub_2conv_more.conv2.weight"


def _conv(prefix: str, shape, channels: int, fan_in: int) -> List[Entry]:
    return [Entry(f"{prefix}.weight", tuple(shape), "uniform", fan_in),
            Entry(f"{prefix}.bias", (channels,), "uniform", fan_in)]


def _same(prefix: str, ci: int, co: int, k: int) -> List[Entry]:
    return _conv(prefix, (co, ci, k, k, k), co, ci * k ** 3)


def _subnet(prefix: str, n_in: int, n_out: int, k: int) -> List[Entry]:
    return (_same(f"{prefix}.conv1", n_in, n_out, k) + bn_spec(f"{prefix}.bn1", n_out)
            + _same(f"{prefix}.conv2", n_out, n_out, k) + bn_spec(f"{prefix}.bn2", n_out))


def _level(prefix: str, n_in: int, mult: int, depth: int, k: int) -> List[Entry]:
    n_out = n_in * mult
    out = _subnet(f"{prefix}.sub_2conv_more", n_in, n_out, k)
    if depth > 0:
        out += _subnet(f"{prefix}.sub_2conv_less", 2 * n_out, n_out, k)
        out += _conv(f"{prefix}.conv_down", (n_out, n_out, 2, 2, 2), n_out, n_out * 8)
        out += bn_spec(f"{prefix}.bn0", n_out)
        # a transposed conv's weight (Ci, Co, 2, 2, 2), fan_in Co * 8
        out += _conv(f"{prefix}.convt", (2 * n_out, n_out, 2, 2, 2), n_out, n_out * 8)
        out += bn_spec(f"{prefix}.bn1", n_out)
        out += _level(f"{prefix}.sub_u", n_out, 2, depth - 1, k)
    return out


def spec(cfg: dict) -> List[Entry]:
    """Every state entry of the net, in the published ``state_dict`` order."""
    k, cin = cfg["kernel_size"], cfg["in_channels"]
    return (_level("net_recurse", cin, cfg["mult_chan"], cfg["depth"], k)
            + _same("conv_out", cin * cfg["mult_chan"], cfg["out_channels"], k))


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b[None, :, None, None, None]


def _same_conv(x, p: State, prec: Precision):
    w = p["weight"]
    return conv(x, w, prec, padding=w.shape[-1] // 2) + _bias(p["bias"])


def _run_subnet(x, p: State, prec: Precision, train):
    x = bn_relu(_same_conv(x, sub(p, "conv1"), prec), sub(p, "bn1"), train)
    return bn_relu(_same_conv(x, sub(p, "conv2"), prec), sub(p, "bn2"), train)


def _run_level(x, p: State, depth: int, prec: Precision, train):
    more = _run_subnet(x, sub(p, "sub_2conv_more"), prec, train)
    if depth == 0:
        return more
    h = conv(more, p["conv_down.weight"], prec, stride=2) + _bias(p["conv_down.bias"])
    h = _run_level(bn_relu(h, sub(p, "bn0"), train), sub(p, "sub_u"), depth - 1, prec, train)
    h = convt(h, p["convt.weight"], prec) + _bias(p["convt.bias"])
    h = bn_relu(h, sub(p, "bn1"), train)
    return _run_subnet(torch.cat([more, h], dim=1), sub(p, "sub_2conv_less"), prec, train)


def forward(state: State, x, task, cfg: dict, prec: Precision, train):
    """x (N,1,D,H,W) fp32, task (N,) int (ignored) -> (N,1,D,H,W)."""
    h = _run_level(x, sub(state, "net_recurse"), cfg["depth"], prec, train)
    return _same_conv(h, sub(state, "conv_out"), prec)


def convs(cfg: dict, patch) -> List[Conv]:
    """Every conv of one patch's forward (batch 1), in the order the net runs
    them: two k^3 a level down, then the k2s2 conv (8 taps); two at the
    bottom; up, the k2s2 transposed conv (one tap an output voxel), then two
    k^3, the first over the skip's channels too; the final k^3 conv."""
    k3 = cfg["kernel_size"] ** 3
    ch, vox = levels(cfg, patch)
    depth = cfg["depth"]
    out, cin = [], cfg["in_channels"]
    for i in range(depth):
        out += [Conv(vox[i], cin, ch[i], k3, False), Conv(vox[i], ch[i], ch[i], k3, False),
                Conv(vox[i + 1], ch[i], ch[i], 8, False, same=False)]
        cin = ch[i]
    out += [Conv(vox[depth], ch[depth - 1], ch[depth], k3, False),
            Conv(vox[depth], ch[depth], ch[depth], k3, False)]
    for i in range(depth - 1, -1, -1):
        out += [Conv(vox[i], ch[i + 1], ch[i], 1, False, same=False),
                Conv(vox[i], 2 * ch[i], ch[i], k3, False), Conv(vox[i], ch[i], ch[i], k3, False)]
    out.append(Conv(vox[0], ch[0], cfg["out_channels"], k3, True))
    return out
