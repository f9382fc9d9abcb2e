"""The plain reference of RepMode.

Written from the published description (Zhou et al., CVPR 2023,
arXiv:2212.10066; Correr-Zhou/RepMode ``fnet/nn_modules/RepMode.py``) in
plain PyTorch, NCDHW, with no kernel, no merge and no cache:

- a MoDE conv is the gated sum of its five experts, each run as its own conv
  (5^3, 3^3 and 1^3 convs, and the 3^3 and 5^3 average pools, zero-padded and
  divided by k^3, each followed by a 1^3 conv), the gate a linear map of the
  task's one-hot, softmaxed over the experts, then BN and ReLU (none on the
  final conv); k2s2 conv + BN + ReLU down, k2s2 transposed conv + BN +
  ReLU up, the skip concatenated first.

``convs`` is the FLOP model of ``repmode_tpu_torch/utils/flops.py`` (itself
JAX's): the re-parameterized net, one k^3 conv a MoDE conv, the gate and
merge left out.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference.nets import Conv, Entry, State
from benchmark.reference.precision import Precision
from benchmark.reference.unet import bn_relu, bn_spec, chans, conv, convt, levels, sub

EXPERTS = ("expert_conv5x5_conv", "expert_conv3x3_conv", "expert_conv1x1_conv",
           "expert_avg3x3_conv", "expert_avg5x5_conv")

# a 5^3 expert, whose gradient the per-sample weight-gradient kernel K4 computes
FAULT_LEAF = "encoder_block2.conv_more.conv2.expert_conv5x5_conv"


def _mode_conv(prefix: str, ci: int, co: int, tasks: int, experts: int, final: bool) -> List[Entry]:
    out = [Entry(f"{prefix}.expert_conv5x5_conv", (co, ci, 5, 5, 5), "uniform", ci * 125),
           Entry(f"{prefix}.expert_conv3x3_conv", (co, ci, 3, 3, 3), "uniform", ci * 27),
           Entry(f"{prefix}.expert_conv1x1_conv", (co, ci, 1, 1, 1), "uniform", ci),
           Entry(f"{prefix}.expert_avg3x3_conv", (co, ci, 1, 1, 1), "uniform", ci),
           Entry(f"{prefix}.expert_avg5x5_conv", (co, ci, 1, 1, 1), "uniform", ci),
           Entry(f"{prefix}.expert_avg3x3_pool", (3, 3, 3), "fill", 1.0 / 27.0),
           Entry(f"{prefix}.expert_avg5x5_pool", (5, 5, 5), "fill", 1.0 / 125.0)]
    if not final:
        out += bn_spec(f"{prefix}.subsequent_layer.0", co)
    out += [Entry(f"{prefix}.gate.weight", (experts * co, tasks), "uniform", tasks),
            Entry(f"{prefix}.gate.bias", (experts * co,), "uniform", tasks)]
    return out


def spec(cfg: dict) -> List[Entry]:
    """Every state entry of the net."""
    ch, depth = chans(cfg), cfg["depth"]
    t, e = cfg["num_tasks"], cfg.get("num_experts", 5)
    out: List[Entry] = []
    mc = lambda p, ci, co, final=False: _mode_conv(p, ci, co, t, e, final)  # noqa: E731
    cin = cfg["in_channels"]
    for i in range(1, depth + 1):
        c = ch[i - 1]
        out += mc(f"encoder_block{i}.conv_more.conv1", cin, c)
        out += mc(f"encoder_block{i}.conv_more.conv2", c, c)
        out.append(Entry(f"encoder_block{i}.conv_down.0.weight", (c, c, 2, 2, 2), "uniform", c * 8))
        out += bn_spec(f"encoder_block{i}.conv_down.1", c)
        cin = c
    out += mc("bottle_block.conv1", ch[depth - 1], ch[depth])
    out += mc("bottle_block.conv2", ch[depth], ch[depth])
    for i in range(depth, 0, -1):
        out.append(Entry(f"decoder_block{i}.convt.0.weight", (ch[i], ch[i - 1], 2, 2, 2),
                         "uniform", ch[i - 1] * 8))
        out += bn_spec(f"decoder_block{i}.convt.1", ch[i - 1])
        out += mc(f"decoder_block{i}.conv_less.conv1", ch[i], ch[i - 1])
        out += mc(f"decoder_block{i}.conv_less.conv2", ch[i - 1], ch[i - 1])
    out += mc("conv_out", ch[0], cfg["out_channels"], final=True)
    return out


def _avg_pool(x, k: int):
    """k^3 mean over a zero-padded window, stride 1 (the padding counts)."""
    return F.avg_pool3d(F.pad(x, (k // 2,) * 6), k, stride=1)


def mode_conv(x, p: State, onehot, prec: Precision, train, final: bool = False):
    """One MoDE conv: the gated sum of the five expert convs, then BN + ReLU."""
    co = p["expert_conv5x5_conv"].shape[0]
    logits = onehot.to(p["gate.weight"].dtype) @ p["gate.weight"].T + p["gate.bias"]
    g = torch.softmax(logits.reshape(logits.shape[0], 5, co), dim=1)   # (N, E, Co)
    inputs = (x, x, x, _avg_pool(x, 3), _avg_pool(x, 5))
    out = None
    for e, (name, xi) in enumerate(zip(EXPERTS, inputs)):
        w = p[name]
        y = conv(xi, w, prec, padding=w.shape[-1] // 2) * g[:, e, :, None, None, None]
        out = y if out is None else out + y
    if final:
        return out
    return bn_relu(out, sub(p, "subsequent_layer.0"), train)


def forward(state: State, x, task, cfg: dict, prec: Precision, train):
    """x (N,1,D,H,W) fp32, task (N,) int -> (N,1,D,H,W)."""
    onehot = F.one_hot(task.long(), cfg["num_tasks"])
    depth = cfg["depth"]
    skips = []
    h = x
    for i in range(1, depth + 1):
        pre = f"encoder_block{i}"
        h = mode_conv(h, sub(state, f"{pre}.conv_more.conv1"), onehot, prec, train)
        h = mode_conv(h, sub(state, f"{pre}.conv_more.conv2"), onehot, prec, train)
        skips.append(h)
        h = conv(h, state[f"{pre}.conv_down.0.weight"], prec, stride=2)
        h = bn_relu(h, sub(state, f"{pre}.conv_down.1"), train)
    h = mode_conv(h, sub(state, "bottle_block.conv1"), onehot, prec, train)
    h = mode_conv(h, sub(state, "bottle_block.conv2"), onehot, prec, train)
    for i in range(depth, 0, -1):
        pre = f"decoder_block{i}"
        h = convt(h, state[f"{pre}.convt.0.weight"], prec)
        h = bn_relu(h, sub(state, f"{pre}.convt.1"), train)
        h = torch.cat([skips[i - 1], h], dim=1)
        h = mode_conv(h, sub(state, f"{pre}.conv_less.conv1"), onehot, prec, train)
        h = mode_conv(h, sub(state, f"{pre}.conv_less.conv2"), onehot, prec, train)
    return mode_conv(h, sub(state, "conv_out"), onehot, prec, train, final=True)


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
