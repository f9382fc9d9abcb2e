"""The plain reference of the benchmarked net, RepMode.

Written from the published description (Zhou et al., CVPR 2023,
arXiv:2212.10066; Correr-Zhou/RepMode ``fnet/nn_modules/RepMode.py``) in
plain PyTorch, NCDHW, with no kernel, no merge and no cache:

- a MoDE conv is the gated sum of its five experts, each run as its own conv
  (5^3, 3^3 and 1^3 convs, and the 3^3 and 5^3 average pools, zero-padded and
  divided by k^3, each followed by a 1^3 conv), the gate a linear map of the
  task's one-hot, softmaxed over the experts, then BN and ReLU (none on the
  final conv); k2s2 conv + BN + ReLU down, k2s2 transposed conv + BN +
  ReLU up, the skip concatenated first.

``spec`` lists every entry of a net's state (names as the published code
names them, shapes, and the initial value's law), so the benchmark can make
the weights from a seed and hand the same tensors to the program and here.
Every conv goes through ``Precision.conv``: as it is for the reference, in
float8 for the lower-precision control (``precision.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

EXPERTS = ("expert_conv5x5_conv", "expert_conv3x3_conv", "expert_conv1x1_conv",
           "expert_avg3x3_conv", "expert_avg5x5_conv")


class Entry(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    law: str          # "uniform" (bound 1/sqrt(fan_in)), "zeros", "ones", "fill", "count"
    value: float      # fan_in for "uniform", the constant for "fill"


def _bn(prefix: str, c: int) -> List[Entry]:
    return [Entry(f"{prefix}.weight", (c,), "ones", 0.0), Entry(f"{prefix}.bias", (c,), "zeros", 0.0),
            Entry(f"{prefix}.running_mean", (c,), "zeros", 0.0),
            Entry(f"{prefix}.running_var", (c,), "ones", 0.0),
            Entry(f"{prefix}.num_batches_tracked", (), "count", 0.0)]


def _mode_conv(prefix: str, ci: int, co: int, tasks: int, experts: int, final: bool) -> List[Entry]:
    out = [Entry(f"{prefix}.expert_conv5x5_conv", (co, ci, 5, 5, 5), "uniform", ci * 125),
           Entry(f"{prefix}.expert_conv3x3_conv", (co, ci, 3, 3, 3), "uniform", ci * 27),
           Entry(f"{prefix}.expert_conv1x1_conv", (co, ci, 1, 1, 1), "uniform", ci),
           Entry(f"{prefix}.expert_avg3x3_conv", (co, ci, 1, 1, 1), "uniform", ci),
           Entry(f"{prefix}.expert_avg5x5_conv", (co, ci, 1, 1, 1), "uniform", ci),
           Entry(f"{prefix}.expert_avg3x3_pool", (3, 3, 3), "fill", 1.0 / 27.0),
           Entry(f"{prefix}.expert_avg5x5_pool", (5, 5, 5), "fill", 1.0 / 125.0)]
    if not final:
        out += _bn(f"{prefix}.subsequent_layer.0", co)
    out += [Entry(f"{prefix}.gate.weight", (experts * co, tasks), "uniform", tasks),
            Entry(f"{prefix}.gate.bias", (experts * co,), "uniform", tasks)]
    return out


def _chans(cfg: dict) -> List[int]:
    c = cfg["in_channels"] * cfg["mult_chan"]
    return [c * 2 ** i for i in range(cfg["depth"] + 1)]


def spec(cfg: dict) -> List[Entry]:
    """Every state entry of the configuration's net."""
    if cfg["model"] != "RepMode":
        raise KeyError(f"no reference for model {cfg['model']!r}")
    ch, depth = _chans(cfg), cfg["depth"]
    t, e = cfg["num_tasks"], cfg.get("num_experts", 5)
    out: List[Entry] = []
    mc = lambda p, ci, co, final=False: _mode_conv(p, ci, co, t, e, final)  # noqa: E731
    cin = cfg["in_channels"]
    for i in range(1, depth + 1):
        c = ch[i - 1]
        out += mc(f"encoder_block{i}.conv_more.conv1", cin, c)
        out += mc(f"encoder_block{i}.conv_more.conv2", c, c)
        out.append(Entry(f"encoder_block{i}.conv_down.0.weight", (c, c, 2, 2, 2), "uniform", c * 8))
        out += _bn(f"encoder_block{i}.conv_down.1", c)
        cin = c
    out += mc("bottle_block.conv1", ch[depth - 1], ch[depth])
    out += mc("bottle_block.conv2", ch[depth], ch[depth])
    for i in range(depth, 0, -1):
        out.append(Entry(f"decoder_block{i}.convt.0.weight", (ch[i], ch[i - 1], 2, 2, 2),
                         "uniform", ch[i - 1] * 8))
        out += _bn(f"decoder_block{i}.convt.1", ch[i - 1])
        out += mc(f"decoder_block{i}.conv_less.conv1", ch[i], ch[i - 1])
        out += mc(f"decoder_block{i}.conv_less.conv2", ch[i - 1], ch[i - 1])
    out += mc("conv_out", ch[0], cfg["out_channels"], final=True)
    return out


def parameter_names(cfg: dict) -> List[str]:
    """The entries that training updates (everything but BN statistics,
    counters and the fixed pool kernels)."""
    return [en.name for en in spec(cfg) if en.law == "uniform"
            or en.law in ("ones", "zeros") and en.name.endswith((".weight", ".bias"))]


State = Dict[str, torch.Tensor]


def _sub(state: State, prefix: str) -> State:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in state.items() if k.startswith(prefix + ".")}


def _conv(x, w, prec: Precision, **kw):
    return prec.conv(lambda a, b: F.conv3d(a, b, **kw), x, w)


def _convt(x, w, prec: Precision):
    return prec.conv(lambda a, b: F.conv_transpose3d(a, b, stride=2), x, w)


# True: batch statistics; False: running statistics; "record": batch
# statistics, written into the running ones (momentum 1)
def _bn_relu(x, bn: State, train, relu: bool = True):
    if train == "record":
        y = F.batch_norm(x, bn["running_mean"], bn["running_var"], bn["weight"], bn["bias"],
                         training=True, momentum=1.0, eps=1e-5)
    else:
        y = F.batch_norm(x, None if train else bn["running_mean"],
                         None if train else bn["running_var"], bn["weight"], bn["bias"],
                         training=train, eps=1e-5)
    return torch.relu(y) if relu else y


def _avg_pool(x, k: int):
    """k^3 mean over a zero-padded window, stride 1 (the padding counts)."""
    return F.avg_pool3d(F.pad(x, (k // 2,) * 6), k, stride=1)


def mode_conv(x, p: State, onehot, prec: Precision, train: bool, final: bool = False):
    """One MoDE conv: the gated sum of the five expert convs, then BN + ReLU."""
    co = p["expert_conv5x5_conv"].shape[0]
    logits = onehot.to(p["gate.weight"].dtype) @ p["gate.weight"].T + p["gate.bias"]
    g = torch.softmax(logits.reshape(logits.shape[0], 5, co), dim=1)   # (N, E, Co)
    inputs = (x, x, x, _avg_pool(x, 3), _avg_pool(x, 5))
    out = None
    for e, (name, xi) in enumerate(zip(EXPERTS, inputs)):
        w = p[name]
        y = _conv(xi, w, prec, padding=w.shape[-1] // 2) * g[:, e, :, None, None, None]
        out = y if out is None else out + y
    if final:
        return out
    return _bn_relu(out, _sub(p, "subsequent_layer.0"), train)


def repmode_forward(state: State, x, task, cfg: dict, prec: Precision, train: bool):
    """x (N,1,D,H,W) fp32, task (N,) int -> (N,1,D,H,W)."""
    onehot = F.one_hot(task.long(), cfg["num_tasks"])
    depth = cfg["depth"]
    skips = []
    h = x
    for i in range(1, depth + 1):
        pre = f"encoder_block{i}"
        h = mode_conv(h, _sub(state, f"{pre}.conv_more.conv1"), onehot, prec, train)
        h = mode_conv(h, _sub(state, f"{pre}.conv_more.conv2"), onehot, prec, train)
        skips.append(h)
        h = _conv(h, state[f"{pre}.conv_down.0.weight"], prec, stride=2)
        h = _bn_relu(h, _sub(state, f"{pre}.conv_down.1"), train)
    h = mode_conv(h, _sub(state, "bottle_block.conv1"), onehot, prec, train)
    h = mode_conv(h, _sub(state, "bottle_block.conv2"), onehot, prec, train)
    for i in range(depth, 0, -1):
        pre = f"decoder_block{i}"
        h = _convt(h, state[f"{pre}.convt.0.weight"], prec)
        h = _bn_relu(h, _sub(state, f"{pre}.convt.1"), train)
        h = torch.cat([skips[i - 1], h], dim=1)
        h = mode_conv(h, _sub(state, f"{pre}.conv_less.conv1"), onehot, prec, train)
        h = mode_conv(h, _sub(state, f"{pre}.conv_less.conv2"), onehot, prec, train)
    return mode_conv(h, _sub(state, "conv_out"), onehot, prec, train, final=True)


def forward(state: State, x, task, cfg: dict, prec: Precision, train: bool):
    if cfg["model"] != "RepMode":
        raise KeyError(f"no reference for model {cfg['model']!r}")
    return repmode_forward(state, x, task, cfg, prec, train)
