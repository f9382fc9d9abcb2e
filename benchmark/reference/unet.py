"""Pieces of a 3-D U-Net that reference model files share: the channels and
voxels of each level, BN's state entries, and the convs and BN + ReLU as the
references run them (NCDHW, plain PyTorch)."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.nets import Entry, State
from benchmark.reference.precision import Precision


def chans(cfg: dict) -> List[int]:
    """The channels of each level, the first's then each doubled."""
    c = cfg["in_channels"] * cfg["mult_chan"]
    return [c * 2 ** i for i in range(cfg["depth"] + 1)]


def levels(cfg: dict, patch) -> Tuple[List[int], List[int]]:
    """(channels, voxels of one patch) of each level."""
    d, h, w = patch
    return chans(cfg), [d * h * w // 8 ** i for i in range(cfg["depth"] + 1)]


def bn_spec(prefix: str, c: int) -> List[Entry]:
    return [Entry(f"{prefix}.weight", (c,), "ones", 0.0), Entry(f"{prefix}.bias", (c,), "zeros", 0.0),
            Entry(f"{prefix}.running_mean", (c,), "zeros", 0.0),
            Entry(f"{prefix}.running_var", (c,), "ones", 0.0),
            Entry(f"{prefix}.num_batches_tracked", (), "count", 0.0)]


def sub(state: State, prefix: str) -> State:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in state.items() if k.startswith(prefix + ".")}


def conv(x, w, prec: Precision, **kw):
    return prec.conv(lambda a, b: F.conv3d(a, b, **kw), x, w)


def convt(x, w, prec: Precision):
    return prec.conv(lambda a, b: F.conv_transpose3d(a, b, stride=2), x, w)


# True: batch statistics; False: running statistics; "record": batch
# statistics, written into the running ones (momentum 1)
def bn_relu(x, bn: State, train, relu: bool = True):
    if train == "record":
        y = F.batch_norm(x, bn["running_mean"], bn["running_var"], bn["weight"], bn["bias"],
                         training=True, momentum=1.0, eps=1e-5)
    else:
        y = F.batch_norm(x, None if train else bn["running_mean"],
                         None if train else bn["running_var"], bn["weight"], bn["bias"],
                         training=train, eps=1e-5)
    return torch.relu(y) if relu else y
