"""The plain reference of a configuration's net, found by its ``model``.

Each model has a file of its own, ``models/<model lower-cased>.py``, that
this module finds on disk by the configuration's ``model`` (as
``spec.reader`` finds a metric): a later model adds a file, and nothing here
is edited. The file defines

- ``spec(cfg) -> List[Entry]``: every entry of the net's state (names as the
  published code names them, shapes, and the initial value's law), so the
  benchmark can make the weights from a seed and hand the same tensors to the
  program and here. ``data.weights`` draws the uniform leaves in one flat draw
  in this order, so the order is part of the weights;
- ``forward(state, x, task, cfg, prec, train)``: x (N,1,D,H,W) fp32, task (N,)
  int; ``train`` True (batch statistics), False (running statistics) or
  ``"record"`` (batch statistics, written into the running ones). Every conv
  goes through ``Precision.conv``: as it is for the reference, in float8 for
  the lower-precision control (``precision.py``);
- ``convs(cfg, patch) -> List[Conv]``: every conv of one patch's forward, in
  the order the net runs them, as ``counts.py`` counts them;
- ``FAULT_LEAF``: the parameter whose gradient ``faults.py``'s leaf faults
  scale, or None.

U-Net helpers that model files share are in ``unet.py``.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import torch

from benchmark.reference.precision import Precision

MODELS = Path(__file__).resolve().parent / "models"


class Entry(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    law: str          # "uniform" (bound 1/sqrt(fan_in)), "zeros", "ones", "fill", "count"
    value: float      # fan_in for "uniform", the constant for "fill"


class Conv(NamedTuple):
    voxels: int   # output positions of one patch
    ci: int
    co: int
    taps: int
    final: bool
    same: bool = True   # a k^3 'same' conv (not a resampling one)


State = Dict[str, torch.Tensor]


@lru_cache(maxsize=None)
def _load(path: Path):
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.reference.models.{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def model(cfg: dict):
    """The reference model file of the configuration's ``model``."""
    path = MODELS / f"{cfg['model'].lower()}.py"
    if not path.is_file():
        found = sorted(p.name for p in MODELS.glob("*.py"))
        raise KeyError(f"no reference for model {cfg['model']!r}: {MODELS} holds {found}")
    return _load(path)


def spec(cfg: dict) -> List[Entry]:
    """Every state entry of the configuration's net."""
    return model(cfg).spec(cfg)


def parameter_names(cfg: dict) -> List[str]:
    """The entries that training updates (everything but BN statistics,
    counters and the fixed pool kernels)."""
    return [en.name for en in spec(cfg) if en.law == "uniform"
            or en.law in ("ones", "zeros") and en.name.endswith((".weight", ".bias"))]


def forward(state: State, x, task, cfg: dict, prec: Precision, train):
    return model(cfg).forward(state, x, task, cfg, prec, train)
