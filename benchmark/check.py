"""The numbers that decide ``correct``, and their limits.

Serving (each checked volume: the program's prediction as it reached the
host in the window, against the reference's): ``rel_l2``, the worst
||p - r|| / ||r||, and ``max_err``, the worst max|p - r| / max|r|.

Training (the first three steps, which set-up drove through the window's own
call and feed), over the leaves whose reference gradient is at least a
thousandth of the median leaf's (the others move under Adam by round-off
alone; counted in ``leaves_out``):

- ``out1_vs_bf16``: the first step's forward output, ||p - r|| over the
  error ||q - r|| of a plain bfloat16 forward q of the reference on the same
  batch, so a seed's own amplification of rounding cancels
  (``out1_rel_l2`` is ||p - r|| / ||r||);
- ``grad1_median_gap``, ``grad1_gap``: the median and the worst leaf's
  |‖g_p‖ - ‖g_r‖| / max(‖g_r‖, the median leaf's ‖g_r‖), g_p read from
  Adam's first moment after step 1 (m = 0.1 g);
- ``delta3_gap``: the worst leaf's same gap on its change over the three
  steps; ``loss_gap``: the worst step's |loss_p - loss_r| / loss_r.

A cell's limits are ``benchmark/limits/<workload>.json``: the numbers it
compares, each limit set between the sound runs' largest reading and the
control's or a fault's smallest (``PERF.md`` gives them). A number over its
limit, or missing, or not finite, makes the run not correct.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

SERVE_NUMBERS = ("rel_l2", "max_err")
TRAIN_NUMBERS = ("loss_gap", "out1_rel_l2", "out1_vs_bf16", "grad1_gap", "grad1_median_gap",
                 "delta3_gap")
LEAF_FLOOR = 1e-3


def serve_numbers(pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Dict[str, float]:
    rel, mx = 0.0, 0.0
    for pred, ref in pairs:
        p, r = np.asarray(pred, np.float64), np.asarray(ref, np.float64)
        rel = max(rel, float(np.linalg.norm(p - r) / np.linalg.norm(r)))
        mx = max(mx, float(np.abs(p - r).max() / np.abs(r).max()))
    return {"rel_l2": rel, "max_err": mx}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    med = float(np.median([ref[n] for n in keep]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: {"losses": [3], "out1": tensor, "grad1": {leaf: norm},
    "delta": {leaf: norm}}; ``ref`` the same and "out1_bf16"."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = float(np.median(list(ref["grad1"].values())))
    keep = [n for n, v in ref["grad1"].items() if v >= LEAF_FLOOR * med]
    out = {"loss_gap": loss, "leaves_out": float(len(ref["grad1"]) - len(keep))}
    for name, key in (("grad1", "grad1"), ("delta3", "delta")):
        gaps = _leaf_gaps(prog[key], ref[key], keep)
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"], out[f"{name}_worst"] = gaps[worst], worst
        if name == "grad1":
            out["grad1_median_gap"] = float(np.median(list(gaps.values())))
    # the first step's forward output; samples the program left out read as zeros
    p, r = prog["out1"].double(), ref["out1"].double()
    if p.shape != r.shape:
        p = torch.cat([p, torch.zeros((r.shape[0] - p.shape[0], *r.shape[1:]), dtype=p.dtype)])
    q = ref["out1_bf16"].double()
    out["out1_rel_l2"] = float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))
    out["out1_vs_bf16"] = float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(q - r))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
