"""What the port's measurement entry points share.

- The device record: the card's name and count from torch, its power limit
  from ``nvidia-smi``, its published peaks from ``PEAKS``. On the CPU the
  record names ``"cpu"`` and every device figure (peak, power limit, and so
  ``mfu``) is None: a CPU time is never written under a device's name.
- The V100 baselines the JAX package's benchmarks divide by (``bench.py``,
  ``tools/bench_train.py``; derived in ``BASELINE.md``), copied here.
- ``timed``: one call whose clock stops after ``torch.cuda.synchronize()``,
  so a time covers the device's work and not only its enqueue.
- ``seeded_state_dict``: the net's weights from a seeded generator, as
  the JAX benchmarks' ``create_train_state(cfg, PRNGKey(0))``.
- ``summary``: the median (``bench.py``'s: the upper middle of an even
  count) and the quartiles of a list of times.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.ops.conv3d import (
    conv3d_dpad,
    conv3d_dw_persample,
    conv3d_same,
    conv3d_same_persample,
    conv3d_tapconcat_persample,
)
from repmode_tpu_torch.ops.mode import gate_merge_persample
from repmode_tpu_torch.train.state import create_train_state

# bench.py: the derived V100 serving rate and the >= 5x north star
V100_VOXELS_PER_SEC = 0.9e6
NORTH_STAR_MULTIPLIER = 5.0
SERVE_BASELINE_METHOD = ("analytic FLOP model x cuDNN-efficiency estimate "
                         "(BASELINE.md; reference publishes no numbers)")
# tools/bench_train.py: the derived V100 training rate and its range
V100_TRAIN_VOXELS_PER_SEC = 4.0e6
V100_TRAIN_RANGE = [2.0e6, 7.0e6]
TRAIN_BASELINE_METHOD = (
    "analytic: 26.2 TFLOP/step (3x fwd, utils/flops.py) / (125 fp16 "
    "TFLOP/s x 0.20 assumed AMP wall efficiency); see BASELINE.md for "
    "the inference-side anchor of the efficiency band"
)

# Published dense (no sparsity) bf16 peaks in TFLOP/s and memory rates in
# TB/s, by a substring of torch.cuda.get_device_name (NVIDIA's data sheets;
# the SXM part's rates assume its full 700 W). Any other card: None.
PEAKS = (
    ("H100 80GB HBM3", 989.0, 3.35),  # H100 SXM
    ("H100 PCIe", 756.0, 2.0),
)


@dataclasses.dataclass(frozen=True)
class DeviceRecord:
    device: torch.device
    kind: str                       # torch.cuda.get_device_name, or "cpu"
    count: int                      # torch.cuda.device_count(), 0 on the CPU
    card: Optional[str]             # nvidia-smi's "name, power.limit" line
    power_limit_w: Optional[float]
    peak_bf16_tflops: Optional[float]
    peak_tb_per_s: Optional[float]

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def mfu(self, tflops: float) -> Optional[float]:
        return tflops / self.peak_bf16_tflops if self.peak_bf16_tflops else None


def nvidia_smi_line(index: int = 0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    one card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[index]


def device_record(device: DeviceLike = "cuda") -> DeviceRecord:
    """The record of ``device``; raises without a card unless it is the CPU
    (``repmode_tpu_torch.device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DeviceRecord(dev, "cpu", 0, None, None, None, None)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kind = torch.cuda.get_device_name(index)
    card = nvidia_smi_line(index)
    try:  # "<name>, 700.00 W"; "[N/A]" where the card reports none
        power = float(card.rsplit(",", 1)[-1].split()[0])
    except ValueError:
        power = None
    peak = next(((f, b) for name, f, b in PEAKS if name in kind), (None, None))
    return DeviceRecord(dev, kind, torch.cuda.device_count(), card, power, *peak)


def seeded_state_dict(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The net's weights (a copy) from a generator seeded ``seed``."""
    state = create_train_state(cfg, torch.Generator().manual_seed(seed), device)
    return {k: v.detach().clone() for k, v in state.net.state_dict().items()}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device: torch.device):
    """(fn(), seconds), the clock read after the device has finished."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def summary(times: Sequence[float]) -> dict:
    """Median (bench.py's: sorted(times)[n // 2]), quartiles, count."""
    ts = sorted(times)
    return {"median": ts[len(ts) // 2], "p25": float(np.percentile(ts, 25)),
            "p75": float(np.percentile(ts, 75)), "n": len(ts)}


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_gb(device: torch.device) -> Optional[float]:
    """max_memory_allocated since the last reset, in GB; None on the CPU."""
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def backend_switches() -> dict:
    """The torch.backends flags a time depends on."""
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cudnn.deterministic": torch.backends.cudnn.deterministic}


def kernel_launches() -> dict:
    """The port's launch counters (each wrapper adds one where it launches
    its kernel on the card; on the CPU they stay as they are)."""
    return {"conv3d_same": conv3d_same.launches,
            "conv3d_same_persample": conv3d_same_persample.launches,
            "conv3d_same_persample_transpose": conv3d_same_persample.transpose_launches,
            "conv3d_dw_persample": conv3d_dw_persample.launches,
            "conv3d_dpad": conv3d_dpad.launches,
            "conv3d_tapconcat_persample": conv3d_tapconcat_persample.launches,
            "gate_merge_persample": gate_merge_persample.launches,
            "gate_merge_persample_backward": gate_merge_persample.backward_launches}


def add_launches_since(before: dict, into: dict) -> None:
    """Add the launches made since ``before`` (a ``kernel_launches()``) into ``into``."""
    for k, v in kernel_launches().items():
        into[k] = into.get(k, 0) + v - before[k]


def larger(a: Optional[float], b: Optional[float]) -> Optional[float]:
    return b if a is None else a if b is None else max(a, b)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def parse_shape(text: str) -> tuple:
    return tuple(int(s) for s in text.split(","))


def emit(records: List[dict], out: Optional[str] = None) -> None:
    """One JSON line a record on stdout; with ``out``, the same lines there."""
    lines = [json.dumps(r) for r in records]
    for line in lines:
        print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write("".join(line + "\n" for line in lines))
