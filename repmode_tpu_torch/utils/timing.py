"""Per-phase wall-clock timing and optional ``torch.profiler`` traces.

The port of ``repmode_tpu.utils.timing``. The reference logs coarse elapsed
times only (main.py:122,150,200,233; time/train, time/val keys at
main.py:264,324); ``PhaseTimer`` keeps those keys and ``profile_trace``
records a trace of a region (``train/loop.run_experiment(...,
profile_dir=...)`` wraps the first trained epoch in it).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def pop(self, name: str) -> float:
        return self.totals.pop(name, 0.0)

    def as_log_dict(self, prefix: str = "time/") -> Dict[str, float]:
        return {f"{prefix}{k}": v for k, v in self.totals.items()}


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the region into ``log_dir`` (a
    no-op when None): the CPU's activity and, where a card is present, the
    card's, written at the region's end as a Chrome trace
    ``<host>_<pid>.<time>.pt.trace.json``, one file a process."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
