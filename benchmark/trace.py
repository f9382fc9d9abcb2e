"""The traced run: a few units of the window under ``torch.profiler``.

A ``--trace 1`` run traces ``units`` consecutive units of its window (a
served volume, a train step), after one more unit that is traced and dropped
(a profiling session loses the device events of its first moments). The
device is synchronised at both ends, so the traced window starts and ends
idle; its length is the span of the profiler's step marks. From the trace,
all in memory (nothing is written to disk):

- ``busy_s``: the union of the device activities' intervals inside the
  window (``bench_torch/profile.busy_ms``, copied);
- each bucket's device seconds (``benchmark/buckets/*.json``, first match
  by order);
- ``breakdown``: the device kernels with the most time, and the idle gaps
  summed by what the host was doing when each began: the benchmark's own
  span (``bench.*``) and the innermost host op inside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import spec

TOP = 10


def span(name: str):
    """A host span around one of the benchmark's calls into the program."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader gets."""

    kind: str                       # "serve" or "train"
    units: int                      # volumes or steps in the traced window
    window_s: float
    busy_s: float
    bucket_s: Dict[str, float]
    conv_buckets: Tuple[str, ...]
    merge_buckets: Tuple[str, ...]
    model_flops: float              # of the traced units
    conv_bound_s: float             # of the traced units
    peak_flops: float
    peak_bytes_per_s: float

    def kernel_s(self) -> float:
        return sum(self.bucket_s.values())

    def conv_s(self) -> float:
        return sum(self.bucket_s.get(b, 0.0) for b in self.conv_buckets)

    def merge_s(self) -> float:
        return sum(self.bucket_s.get(b, 0.0) for b in self.merge_buckets)


def busy_s(intervals) -> float:
    """The length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class Tracer:
    """Traces units ``first .. first + units - 1`` of a window (unit
    ``first - 1`` is traced and dropped). ``before(i)`` and ``after(i)`` are
    called around unit i by the cell's driver."""

    def __init__(self, device: torch.device, first: int, units: int):
        self.device, self.first, self.units = device, first, units
        self.prof = None
        self.events = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def before(self, i: int) -> None:
        if i != self.first - 1:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=1, active=self.units, repeat=1)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts, schedule=sched,
                                           on_trace_ready=self._keep)
        self.prof.start()

    def after(self, i: int) -> None:
        if self.prof is None or not self.first - 1 <= i < self.first + self.units:
            return
        if i in (self.first - 1, self.first + self.units - 1):
            self._sync()
        self.prof.step()
        if i == self.first + self.units - 1:
            self.prof.stop()
            self.prof = None

    def finished(self) -> bool:
        """Whether the traced units are done (a tracer of no units always is)."""
        return self.units == 0 or self.events is not None

    def _keep(self, prof) -> None:
        # a span (record_function, the schedule's step marks) also shows on the
        # device's timeline as an annotation: it is no device operation
        self.events = [(e.name, e.device_type, e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if not (e.device_type == torch.autograd.DeviceType.CUDA
                               and getattr(e, "is_user_annotation", False))]

    def close(self) -> None:
        """Stop a profiler the window ended inside."""
        if self.prof is not None:
            with contextlib.suppress(RuntimeError):
                self.prof.stop()
            self.prof = None

    def summary(self, table: List[spec.Bucket]) -> Optional[dict]:
        """Window, busy, bucket seconds and breakdown of the traced units;
        None when nothing was traced or the device left no events."""
        if not self.events:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        steps = [(a, b) for n, d, a, b in self.events
                 if d != cuda and n.startswith("ProfilerStep")]
        kernels = [(n, a, b) for n, d, a, b in self.events
                   if d == cuda and not n.startswith(("ProfilerStep", "bench."))]
        if not steps or not kernels:
            return None
        lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
        inside = [(n, max(a, lo), min(b, hi)) for n, a, b in kernels if b > lo and a < hi]
        by_kernel: Dict[str, float] = defaultdict(float)
        by_bucket: Dict[str, float] = defaultdict(float)
        for n, a, b in inside:
            by_kernel[n] += (b - a) / 1e6
            by_bucket[spec.bucket_of(n, table)] += (b - a) / 1e6
        busy = busy_s((a, b) for _, a, b in inside) / 1e6
        host = [(n, a, b) for n, d, a, b in self.events
                if d != cuda and not n.startswith("ProfilerStep") and b > lo and a < hi]
        gaps = _gaps([(a, b) for _, a, b in inside], lo, hi)
        by_gap: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            by_gap[_host_label(host, a)] += (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"window_s": (hi - lo) / 1e6, "busy_s": busy, "bucket_s": dict(by_bucket),
                "breakdown": {"device_ops": top({k[:160]: v for k, v in by_kernel.items()}),
                              "idle_gaps": top(by_gap)}}


def _gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def _host_label(host, t: float) -> str:
    """The benchmark's span and the innermost host op running at time t."""
    covering = [(n, a, b) for n, a, b in host if a <= t < b]
    outer = [n for n, a, b in sorted(covering, key=lambda e: e[1]) if n.startswith("bench.")]
    inner = min(covering, key=lambda e: e[2] - e[1])[0] if covering else "host idle"
    label = f"{outer[-1]} > {inner}" if outer and inner != outer[-1] else (outer[-1] if outer else inner)
    return label[:160]
