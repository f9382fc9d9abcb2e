"""A traced run of a timed region: the counterpart of ``tools/profile_train.py``,
``tools/profile_forward.py`` and ``tools/aggregate_prof.py``.

``bench_torch.serve --profile DIR`` and ``bench_torch.train --profile DIR``
call ``profile_region`` after their timed runs, with the profiler off during
those: one warm-up call, then a window of ``calls`` calls under
``torch.profiler`` (CPU and, on the card, CUDA activity). The profiler runs
the window twice, with a schedule that traces the first pass and drops it
and records the second, because a session loses the device events of its
first moments. The recorded pass is written to ``DIR`` as a Chrome trace, and
the summary is one JSON line:

- ``device_busy_share``: the time some kernel ran (the union of their
  intervals) over the window's wall time; ``kernel_ms_total`` sums them;
- ``top_kernels``: the 15 device kernels with the most self time;
- ``buckets``: device time and launches by subsystem (``bucket``), keyed by
  the port's own kernels (K1-K6, by the symbols of ``csrc/*.cu``) and by the
  library and PyTorch kernels around them.

A span (``record_function``, the schedule's step marks) also shows on the
device's timeline as an annotation over the kernels launched inside it: no
device column counts one as a kernel.

On the CPU there is no device trace: every device column reads
"not measured", and the summary lists the host ops with the most self time.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable

import torch

from bench_torch.common import DeviceRecord, synchronize

NOT_MEASURED = "not measured"
TOP = 15

# (bucket, test on a device kernel's name), first match wins: the port's
# kernels by their symbols in csrc/*.cu (K2 and K3 are one template, TRANS
# false and true), then cuDNN's convs before the GEMMs (cuDNN's implicit-GEMM
# conv kernels name a gemm too), then PyTorch's own kernels.
BUCKETS = (
    ("K1 conv3d_same", lambda n: "conv3d_same_kernel" in n),
    ("K2 conv3d_same_persample", lambda n: "conv3d_persample_kernel" in n and "false>" in n),
    ("K3 conv3d_same_persample (transpose_taps)",
     lambda n: "conv3d_persample_kernel" in n and "true>" in n),
    ("K4 conv3d_dw_persample", lambda n: "conv3d_dw_kernel" in n or "sum_partials_kernel" in n),
    ("K5 conv3d_dpad", lambda n: "conv3d_dpad_kernel" in n),
    ("K6 conv3d_tapconcat_persample", lambda n: "conv3d_tapconcat_kernel" in n),
    ("cuDNN convs", lambda n: re.search(
        r"cudnn|fprop|dgrad|wgrad|convolve|convolution|conv[23]d|_conv_", n.lower()) is not None),
    ("GEMMs (gate-merge einsums, resample matmuls)", lambda n: any(s in n.lower() for s in (
        "gemm", "nvjet", "cutlass", "cublas"))),
    ("optimizer (Adam)", lambda n: any(s in n for s in (
        "multi_tensor_apply", "Adam", "adam", "_foreach"))),
    ("copies, casts, permutes", lambda n: any(s in n for s in (
        "copy", "Copy", "Memcpy", "Memset", "permute", "transpose", "cat_", "CatArray",
        "index", "gather", "scatter", "fill"))),
    ("BN and other reductions", lambda n: any(s in n for s in (
        "reduce", "Reduce", "batch_norm", "welford", "Welford", "norm"))),
    ("elementwise (ReLU, adds, the stitch)", lambda n: "elementwise" in n),
)
OTHER = "other"


def bucket(name: str) -> str:
    """The subsystem of a device kernel, by its name."""
    for label, test in BUCKETS:
        if test(name):
            return label
    return OTHER


def profile_region(fn: Callable, dev: DeviceRecord, trace_path: str, calls: int = 1) -> dict:
    """Trace ``calls`` calls of ``fn`` (after one warm-up call) into
    ``trace_path`` and summarise them (see the module docstring)."""
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    fn()
    synchronize(dev.device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.is_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched,
                                on_trace_ready=lambda p: p.export_chrome_trace(trace_path)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            synchronize(dev.device)
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    return summarize(prof, wall_ms, dev, calls, trace_path)


def busy_ms(intervals) -> float:
    """The length of the union of (start, end) intervals, in their unit / 1e3."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _is_kernel(e) -> bool:
    """A device activity: no host op, no span's annotation, no step mark."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep"))


def summarize(prof, wall_ms: float, dev: DeviceRecord, calls: int, trace_path: str) -> dict:
    events = prof.key_averages()
    rec = {"trace": trace_path, "calls": calls, "wall_ms": wall_ms, "device_kind": dev.kind,
           "power_limit_w": dev.power_limit_w}
    if not dev.is_cuda:
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                       if not e.key.startswith("ProfilerStep")), key=lambda r: -r[1])
        return {**rec, "device_busy_ms": NOT_MEASURED, "device_busy_share": NOT_MEASURED,
                "kernel_ms_total": NOT_MEASURED, "top_kernels": NOT_MEASURED,
                "buckets": {label: {"ms": NOT_MEASURED, "launches": NOT_MEASURED}
                            for label in [b for b, _ in BUCKETS] + [OTHER]},
                "top_host_ops": [[k[:100], ms, n] for k, ms, n in host[:TOP]]}
    # device activities only (a CPU op's device time repeats its kernels')
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                      if _is_kernel(e)), key=lambda r: -r[1])
    # busy: the union of the kernels' intervals (kernels on two streams overlap)
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in prof.events()
                   if _is_kernel(e))
    buckets = {label: {"ms": 0.0, "launches": 0} for label in [b for b, _ in BUCKETS] + [OTHER]}
    for name, ms, n in kernels:
        b = buckets[bucket(name)]
        b["ms"] += ms
        b["launches"] += n
    return {**rec, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
            "kernel_ms_total": sum(ms for _, ms, _ in kernels),
            "top_kernels": [[k[:100], ms, n] for k, ms, n in kernels[:TOP]],
            "buckets": buckets}
