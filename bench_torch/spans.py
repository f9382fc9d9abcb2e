"""The program's spans in a benchmark cell's traced run.

    python3 -m bench_torch.spans --workload <cell> --seed <n> --seconds 30 [--out FILE]

Runs one cell of ``benchmark/`` as ``python3 -m benchmark.run ... --trace 1``
does (``benchmark.cell.run``), with its tracer also keeping the device
annotations of the program's ``rm.`` spans (``repmode_tpu_torch/utils/
timing``), and prints one JSON line (also written to ``--out``):

- ``trace``: the benchmark's own summary of the traced units (window, busy,
  buckets, breakdown) and ``metrics``: its per-layer readers on them;
- ``spans``, ``step_idle_s``: ``span_split`` of the same window, with the
  benchmark's buckets and idle gaps;
- ``readings``: per unit (a step, a volume), in ms: ``sampler_ms.train``,
  ``h2d_ms.train``, ``step_idle_ms.train``, ``merge_fwd_ms.train``,
  ``merge_bwd_ms.train``,
  ``conv_glue_ms.train`` (``rm.mode.conv``'s device time outside the conv
  buckets), ``prepare_ms.serve``, ``h2d_ms.serve``, ``stitch_ms.serve``;
  and in a cell of a plain U-Net (``UNet``, ``fnet_nn_3d``), whose convs and
  BNs open ``rm.unet.conv`` and ``rm.unet.bn``, ``unet_conv_glue_ms.train``
  and ``.serve`` (``rm.unet.conv``'s device time outside the conv buckets:
  the casts, the bias, K1's padding) and ``unet_bn_ms.train`` and
  ``.serve`` (device time inside ``rm.unet.bn``; in training the forward's
  alone, the backward runs under no span);
- ``checks``: the readings' own consistency: the conv buckets' time inside
  ``rm.mode.conv`` against their time in the window (training; inside
  ``rm.unet.conv`` at most that time), every idle
  gap given to one span or ``"(none)"``, one ``rm.step`` / ``rm.loop.h2d``
  or ``rm.predict`` / ``rm.predict.h2d`` a unit, and the stitch inside the
  serving glue.

Needs a CUDA card, as the benchmark does. The benchmark itself reads none
of this yet: its tracer drops every device annotation.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple
from unittest import mock

import torch

from benchmark import spec, trace
from repmode_tpu_torch.utils.timing import PREFIX

STARTED = time.perf_counter()

Interval = Tuple[str, float, float]   # (name, start, end), microseconds


def _union(intervals) -> List[Tuple[float, float]]:
    """Sorted, disjoint (start, end) intervals covering the same time."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def span_split(host: Sequence[Interval], annotations: Sequence[Interval],
               kernels: Sequence[Interval], lo: float, hi: float,
               bucket_of: Callable[[str], str]) -> Dict[str, object]:
    """The program's spans (names starting with ``rm.``) in the window
    [lo, hi]: ``host`` their host intervals (any thread), ``annotations``
    their intervals on the device's timeline, ``kernels`` the device's
    activities. Returns ``spans``, per name:

    - ``n``: the host intervals in the window;
    - ``host_s``: their length, clipped to the window;
    - ``device_s``, ``device_by_bucket``: the time, clipped to the window, of
      the kernels whose start falls inside one of the name's annotations;
    - ``idle_s``: the device's idle gaps whose start the name covers on the
      host as the innermost span at that moment;

    and under ``"(none)"`` the idle that no span covers; ``step_idle_s``, the
    idle whose gap began inside an ``rm.step`` host interval."""
    host = [(n, a, b) for n, a, b in host if n.startswith(PREFIX) and b > lo and a < hi]
    inside = [(n, a, max(a, lo), min(b, hi)) for n, a, b in kernels if b > lo and a < hi]
    spans: Dict[str, dict] = {}
    for n, a, b in host:
        s = spans.setdefault(n, {"n": 0, "host_s": 0.0, "device_s": 0.0,
                                 "device_by_bucket": defaultdict(float), "idle_s": 0.0})
        s["n"] += 1
        s["host_s"] += (min(b, hi) - max(a, lo)) / 1e6
    marks: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for n, a, b in annotations:
        if n in spans:
            marks[n].append((a, b))
    for n, iv in marks.items():
        union = _union(iv)
        starts = [a for a, _ in union]
        for k, k0, a, b in inside:
            i = bisect.bisect_right(starts, k0) - 1
            if i >= 0 and k0 < union[i][1]:
                spans[n]["device_s"] += (b - a) / 1e6
                spans[n]["device_by_bucket"][bucket_of(k)] += (b - a) / 1e6
    none = step_idle = 0.0
    steps = [(a, b) for n, a, b in host if n == PREFIX + "step"]
    for a, b in trace._gaps([(a, b) for _, _, a, b in inside], lo, hi):
        covering = [(hb - ha, n) for n, ha, hb in host if ha <= a < hb]
        if covering:
            spans[min(covering)[1]]["idle_s"] += (b - a) / 1e6
        else:
            none += (b - a) / 1e6
        if any(sa <= a < sb for sa, sb in steps):
            step_idle += (b - a) / 1e6
    for s in spans.values():
        s["device_by_bucket"] = dict(s["device_by_bucket"])
    spans["(none)"] = {"idle_s": none}
    return {"spans": spans, "step_idle_s": step_idle}


class SpanTracer(trace.Tracer):
    """The benchmark's tracer, also keeping the spans' device annotations
    and adding ``span_split`` to its summary."""

    def _keep(self, prof) -> None:
        super()._keep(prof)
        cuda = torch.autograd.DeviceType.CUDA
        self.annotations = [(e.name, e.time_range.start, e.time_range.end)
                            for e in prof.events() if e.device_type == cuda
                            and getattr(e, "is_user_annotation", False)]

    def summary(self, table):
        out = super().summary(table)
        if out is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        steps = [(a, b) for n, d, a, b in self.events
                 if d != cuda and n.startswith("ProfilerStep")]
        lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
        kernels = [(n, a, b) for n, d, a, b in self.events
                   if d == cuda and not n.startswith(("ProfilerStep", "bench."))]
        host = [(n, a, b) for n, d, a, b in self.events if d != cuda]
        return {**out, **span_split(host, self.annotations, kernels, lo, hi,
                                    lambda n: spec.bucket_of(n, table)),
                "rm_kernels": sum(n.startswith(PREFIX) for n, _, _ in kernels)}


def readings(kind: str, units: int, spans: dict, step_idle_s: float, conv_buckets) -> dict:
    """The per-unit readings (ms) of one kind of cell from ``span_split``."""
    def get(name, key):
        return spans.get(PREFIX + name, {}).get(key, 0.0)

    def glue(name):   # device time inside the span, outside the conv buckets
        conv = spans.get(PREFIX + name, {}).get("device_by_bucket", {})
        return get(name, "device_s") - sum(conv.get(b, 0.0) for b in conv_buckets)

    per = 1e3 / units
    if kind == "train":
        out = {"sampler_ms.train": get("sampler.wait", "host_s") * per,
               "h2d_ms.train": get("loop.h2d", "host_s") * per,
               "step_idle_ms.train": step_idle_s * per,
               "merge_fwd_ms.train": get("mode.merge", "device_s") * per,
               "merge_bwd_ms.train": get("mode.merge_bwd", "device_s") * per,
               "conv_glue_ms.train": glue("mode.conv") * per}
    else:
        out = {"prepare_ms.serve": get("reparam.prepare", "host_s") * per,
               "h2d_ms.serve": get("predict.h2d", "host_s") * per,
               "stitch_ms.serve": get("predict.stitch", "device_s") * per}
    if PREFIX + "unet.conv" in spans:
        out[f"unet_conv_glue_ms.{kind}"] = glue("unet.conv") * per
        out[f"unet_bn_ms.{kind}"] = get("unet.bn", "device_s") * per
    return out


def checks(kind: str, units: int, trace: dict, metrics: dict, conv_buckets) -> dict:
    """{check: [value, target, holds]} of one traced run's spans."""
    spans, out = trace["spans"], {}

    def n_a_unit(name):
        v = spans.get(name, {}).get("n", 0) / units
        out[f"n_a_unit {name}"] = [v, 1, v == 1]

    out["no_rm_kernels"] = [trace["rm_kernels"], 0, trace["rm_kernels"] == 0]
    idle = sum(s["idle_s"] for s in spans.values())
    want = trace["window_s"] - trace["busy_s"]
    out["idle_s_sum"] = [idle, want, abs(idle - want) <= 0.01 * max(want, 1e-9)]
    if kind == "train":
        inside = spans.get("rm.mode.conv", {}).get("device_by_bucket", {})
        unet = spans.get("rm.unet.conv", {}).get("device_by_bucket", {})
        for b in conv_buckets:
            got, whole = inside.get(b, 0.0), trace["bucket_s"].get(b, 0.0)
            if unet:   # the forward's convs alone: autograd's backward opens no span
                got = unet.get(b, 0.0)
                out[f"unet_conv_within {b}"] = [got, whole, got <= whole]
                continue
            out[f"conv_inside {b}"] = [got, whole, abs(got - whole) <= 0.01 * whole]
        n_a_unit("rm.step")
        n_a_unit("rm.loop.h2d")
    else:
        n_a_unit("rm.predict")
        n_a_unit("rm.predict.h2d")
        stitch = spans.get("rm.predict.stitch", {}).get("device_s", 0.0) * 1e3 / units
        glue = metrics.get("glue_ms.serve")
        out["stitch_within_glue"] = [stitch, glue, glue is not None and stitch <= glue]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch.spans: needs a CUDA card", file=sys.stderr)
        return 3
    from benchmark import cell

    bench = spec.benchmark()
    mix = spec.traffic(spec.workload(args.workload, bench)["traffic"])
    dev = torch.device("cuda", 0)
    with mock.patch.object(trace, "Tracer", SpanTracer):
        out = cell.run(args.workload, args.seed, args.seconds, True, dev, STARTED, bench=bench)
    if not out.get("trace") or out.get("reading") is None:
        print("bench_torch.spans: the traced run left no device trace", file=sys.stderr)
        return 1
    summary, reading = out["trace"], out["reading"]
    metrics = {m["name"]: spec.reader(m["name"])(reading)
               for m in spec.per_layer(bench, args.workload)}
    conv_buckets = reading.conv_buckets
    rec = {"workload": args.workload, "seed": args.seed, "correct": out["correct"],
           "device": torch.cuda.get_device_name(dev), "units": reading.units,
           "window_unit_ms": 1e3 * out["window_s"] / out["units"],
           "traced_unit_ms": 1e3 * summary["window_s"] / reading.units,
           "metrics": metrics,
           "readings": readings(mix["kind"], reading.units, summary["spans"],
                                summary["step_idle_s"], conv_buckets),
           "checks": checks(mix["kind"], reading.units, summary, metrics, conv_buckets),
           "trace": summary}
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
