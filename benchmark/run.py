"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with a CUDA card. Set-up (import, the CUDA
context, the kernels built into or loaded from ``build/``, weights and
volumes made from the seed on the card, the warm-up of the cell's own
shapes), then the window of ``--seconds``, then the check against the plain
reference (``benchmark/reference``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
with its limit (also the last lines of standard error).

Exits 3 and prints no result without a card or with fewer cards than the
cell asks for, and 4 if JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import os
import time


def process_age_s(stat: str = "/proc/self/stat", uptime: str = "/proc/uptime") -> float:
    """Seconds since this process started (Linux ``/proc``), 0 elsewhere."""
    try:
        with open(stat) as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open(uptime) as f:
            up = float(f.read().split()[0])
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


# the process's start on perf_counter's clock: the clock and the process's
# age are read at the same moment, before anything heavy is imported
STARTED = time.perf_counter() - process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache a run writes stays inside the checkout, at a fixed path
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / "cache" / _sub))

FORBIDDEN = ("jax", "jaxlib", "flax", "repmode_tpu", "bench_torch", "tools_torch", "chip_smoke")


def loaded_forbidden() -> list:
    """Modules loaded in this process whose top-level name (the part before
    the first dot, compared whole) is JAX's, the JAX package's, or a tool's
    the benchmark must not use."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_line(dev, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak_bytes}


def result_line(bench: dict, name: str, out: dict, traced: bool, dev) -> dict:
    from benchmark import spec

    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if not traced:
        values = {"setup_s": out["setup_s"]}
        if out["kind"] == "serve":
            values["serve_vox_per_s"] = out["voxels"] / out["window_s"]
        else:
            values["train_step_ms"] = 1e3 * out["window_s"] / out["units"]
        for m in spec.end_to_end(bench, name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif out.get("reading") is not None:
        for m in spec.per_layer(bench, name):
            value = spec.reader(m["name"])(out["reading"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = device_line(dev, out["memory_peak_bytes"])
    if traced and out.get("trace"):
        line["device"]["busy_s"] = out["trace"]["busy_s"]
        line["device"]["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    t_torch = time.perf_counter()
    from benchmark import cell, spec

    bench = spec.benchmark()
    w = spec.workload(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {w['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), dev, STARTED,
                   bench=bench, marks={"python_and_torch_import": t_torch - STARTED})
    mix = spec.traffic(w["traffic"])
    out["kind"] = mix["kind"]
    if mix["kind"] == "serve":
        vol = 1
        for s in mix["volume_shape"]:
            vol *= s
        out["voxels"] = vol * out["units"]
    line = result_line(bench, args.workload, out, bool(args.trace), dev)
    # last, once every reader has been loaded: what the run loaded, whoever loaded it
    found = loaded_forbidden()
    if found:
        print(f"benchmark: modules that must not load were loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps({k: out[k] for k in ("numbers", "setup_s", "setup_phases", "window_s",
                                          "units", "check_s")}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
