"""Read the numbers a cell's limits are set from, on the card, in one process,
and judge the control and each fault by the cell's committed limits.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2] [--out FILE]

For each seed, one run of the cell as ``benchmark.run`` makes it (a short
window) gives the sound program's numbers. On each control seed the same run
also reads the control at the same inputs: the reference in float8 (``FP8``)
put in the program's place, against the float32 reference. On each fault seed
each fault of ``faults.py`` the cell can have is planted in the program and
the run made again. The control and every fault are judged by the limits in
``benchmark/limits/<workload>.json`` (``check.judge``). One JSON line a seed;
the last line sums them up: the sound runs' largest reading of each number,
the control's smallest, each fault's smallest, and every verdict. Exits 1 if
a sound run is not correct, or the control or a fault is.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import cell, check, counts, faults, spec


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None, device=None, small=None) -> int:
    """``device`` and ``small`` (``cell.run``'s) let a test rehearse this on the CPU."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if device is None and not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    dev = device or torch.device("cuda", 0)
    bench = spec.benchmark()
    w = spec.workload(args.workload, bench)
    limits = spec.limits(args.workload)
    cfg = {**spec.config(w["config"]), **(small or {}).get("config", {})}
    mix = {**spec.traffic(w["traffic"]), **(small or {}).get("traffic", {})}
    kind = mix["kind"]
    grid = counts.tiling_patch_count(mix.get("volume_shape"), mix["patch_size"],
                                     mix.get("overlap", 0.5)) if kind == "serve" else 0
    batches = -(-grid // mix.get("batch_size_eval", 1)) if kind == "serve" else 0
    names = check.SERVE_NUMBERS if kind == "serve" else check.TRAIN_NUMBERS

    lines = []
    out_file = open(args.out, "w") if args.out else None
    try:
        for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
            line = {"seed": seed}
            t0 = time.perf_counter()
            res = cell.run(args.workload, seed, args.seconds, False, dev, t0, small=small,
                           bench=bench, control=seed in args.control_seeds)
            line["sound"] = dict(res["numbers"])
            line["sound_correct"] = res["correct"]
            line["units"] = res["units"]
            if seed in args.control_seeds:
                line["control"] = res["control_numbers"]
                line["control_correct"] = check.judge(line["control"], limits)[0]
            if seed in args.fault_seeds:
                line["faults"], line["faults_correct"] = {}, {}
                for fname, plant in faults.for_kind(kind, batches, cfg).items():
                    if fname == "unchanged_state":   # Adam never stepped: every leaf reads 1
                        nums = {n: 1.0 for n in names if "grad1" in n or "delta3" in n}
                    else:
                        with plant():
                            r = cell.run(args.workload, seed, args.seconds, False, dev, t0,
                                         small=small, bench=bench)
                        nums = r["numbers"]
                    line["faults"][fname] = nums
                    line["faults_correct"][fname] = check.judge(nums, limits)[0]
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            if out_file:
                out_file.write(json.dumps(line) + "\n")
                out_file.flush()
            lines.append(line)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if out_file:
            out_file.close()
    summary = {"workload": args.workload, "limits": limits, "sound_max": {}, "control_min": {},
               "faults_min": {},
               "sound_not_correct": [ln["seed"] for ln in lines
                                     if ln["seed"] in args.seeds and not ln["sound_correct"]],
               "control_correct": [ln["seed"] for ln in lines if ln.get("control_correct")],
               "faults_correct": [[ln["seed"], f] for ln in lines
                                  for f, ok in ln.get("faults_correct", {}).items() if ok]}
    for n in names:
        summary["sound_max"][n] = max(ln["sound"][n] for ln in lines if ln["seed"] in args.seeds)
        ctl = [ln["control"][n] for ln in lines if "control" in ln]
        summary["control_min"][n] = min(ctl) if ctl else None
        for ln in lines:
            for fname, nums in ln.get("faults", {}).items():
                if n in nums:
                    cur = summary["faults_min"].setdefault(fname, {}).get(n)
                    summary["faults_min"][fname][n] = nums[n] if cur is None else min(cur, nums[n])
    print(json.dumps(summary), flush=True)
    bad = summary["sound_not_correct"] or summary["control_correct"] or summary["faults_correct"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
