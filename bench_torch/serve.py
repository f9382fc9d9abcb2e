"""Full-volume tiled inference throughput of the port: the counterpart of
``bench.py``.

    python -m bench_torch.serve [--routes native,s2d,k5] [--rounds 3] [--reps 4]
                                [--batch 16] [--predictor fused|two_phase]
                                [--device cuda] [--out FILE]
                                [--profile DIR]

``bench.py``'s protocol, on the card: the default ``Config()`` with
``batch_size_eval`` 16 and bf16 compute; weights from ``create_train_state``
with a generator seeded 0; ``make_inference(cfg)`` with
``prepare(state_dict, 0)`` called once, outside the timed window; the
32x624x924 volume ``default_rng(0).standard_normal`` in fp32; a warm-up
call (which also builds the kernels), then timed calls, each fed the previous
call's output, and their median.

Routes (the ``EvalConfig`` switches): ``native`` (``s2d=False``), ``s2d``
(``s2d=True``, the XLA s2d route, ``Config()``'s default) and ``k5``
(``s2d=True, pallas_conv=True``). They run in turns for ``--rounds`` rounds,
the order reversed every round, ``--reps`` timed calls a route a round, and
each route's calls are pooled. A record's ``route`` is the route that ran: a
model geometry K5 does not take runs ``k5`` as ``s2d``
(``models/reparam.pallas_geometry_ok``); ``route_requested`` is the flag.

Correctness: each route's warm-up prediction against the native route's, rel
L2 within ``LIMITS``. A route that misses it prints no record, and the
script exits 1.

One JSON line a route on stdout, with ``bench.py``'s keys and meanings;
``--profile DIR`` then traces one more call a route (``bench_torch.profile``).
The size flags (``--mult_chan``, ``--depth``, ``--volume``, ``--patch``) cut
the run for the CPU; their defaults are the benchmark's.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench_torch.common import (
    NORTH_STAR_MULTIPLIER,
    SERVE_BASELINE_METHOD,
    V100_VOXELS_PER_SEC,
    DeviceRecord,
    backend_switches,
    device_record,
    emit,
    add_launches_since,
    kernel_launches,
    larger,
    parse_shape,
    peak_memory_gb,
    rel_l2,
    reset_peak_memory,
    seeded_state_dict,
    summary,
    timed,
)
from bench_torch.profile import profile_region
from repmode_tpu_torch.config import Config, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.infer.predict import MODES, TiledPredictor
from repmode_tpu_torch.models.reparam import make_inference, pallas_geometry_ok
from repmode_tpu_torch.utils.flops import tiled_inference_flops

VOL_SHAPE = (32, 624, 924)  # the reference's full volume (bench.py)
TASK_ID = 0
ROUTES = {"native": {"s2d": False, "pallas_conv": False},
          "s2d": {"s2d": True, "pallas_conv": False},
          "k5": {"s2d": True, "pallas_conv": True}}
# rel L2 of a route's prediction to the native route's (bf16 compute), by the
# route that ran: chip_smoke.py's serve_s2d limits
LIMITS = {"native": 0.0, "s2d": 1e-2, "k5": 2e-2}


def bench_config(batch: int = 16, predictor: str = "fused", model: Optional[ModelConfig] = None,
                 patch: Optional[tuple] = None, compute_dtype: str = "bfloat16") -> Config:
    """bench.py's Config: the defaults with batch_size_eval and bf16."""
    ev = EvalConfig(predictor=predictor)
    if patch is not None:
        ev = dataclasses.replace(ev, patch_size=tuple(patch))
    return Config(model=model or ModelConfig(),
                  train=TrainConfig(batch_size_eval=batch, compute_dtype=compute_dtype), eval=ev)


def route_config(cfg: Config, route: str) -> Config:
    return cfg.replace(eval=dataclasses.replace(cfg.eval, **ROUTES[route]))


def route_taken(cfg: Config) -> str:
    """The route ``make_inference(cfg)`` runs (its K5 geometry guard read)."""
    if not cfg.eval.s2d:
        return "native"
    return "k5" if cfg.eval.pallas_conv and pallas_geometry_ok(cfg.model) else "s2d"


def seeded_volume(shape: Sequence[int] = VOL_SHAPE, seed: int = 0) -> np.ndarray:
    """bench.py's volume: ``default_rng(seed).standard_normal`` in fp32."""
    return np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32)


def volume_flops(cfg: Config, vol_shape: Sequence[int]) -> dict:
    """The model FLOPs of one volume (``utils/flops.tiled_inference_flops``)."""
    return tiled_inference_flops(cfg.model, tuple(vol_shape), cfg.eval.patch_size,
                                 cfg.eval.overlap)


@dataclasses.dataclass
class RouteRun:
    route: str              # as asked
    taken: str              # as run
    cfg: Config
    predictor: TiledPredictor
    params: object          # the prepared plain params
    prepare_seconds: float
    first_call_seconds: float = 0.0
    first: Optional[torch.Tensor] = None  # the warm-up prediction of the seeded volume
    last: Optional[torch.Tensor] = None
    times: List[float] = dataclasses.field(default_factory=list)
    peak_gb: Optional[float] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


def prepare_route(cfg: Config, route: str, state_dict, dev: DeviceRecord) -> RouteRun:
    rcfg = route_config(cfg, route)
    prepare, forward = make_inference(rcfg)
    params, secs = timed(lambda: prepare(state_dict, TASK_ID), dev.device)
    return RouteRun(route, route_taken(rcfg), rcfg,
                    TiledPredictor(rcfg, dev.device, forward_fn=forward), params, secs)


def on_device(volume: np.ndarray, dev: DeviceRecord) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(volume, np.float32)).to(dev.device)


def warm_up(run: RouteRun, vol: torch.Tensor, dev: DeviceRecord) -> None:
    """The untimed first call on the seeded volume (builds the kernels)."""
    run.first, run.first_call_seconds = timed(lambda: run.predictor(run.params, vol), dev.device)
    run.last = run.first


def run_routes(cfg: Config, state_dict, volume: np.ndarray, routes: Sequence[str], reps: int,
               rounds: int, dev: DeviceRecord) -> Dict[str, RouteRun]:
    """Every route prepared, warmed up on the seeded volume, then timed in
    turns (the order reversed each round), each call fed the route's previous
    output."""
    vol = on_device(volume, dev)
    runs = {route: prepare_route(cfg, route, state_dict, dev) for route in routes}
    for r in range(rounds):
        for route in (routes if r % 2 == 0 else routes[::-1]):
            run = runs[route]
            reset_peak_memory(dev.device)
            if run.first is None:
                warm_up(run, vol, dev)
            before = kernel_launches()
            for _ in range(reps):
                run.last, secs = timed(lambda: run.predictor(run.params, run.last), dev.device)
                run.times.append(secs)
            add_launches_since(before, run.launches)
            run.peak_gb = larger(run.peak_gb, peak_memory_gb(dev.device))
    return runs


def native_prediction(cfg: Config, state_dict, volume: np.ndarray, runs: Dict[str, RouteRun],
                      dev: DeviceRecord) -> torch.Tensor:
    """The native route's warm-up prediction, made here when no native run was asked for."""
    if "native" in runs:
        return runs["native"].first
    ref = prepare_route(cfg, "native", state_dict, dev)
    warm_up(ref, on_device(volume, dev), dev)
    return ref.first


def serve_record(run: RouteRun, dev: DeviceRecord, vol_shape: Sequence[int], rel: float) -> dict:
    s = summary(run.times)
    best = s["median"]
    voxels = float(np.prod(vol_shape))
    vps = voxels / best
    fl = volume_flops(run.cfg, vol_shape)
    tflops = fl["total_flops"] / best / 1e12
    batches = -(-fl["n_patches"] // run.cfg.train.batch_size_eval)
    return {
        # bench.py's keys
        "metric": "full_volume_tiled_inference_throughput",
        "value": vps,
        "unit": "voxels/s",
        "vs_baseline": vps / (NORTH_STAR_MULTIPLIER * V100_VOXELS_PER_SEC),
        "volume_shape": list(vol_shape),
        "seconds_per_volume": best,
        "model_flops_per_volume": fl["total_flops"],
        "flops_per_voxel_effective": fl["flops_per_voxel_effective"],
        "tiling_redundancy": fl["redundancy"],
        "tflops_effective": tflops,
        "device_kind": dev.kind,
        "device_peak_bf16_tflops": dev.peak_bf16_tflops,
        "mfu": dev.mfu(tflops),
        "baseline_v100_voxps": V100_VOXELS_PER_SEC,
        "baseline_method": SERVE_BASELINE_METHOD,
        # the port's
        "route": run.taken,
        "route_requested": run.route,
        "predictor": run.predictor.mode,
        "batch_size_eval": run.cfg.train.batch_size_eval,
        "compute_dtype": run.cfg.train.compute_dtype,
        "power_limit_w": dev.power_limit_w,
        "times_s": run.times,
        "n_timed": s["n"],
        "p25_s": s["p25"],
        "p75_s": s["p75"],
        "prepare_seconds": run.prepare_seconds,
        "first_call_seconds": run.first_call_seconds,
        "rel_l2_vs_native": rel,
        "rel_l2_limit": LIMITS[run.taken],
        "peak_memory_gb": run.peak_gb,
        "patches_per_volume": fl["n_patches"],
        "batches_per_volume": batches,
        "launches_per_volume": {k: v / s["n"] for k, v in run.launches.items() if v},
        "switches": backend_switches(),
    }


def measure(cfg: Config, state_dict, volume: np.ndarray, routes: Sequence[str], reps: int,
            rounds: int, dev: DeviceRecord):
    """(runs, records, failures): the runs, one record a route that passed
    its correctness check, and a message a route that did not."""
    runs = run_routes(cfg, state_dict, volume, routes, reps, rounds, dev)
    ref = native_prediction(cfg, state_dict, volume, runs, dev)
    records, failures = [], []
    for route in routes:
        run = runs[route]
        rel = rel_l2(run.first, ref)
        if rel <= LIMITS[run.taken]:  # NaN or inf anywhere fails it too
            records.append(serve_record(run, dev, volume.shape, rel))
        else:
            failures.append(f"route {route} (ran {run.taken}): rel L2 {rel:.3e} to the native "
                            f"route's prediction, limit {LIMITS[run.taken]:.0e}")
    return runs, records, failures


def profile_routes(runs: Dict[str, RouteRun], volume: np.ndarray, dev: DeviceRecord,
                   out_dir: str) -> List[dict]:
    vol = on_device(volume, dev)
    recs = []
    for route, run in runs.items():
        trace = os.path.join(out_dir, f"serve_{route}.pt.trace.json")
        prof = profile_region(lambda: run.predictor(run.params, vol), dev, trace)
        recs.append({"profile": "serve", "route": run.taken, "route_requested": route,
                     "predictor": run.predictor.mode, **prof})
    return recs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--routes", default="native,s2d,k5",
                    help="comma-separated, of " + ", ".join(ROUTES))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=4, help="timed calls a route a round")
    ap.add_argument("--batch", type=int, default=16, help="batch_size_eval")
    ap.add_argument("--predictor", choices=MODES, default="fused")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the records to this file")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="then trace one call a route into DIR")
    ap.add_argument("--mult_chan", type=int, default=32)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--volume", type=parse_shape, default=VOL_SHAPE, help="D,H,W")
    ap.add_argument("--patch", type=parse_shape, default=(32, 128, 128), help="D,H,W")
    args = ap.parse_args(argv)
    args.routes = [r for r in args.routes.split(",") if r]
    bad = [r for r in args.routes if r not in ROUTES]
    if bad or not args.routes or len(set(args.routes)) != len(args.routes):
        ap.error(f"--routes: {args.routes}; each once, of {list(ROUTES)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_record(args.device)  # raises without a card unless --device cpu
    cfg = bench_config(args.batch, args.predictor,
                       ModelConfig(mult_chan=args.mult_chan, depth=args.depth), args.patch)
    state_dict = seeded_state_dict(cfg, 0, dev.device)
    volume = seeded_volume(args.volume)
    runs, records, failures = measure(cfg, state_dict, volume, args.routes, args.reps,
                                      args.rounds, dev)
    emit(records, args.out)
    if args.profile:
        passed = {r["route_requested"] for r in records}
        emit(profile_routes({k: run for k, run in runs.items() if k in passed}, volume, dev,
                            args.profile))
    for msg in failures:
        print(f"bench_torch.serve: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
