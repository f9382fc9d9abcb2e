"""Train-step throughput of the port: the counterpart of ``tools/bench_train.py``.

    python -m bench_torch.train [--steps 6] [--batch 8] [--remat]
                                [--train_impl auto|expert_sum|merged_pallas|merged]
                                [--layouts native,s2d] [--decomp] [--rounds 3]
                                [--device cuda] [--out FILE]
                                [--profile DIR]

``tools/bench_train.py``'s inputs, on the card: ``ModelConfig(remat,
train_impl)`` (``train_s2d`` set by the layout), a batch of 8 patches of
32x128x128, 12 tasks, bf16 compute; ``signal``, ``target`` and ``task``
drawn from ``default_rng(0)`` in that order (channels-last, as the port's
``Batch``); weights from ``create_train_state`` with a generator seeded
0, the same for every (layout, train_impl) pair. ``--train_impl``
takes a comma-separated list.

Two protocols, as in the JAX bench: ``ms_per_step`` blocks on
``float(loss)`` after every step; ``ms_per_step_pipelined`` dispatches
``--steps`` steps and synchronises once. The pairs run in turns for
``--rounds`` rounds (the order reversed every round); each turn builds the
pair's state afresh from the weights (so only its own state is on the card,
which ``peak_memory_gb`` reads), steps once untimed, then runs ``--steps``
steps of each protocol; each pair's times are pooled. The untimed step of a
pair's first turn (which builds the kernels) is its first step; its loss is
held to the native ``expert_sum`` step's on the same weights and batch
(``LOSS_RTOL``). A pair that misses it prints no record, and the script exits
1. ``model_flops_per_step`` is 3 x n x the re-parameterized forward's FLOPs
(``utils/flops``), the same in both layouts; ``mfu`` is against the
pipelined time, as in the JAX bench.

One JSON line a pair on stdout; ``--profile DIR`` then traces one more step
a pair (``bench_torch.profile``) and, on the card, lists the host syncs of
one step (``torch.cuda.set_sync_debug_mode``). The size flags
(``--mult_chan``, ``--depth``, ``--patch``) cut the run for the CPU; their
defaults are the benchmark's.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench_torch.common import (
    TRAIN_BASELINE_METHOD,
    V100_TRAIN_RANGE,
    V100_TRAIN_VOXELS_PER_SEC,
    DeviceRecord,
    backend_switches,
    device_record,
    emit,
    add_launches_since,
    kernel_launches,
    larger,
    parse_shape,
    peak_memory_gb,
    reset_peak_memory,
    seeded_state_dict,
    summary,
    synchronize,
    timed,
)
from bench_torch.profile import NOT_MEASURED, profile_region
from repmode_tpu_torch.config import Config, ModelConfig, TrainConfig
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step
from repmode_tpu_torch.utils.flops import inference_flops_per_patch

PATCH = (32, 128, 128)
NUM_TASKS = 12   # tools/bench_train.py draws task ids from [0, 12)
LAYOUTS = ("native", "s2d")
TRAIN_IMPLS = ("auto", "expert_sum", "merged_pallas", "merged")
REFERENCE = ("native", "expert_sum")
LOSS_RTOL = 1e-2  # the training rule's loss limit (PERF.md section 2)

Pair = Tuple[str, str]  # (layout, train_impl)


def bench_config(batch: int = 8, patch: Sequence[int] = PATCH, remat: bool = False,
                 model: Optional[ModelConfig] = None, compute_dtype: str = "bfloat16") -> Config:
    """tools/bench_train.py's Config: the default model (``remat`` set) and
    data, the batch, the patch and bf16."""
    model = dataclasses.replace(model or ModelConfig(), remat=remat)
    return Config(model=model, train=TrainConfig(batch_size=batch, patch_size=tuple(patch),
                                                 compute_dtype=compute_dtype))


def pair_config(cfg: Config, layout: str, train_impl: str) -> Config:
    return cfg.replace(model=dataclasses.replace(cfg.model, train_s2d=layout == "s2d",
                                                 train_impl=train_impl))


def seeded_batch(n: int = 8, patch: Sequence[int] = PATCH, seed: int = 0) -> Dict[str, np.ndarray]:
    """tools/bench_train.py's batch: signal, target (n, D, H, W, 1) fp32 and
    task (n,) int32, drawn from ``default_rng(0)`` in that order."""
    rng = np.random.default_rng(seed)
    shape = (n,) + tuple(patch) + (1,)
    return {"signal": rng.standard_normal(shape).astype(np.float32),
            "target": rng.standard_normal(shape).astype(np.float32),
            "task": rng.integers(0, NUM_TASKS, n).astype(np.int32)}


def step_flops(cfg: Config, n: int, patch: Sequence[int]) -> int:
    """3 x forward FLOPs (forward, dx, dW) of n patches."""
    return 3 * n * inference_flops_per_patch(cfg.model, tuple(patch))


@dataclasses.dataclass
class PairRun:
    layout: str
    train_impl: str
    cfg: Config
    first_loss: float = float("nan")
    first_step_seconds: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)      # s, one step each
    pipelined: List[float] = dataclasses.field(default_factory=list)  # s a step, one a round
    peak_gb: Optional[float] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    decomp: Dict[str, float] = dataclasses.field(default_factory=dict)


def fresh_step(run: PairRun, state_dict, dev: DeviceRecord):
    """(state, step) of the pair, from the weights ``state_dict``."""
    state = create_train_state(run.cfg, device=dev.device)
    state.net.load_state_dict(state_dict, strict=True)
    return state, make_train_step(run.cfg, state)


def decompose(run: PairRun, net: torch.nn.Module, batch, steps: int, dev: DeviceRecord) -> None:
    """fwd_only_ms (the train-mode forward and its MSE, no graph) and
    fwd_bwd_ms (the same with the backward, no optimizer step), medians."""

    def loss():
        return torch.mean((net(batch["signal"], batch["task"]) - batch["target"]) ** 2)

    def fwd_only():
        with torch.no_grad():
            return loss()

    def fwd_bwd():
        net.zero_grad(set_to_none=True)
        loss().backward()

    net.train()
    for name, fn in (("fwd_only_ms", fwd_only), ("fwd_bwd_ms", fwd_bwd)):
        fn()
        run.decomp[name] = summary([timed(fn, dev.device)[1] for _ in range(steps)])["median"] * 1e3
    net.zero_grad(set_to_none=True)


def turn(run: PairRun, state_dict, batch, steps: int, dev: DeviceRecord, decomp: bool) -> None:
    """One turn of a pair: a fresh state from the weights (so no other
    pair's state is on the card and every turn starts from the same
    weights), one untimed step (the first turn's is the checked first step,
    which builds the kernels), then ``steps`` steps of each protocol."""
    state, step = fresh_step(run, state_dict, dev)
    m, secs = timed(lambda: step(batch), dev.device)
    if not run.times:
        run.first_loss, run.first_step_seconds = float(m["loss"]), secs
        if decomp:
            decompose(run, state.net, batch, steps, dev)
    reset_peak_memory(dev.device)
    before = kernel_launches()
    for _ in range(steps):
        run.times.append(timed(lambda: float(step(batch)["loss"]), dev.device)[1])

    def pipelined():
        for _ in range(steps):
            step(batch)

    run.pipelined.append(timed(pipelined, dev.device)[1] / steps)
    add_launches_since(before, run.launches)
    run.peak_gb = larger(run.peak_gb, peak_memory_gb(dev.device))


def on_device(batch_np: Dict[str, np.ndarray], dev: DeviceRecord) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev.device) for k, v in batch_np.items()}


def run_pairs(cfg: Config, state_dict, batch_np: Dict[str, np.ndarray], pairs: Sequence[Pair],
              steps: int, rounds: int, dev: DeviceRecord, decomp: bool = False) -> Dict[Pair, PairRun]:
    batch = on_device(batch_np, dev)
    runs = {pair: PairRun(*pair, pair_config(cfg, *pair)) for pair in pairs}
    for r in range(rounds):
        for pair in (pairs if r % 2 == 0 else pairs[::-1]):
            turn(runs[pair], state_dict, batch, steps, dev, decomp)
    return runs


def reference_loss(cfg: Config, state_dict, batch_np, runs: Dict[Pair, PairRun],
                   dev: DeviceRecord) -> float:
    """The native expert_sum first-step loss, stepped here when no such pair was asked for."""
    if REFERENCE in runs:
        return runs[REFERENCE].first_loss
    _, step = fresh_step(PairRun(*REFERENCE, pair_config(cfg, *REFERENCE)), state_dict, dev)
    return float(step(on_device(batch_np, dev))["loss"])


def train_record(run: PairRun, dev: DeviceRecord, n: int, patch: Sequence[int],
                 ref_loss: float) -> dict:
    s = summary(run.times)
    med = s["median"]
    piped = summary(run.pipelined)["median"]
    vox = n * int(np.prod(patch))
    flops = step_flops(run.cfg, n, patch)
    tflops = flops / piped / 1e12
    m = run.cfg.model
    return {
        # tools/bench_train.py's keys
        "batch": n,
        "patch": list(patch),
        "remat": m.remat,
        "train_impl": run.train_impl,
        "device": dev.kind,
        **run.decomp,
        "ms_per_step": med * 1e3,
        "train_voxels_per_s": vox / med,
        "ms_per_step_pipelined": piped * 1e3,
        "train_voxels_per_s_pipelined": vox / piped,
        "model_flops_per_step": flops,
        "tflops_effective": tflops,
        "device_peak_bf16_tflops": dev.peak_bf16_tflops,
        "mfu": dev.mfu(tflops),
        "baseline_v100_train_voxps": V100_TRAIN_VOXELS_PER_SEC,
        "baseline_v100_train_range": V100_TRAIN_RANGE,
        "vs_baseline_train": (vox / piped) / V100_TRAIN_VOXELS_PER_SEC,
        "baseline_method": TRAIN_BASELINE_METHOD,
        # the port's
        "layout": run.layout,
        "compute_dtype": run.cfg.train.compute_dtype,
        "power_limit_w": dev.power_limit_w,
        "times_ms": [t * 1e3 for t in run.times],
        "n_timed": s["n"],
        "p25_ms": s["p25"] * 1e3,
        "p75_ms": s["p75"] * 1e3,
        "times_ms_pipelined": [t * 1e3 for t in run.pipelined],
        "first_step_seconds": run.first_step_seconds,
        "first_loss": run.first_loss,
        "loss_rel_vs_expert_sum": abs(run.first_loss - ref_loss) / abs(ref_loss),
        "loss_rtol": LOSS_RTOL,
        "peak_memory_gb": run.peak_gb,
        "launches_per_step": {k: v / (2 * s["n"]) for k, v in run.launches.items() if v},
        "switches": {"train_s2d": m.train_s2d, "train_impl": m.train_impl, "remat": m.remat,
                     **backend_switches()},
    }


def measure(cfg: Config, state_dict, batch_np, pairs: Sequence[Pair], steps: int, rounds: int,
            dev: DeviceRecord, decomp: bool = False):
    """(runs, records, failures): the runs, one record a pair that passed its
    loss check, and a message a pair that did not."""
    runs = run_pairs(cfg, state_dict, batch_np, pairs, steps, rounds, dev, decomp)
    ref = reference_loss(cfg, state_dict, batch_np, runs, dev)
    n = int(batch_np["signal"].shape[0])
    patch = batch_np["signal"].shape[1:4]
    records, failures = [], []
    for pair in pairs:
        run = runs[pair]
        rel = abs(run.first_loss - ref) / abs(ref)
        if rel <= LOSS_RTOL:
            records.append(train_record(run, dev, n, patch, ref))
        else:
            failures.append(f"{pair}: first-step loss {run.first_loss} is {rel:.3e} from the "
                            f"native expert_sum step's {ref}, limit {LOSS_RTOL:.0e}")
    return runs, records, failures


def host_syncs(step, batch, dev: DeviceRecord):
    """Where one step makes the host wait for the card: the distinct
    warnings of ``torch.cuda.set_sync_debug_mode("warn")``, by source line."""
    if not dev.is_cuda:
        return NOT_MEASURED
    synchronize(dev.device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synchronize(dev.device)
    found: Dict[str, int] = {}
    for w in caught:
        if str(w.message).startswith("Synchronization debug mode is a prototype"):
            continue  # torch's notice on entering the mode, not a sync
        key = f"{os.path.relpath(w.filename)}:{w.lineno}: {str(w.message)[:80]}"
        found[key] = found.get(key, 0) + 1
    return found


def profile_pairs(runs: Dict[Pair, PairRun], state_dict, batch_np, dev: DeviceRecord,
                  out_dir: str) -> List[dict]:
    batch = on_device(batch_np, dev)
    recs = []
    for (layout, impl), run in runs.items():
        trace = os.path.join(out_dir, f"train_{layout}_{impl}.pt.trace.json")
        _, step = fresh_step(run, state_dict, dev)
        prof = profile_region(lambda: step(batch), dev, trace)
        recs.append({"profile": "train", "layout": layout, "train_impl": impl,
                     "host_syncs_in_a_step": host_syncs(step, batch, dev), **prof})
    return recs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6, help="steps a protocol a round")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--train_impl", default="auto",
                    help="comma-separated, of " + "|".join(TRAIN_IMPLS))
    ap.add_argument("--layouts", default="native,s2d", help="comma-separated, of native,s2d")
    ap.add_argument("--decomp", action="store_true",
                    help="also time the forward alone and forward+backward")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the records to this file")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="then trace one step a pair into DIR")
    ap.add_argument("--mult_chan", type=int, default=32)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--patch", type=parse_shape, default=PATCH, help="D,H,W")
    args = ap.parse_args(argv)
    layouts = [s for s in args.layouts.split(",") if s]
    impls = [s for s in args.train_impl.split(",") if s]
    if not layouts or any(s not in LAYOUTS for s in layouts) or len(set(layouts)) < len(layouts):
        ap.error(f"--layouts: {layouts}; each once, of {list(LAYOUTS)}")
    if not impls or any(s not in TRAIN_IMPLS for s in impls) or len(set(impls)) < len(impls):
        ap.error(f"--train_impl: {impls}; each once, of {list(TRAIN_IMPLS)}")
    args.pairs = [(layout, impl) for layout in layouts for impl in impls]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_record(args.device)  # raises without a card unless --device cpu
    cfg = bench_config(args.batch, args.patch, args.remat,
                       ModelConfig(mult_chan=args.mult_chan, depth=args.depth))
    state_dict = seeded_state_dict(cfg, 0, dev.device)
    batch = seeded_batch(args.batch, args.patch)
    runs, records, failures = measure(cfg, state_dict, batch, args.pairs, args.steps,
                                      args.rounds, dev, args.decomp)
    emit(records, args.out)
    if args.profile:
        passed = {(r["layout"], r["train_impl"]) for r in records}
        emit(profile_pairs({p: run for p, run in runs.items() if p in passed}, state_dict, batch,
                           dev, args.profile))
    for msg in failures:
        print(f"bench_torch.train: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
