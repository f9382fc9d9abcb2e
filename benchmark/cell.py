"""One run of one cell: set-up, the measured window, the check.

The program is driven through the calls its own entry points make:

- serving (``cli.evaluate`` -> ``train/loop.run_eval_pass``): per pass over
  the store, ``make_inference(cfg)``'s ``prepare`` once a task, the
  ``TiledPredictor`` on each volume, ``.cpu().numpy()``. The benchmark keeps
  every prediction (``run_eval_pass`` drops an unlabeled volume's).
- training (``cli.train`` -> ``train/loop.run_experiment``):
  ``create_train_state``, ``make_train_step``, the host ``PatchSampler``
  that ``use_device_bank`` chooses at this size, and ``run_train_epoch``,
  epoch after epoch. Set-up drives the same state through its first three
  steps with the same call and feed; the window then goes on with it.

The ``Config`` is ``cli/args.to_config`` of the arguments the configuration
and the mix give (``cli`` in each file), so the routes are the CLI's. The
window ends at the first unit (a volume, a step) that ends after
``seconds``; the feed then stops its epoch and the loop syncs as it does at
an epoch's end. Everything outside the window (set-up, the reference) is
left out of the end-to-end metrics.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, counts, data, reference, spec, trace
from benchmark.reference.precision import FP8


@dataclasses.dataclass
class Window:
    units: int = 0
    seconds: float = 0.0
    started: float = 0.0


def model_fields(cfg: dict) -> dict:
    """The fields of the port's ``ModelConfig`` that the configuration names,
    with its values: its ``model`` is the field ``name`` (its own ``name`` is
    the configuration's)."""
    from repmode_tpu_torch.config import ModelConfig

    keys = {f.name: "model" if f.name == "name" else f.name for f in dataclasses.fields(ModelConfig)}
    return {f: cfg[k] for f, k in keys.items() if k in cfg}


def program_config(cfg: dict, mix: dict, seed: int, shrink=None):
    """The CLI's Config for this cell, held to what the configuration states:
    every ``ModelConfig`` field it names, the tasks, the dtype, the learning
    rate, the mix's batch and patch. ``shrink`` (a test's small cell) sets the
    sizes the CLI has no flag for."""
    from repmode_tpu_torch.cli.args import build_parser, to_config

    sizes = [f"--{k}={mix[k]}" for k in ("batch_size", "batch_size_eval") if k in mix]
    pc = to_config(build_parser().parse_args([*cfg["cli"], *mix["cli"], *sizes, "--seed", str(seed)]))
    if shrink:
        pc = shrink(pc)
    stated = {"num_tasks": pc.num_tasks, "compute_dtype": pc.train.compute_dtype, "lr": pc.train.lr}
    wrong = {k: (v, cfg[k]) for k, v in stated.items() if cfg[k] != v}
    for f, v in model_fields(cfg).items():
        if getattr(pc.model, f) != v:
            wrong[f] = (getattr(pc.model, f), v)
    for k in ("batch_size", "batch_size_eval"):
        if k in mix and getattr(pc.train, k) != mix[k]:
            wrong[k] = (getattr(pc.train, k), mix[k])
    if list(pc.train.patch_size) != list(mix["patch_size"]):
        wrong["patch_size"] = (pc.train.patch_size, mix["patch_size"])
    if wrong:
        raise ValueError(f"the program's Config departs from the configuration: {wrong}")
    return pc


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- serving

def serve(cfg, mix, pc, state, signals, seconds, dev, tracer) -> dict:
    from repmode_tpu_torch.data.store import VolumeRecord, VolumeStore
    from repmode_tpu_torch.infer.predict import TiledPredictor
    from repmode_tpu_torch.models.reparam import make_inference

    names = pc.data.adopted_datasets
    store = VolumeStore([VolumeRecord(signal=s, target=None, dataset=names[i % len(names)],
                                      task=i % len(names), info={"path_czi": f"seeded_{i}"})
                         for i, s in enumerate(signals)], names)
    prepare, _ = make_inference(pc)
    predictor = TiledPredictor(pc, device=dev)
    cache: Dict[int, object] = {}

    def one(i: int) -> np.ndarray:   # the calls of run_eval_pass, train/loop.py:100-106
        rec = store[i % len(store)]
        if i % len(store) == 0:
            cache.clear()            # a new pass prepares every task again
        with trace.span("bench.prepare"):
            if rec.task not in cache:
                cache[rec.task] = prepare(state, rec.task)
        with trace.span("bench.predict"):
            pred = predictor(cache[rec.task], rec.signal)
        with trace.span("bench.d2h"):
            return pred.cpu().numpy()

    with torch.no_grad(), torch.device(dev):
        # warm-up: a pass's prepares, so the allocator holds what a pass's
        # cache of every task's params needs, then the one shape every
        # request has
        for rec in store.records:
            cache[rec.task] = prepare(state, rec.task)
        one(0)
    _sync(dev)
    win, preds = Window(), []
    win.started = time.perf_counter()
    deadline = win.started + seconds
    with torch.no_grad():
        while True:
            i = win.units
            tracer.before(i)
            preds.append(one(i))
            tracer.after(i)
            win.units += 1
            if time.perf_counter() >= deadline and tracer.finished():
                break
    win.seconds = time.perf_counter() - win.started
    return {"window": win, "preds": preds, "store": store}


def serve_check(cfg, mix, seed, signals, preds, dev, control: bool):
    """The reference's prediction of a seeded sample of the served volumes:
    the program's numbers, and with ``control`` the float8 reference's in the
    program's place on the same volumes (else None)."""
    rng = np.random.default_rng(seed)
    k = min(mix["checked_volumes"], len(preds))
    picks = sorted(rng.choice(len(preds), size=k, replace=False).tolist())
    state = data.seeded_weights(cfg, mix, seed, dev, signals)
    pairs, ctl = [], []
    for i in picks:
        v = i % len(signals)
        args = (state, torch.from_numpy(signals[v]).to(dev), v % cfg["num_tasks"], cfg, mix)
        ref = reference.predict_volume(*args).cpu().numpy()
        pairs.append((preds[i], ref))
        if control:
            ctl.append((reference.predict_volume(*args, prec=FP8).cpu().numpy(), ref))
    return check.serve_numbers(pairs), (check.serve_numbers(ctl) if control else None)


# ---------------------------------------------------------------- training

class Feed:
    """The sampler as ``run_train_epoch`` reads it, stopped after ``limit``
    batches or once ``done()``. A stopped epoch goes on at the next call
    (set-up's checked steps are the first of the window's first epoch); the
    one the window stops is drained afterwards (``drain``), outside the
    window, so the sampler's draws stay those of whole epochs."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.gen = None

    def epoch(self, limit: Optional[int] = None, done: Optional[Callable] = None,
              keep: Optional[list] = None):
        if self.gen is None:
            self.gen = self.sampler.epoch()
        n = 0
        while True:
            with trace.span("bench.sample"):
                batch = next(self.gen, None)
            if batch is None:
                self.gen = None
                return
            if keep is not None:
                keep.append(batch)
            yield batch
            n += 1
            if (limit is not None and n >= limit) or (done is not None and done()):
                return

    def drain(self) -> None:
        if self.gen is not None:
            for _ in self.gen:
                pass
            self.gen = None


class _Epochs:
    """What ``run_train_epoch`` takes as its sampler: ``epoch()`` of a Feed
    with the stop rule bound."""

    def __init__(self, feed: Feed, **stop):
        self.feed, self.stop = feed, stop

    def epoch(self, pad_tail_to_batch: bool = False):
        return self.feed.epoch(**self.stop)


def train(cfg, mix, pc, weights, signals, targets, seconds, dev, tracer) -> dict:
    from repmode_tpu_torch.data.sampler import PatchSampler
    from repmode_tpu_torch.data.store import VolumeRecord, VolumeStore
    from repmode_tpu_torch.train.loop import run_train_epoch, use_device_bank
    from repmode_tpu_torch.train.state import create_train_state
    from repmode_tpu_torch.train.step import make_train_step

    names = pc.data.adopted_datasets
    n = len(signals)
    store = VolumeStore([VolumeRecord(signal=signals[i % n], target=targets[i % n],
                                      dataset=names[i % n % len(names)], task=i % n % len(names),
                                      info={"path_czi": f"seeded_{i % n}"})
                         for i in range(cfg["train_records"])], names)
    bank, bank_bytes = use_device_bank(pc, store)
    with torch.device(dev):          # the program's own init runs on the card; overwritten below
        state = create_train_state(pc, None, dev)
    state.net.load_state_dict(weights, strict=True)
    step_fn = make_train_step(pc, state)
    sampler = PatchSampler(store, pc.train.batch_size, pc.train.patch_size, seed=pc.train.seed,
                           flip_prob=pc.train.random_flip_prob)
    named = list(state.net.named_parameters())

    # set-up: the first three steps, checked against the reference later
    losses: List[torch.Tensor] = []
    first_moment: List[torch.Tensor] = []

    def checked(batch):
        m = step_fn(batch)
        losses.append(m["loss"])
        if len(losses) == 1:         # Adam's first moment after step 1 is 0.1 g
            opt = state.optimizer.state
            # no moment: the step never ran Adam, and its gradient reads 0
            zero = torch.zeros((), dtype=torch.float64, device=dev)
            first_moment.append(torch.stack([
                torch.linalg.vector_norm(opt[p]["exp_avg"].double()) / 0.1 if "exp_avg" in opt[p]
                else zero for _, p in named]))
        return m

    kept: List[dict] = []
    outputs: List[torch.Tensor] = []    # the net's output in the first step's forward

    def first_output(module, args, out):
        if not outputs:
            outputs.append(out.detach().float().cpu())

    hook = state.net.register_forward_hook(first_output)
    feed = Feed(sampler)
    run_train_epoch(pc, state, checked, _Epochs(feed, limit=mix["checked_steps"], keep=kept), 0)
    hook.remove()
    with torch.no_grad():
        delta = torch.stack([torch.linalg.vector_norm((p.detach() - weights[k]).double())
                             for k, p in named])
    prog = {"losses": [float(x) for x in losses], "out1": outputs[0],
            "grad1": dict(zip([k for k, _ in named], first_moment[0].tolist())),
            "delta": dict(zip([k for k, _ in named], delta.tolist()))}
    del weights
    _free(dev)

    win, step_losses = Window(), []
    step_count = [0]

    def step(batch):
        i = step_count[0]
        tracer.before(i)
        with trace.span("bench.step"):
            m = step_fn(batch)
        step_losses.append(m["loss"])
        tracer.after(i)
        step_count[0] += 1
        return m

    _sync(dev)
    win.started = time.perf_counter()
    deadline = win.started + seconds

    def done() -> bool:
        return time.perf_counter() >= deadline and tracer.finished()

    epoch = 1
    while not done():
        run_train_epoch(pc, state, step, _Epochs(feed, done=done), epoch)  # ends in its one sync
        epoch += 1
    win.seconds = time.perf_counter() - win.started
    win.units = step_count[0]
    feed.drain()
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum()) if step_losses else 0
    return {"window": win, "prog": prog, "batches": kept, "failed": failed,
            "host_sampler": not bank, "bank_bytes": bank_bytes}


def train_check(cfg, mix, seed, prog: dict, batches, signals, dev, control: bool):
    """The reference's three steps on the same batches: the program's numbers,
    and with ``control`` the float8 reference's in its place (else None)."""
    state = data.seeded_weights(cfg, mix, seed, dev, signals)
    ref = reference.train_steps(state, batches, cfg)
    ref["out1_bf16"] = reference.train_output(state, batches[0], cfg)
    numbers = check.train_numbers(prog, ref)
    if not control:
        return numbers, None
    return numbers, check.train_numbers(reference.train_steps(state, batches, cfg, prec=FP8), ref)


# ---------------------------------------------------------------- one run

def _shrunk(small: dict):
    """A test's small cell: its sizes over the cell's, and a ``Config`` at
    those sizes (the CLI has no flag for depth, width or patch)."""
    def shrink(pc):
        patch = tuple(small["traffic"]["patch_size"])
        return pc.replace(model=dataclasses.replace(pc.model, depth=small["config"]["depth"],
                                                    mult_chan=small["config"]["mult_chan"]),
                          train=dataclasses.replace(pc.train, patch_size=patch),
                          eval=dataclasses.replace(pc.eval, patch_size=patch))
    return shrink


def run(name: str, seed: int, seconds: float, traced: bool, dev: torch.device,
        started: float, small: Optional[dict] = None, bench: Optional[dict] = None,
        marks: Optional[Dict[str, float]] = None, control: bool = False) -> dict:
    """One run of cell ``name``; ``started`` is the process's start on the
    host's ``perf_counter`` clock. ``small`` ({"config": {...}, "traffic":
    {...}}) shrinks the cell for a test on the CPU. ``control`` (calibration
    only) also reads the float8 control on the checked work. Returns the
    result's keys."""
    bench = bench or spec.benchmark()
    w = spec.workload(name, bench)
    cfg, mix, limits = spec.config(w["config"]), spec.traffic(w["traffic"]), spec.limits(name)
    if small:
        cfg, mix = {**cfg, **small["config"]}, {**mix, **small["traffic"]}
    pc = program_config(cfg, mix, seed, shrink=_shrunk(small) if small else None)
    tracer = trace.Tracer(dev, mix["trace_first"], mix["trace_units"]) if traced else \
        trace.Tracer(dev, -10, 0)
    t_cfg = time.perf_counter()
    weights, signals, targets = data.seeded(cfg, mix, seed, dev)
    phases = dict(marks or {})
    phases["program_import_and_config"] = t_cfg - started - sum(phases.values())
    phases["seeded_data"] = time.perf_counter() - t_cfg
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        if mix["kind"] == "serve":
            out = serve(cfg, mix, pc, weights, signals, seconds, dev, tracer)
        else:
            out = train(cfg, mix, pc, weights, signals, targets, seconds, dev, tracer)
            if not (out["host_sampler"] or small):
                raise ValueError(f"the mix trains from the host sampler, but cli.train would take "
                                 f"the device bank ({out['bank_bytes'] / 1e9:.2f} GB)")
    finally:
        tracer.close()
    win = out["window"]
    setup_s = win.started - started
    phases["program_setup"] = win.started - started - sum(phases.values())
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del weights
    if mix["kind"] == "serve":
        failed = sum(int(not np.isfinite(p).all()) for p in out["preds"])
        out.pop("store")
        _free(dev)
        numbers, control_numbers = serve_check(cfg, mix, seed, signals, out["preds"], dev, control)
    else:
        failed = out["failed"]
        _free(dev)
        numbers, control_numbers = train_check(cfg, mix, seed, out["prog"], out["batches"],
                                               signals, dev, control)
    correct, checks = check.judge(numbers, limits)
    result = {"correct": correct and failed == 0, "attempted": win.units, "failed": failed,
              "setup_s": setup_s, "window_s": win.seconds, "units": win.units,
              "memory_peak_bytes": peak, "numbers": numbers, "checks": checks,
              "setup_phases": phases, "check_s": time.perf_counter() - win.started - win.seconds,
              "control_numbers": control_numbers}
    if traced:
        result["trace"] = tracer.summary(spec.buckets())
        result["reading"] = _reading(cfg, mix, result["trace"], dev) if result["trace"] else None
    return result


def _reading(cfg, mix, summary: dict, dev: torch.device) -> Optional[trace.Reading]:
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = counts.peaks(kind)
    if peak is None:
        return None
    table = spec.buckets()
    units = mix["trace_units"]
    if mix["kind"] == "serve":
        flops = counts.tiled_inference_flops(cfg, mix["volume_shape"], mix["patch_size"],
                                             mix["overlap"]) * units
        bound = counts.serve_conv_bound_s(cfg, mix, peak) * units
    else:
        flops = counts.train_step_flops(cfg, mix["batch_size"], mix["patch_size"]) * units
        bound = counts.train_conv_bound_s(cfg, mix, peak) * units
    return trace.Reading(kind=mix["kind"], units=units, window_s=summary["window_s"],
                         busy_s=summary["busy_s"], bucket_s=summary["bucket_s"],
                         conv_buckets=tuple(b.name for b in table if b.conv),
                         merge_buckets=tuple(b.name for b in table if b.merge),
                         model_flops=flops, conv_bound_s=bound, peak_flops=peak[0],
                         peak_bytes_per_s=peak[1])
