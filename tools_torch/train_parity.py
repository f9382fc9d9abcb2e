"""Trained-accuracy parity of the port's arms: one init, one corpus, one recipe.

The counterpart of ``tools/train_parity.py``. Every arm trains the port's net
from the same seeded init on the same synthetic, task-conditioned corpus
(target_t = a_t * boxblur3(signal) + b_t * signal, 16^3 patches; the JAX
tool's corpus, bit for bit) with the reference recipe: Adam(lr 1e-4), MSE, BN
momentum 0.1, through the port's own ``create_train_state``,
``make_train_step`` and ``make_eval_loss_step``. Then each arm's validation
MSE per task is compared with the ``reference`` arm's.

Arms (all in the layout ``--layout native|s2d`` picks):

  reference        fp32, ``train_impl`` expert_sum (cuDNN on the card), TF32
                   off, cuDNN deterministic, no autotuner; trained twice, and
                   the record says whether the two runs are bit-identical;
  floor            ``--floor-seeds N`` retrains of ``reference``, each from
                   the init with a different single weight (of the first
                   parameter) flipped by one ulp: the chaos floor;
  auto_bf16        bf16, ``train_impl`` auto: the kernel path (K2-K4, and K6
                   in the s2d layout);
  expert_sum_bf16  bf16, ``train_impl`` expert_sum (cuDNN).

Every arm's trained net is scored by one yardstick: ``make_eval_loss_step``
of an eval net on the run's device, in bf16 on the card (K1: the card has no
fp32 eval conv) and in fp32 on the CPU.

The check: ``auto_bf16``'s largest relative val-MSE difference to
``reference`` is at most the larger of the floor's largest sample and twice
``expert_sum_bf16``'s. Exit code 1 otherwise.

    python -m tools_torch.train_parity [--steps 300 --batch 2 --mult-chan 8
        --num-tasks 12 --floor-seeds 3 --layout native --out PARITY_TRAINING_TORCH.json]
    python -m tools_torch.train_parity --device cpu --mult-chan 2 --num-tasks 3 --steps 20

The default protocol is that of the JAX package's PARITY_TRAINING_SCALE.json.
Without a card and without ``--device cpu`` it raises (``resolve_device``)
and writes no record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from repmode_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.device import resolve_device
from repmode_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from repmode_tpu_torch.train.step import make_eval_loss_step, make_train_step
from bench_torch.common import device_record, kernel_launches
from tools_torch.parity_check import exact_backends

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "PARITY_TRAINING_TORCH.json")

# Per-task target coefficients (tools/train_parity.py:31-32)
TASK_A_ALL = [1.0, -0.7, 0.4, 0.9, -0.5, 0.6, -0.8, 0.3, 0.7, -0.4, 0.5, -0.9]
TASK_B_ALL = [0.0, 0.5, -0.6, -0.3, 0.7, -0.2, 0.4, -0.8, 0.2, 0.6, -0.5, 0.3]
PATCH = (16, 16, 16)
VAL_PER_TASK = 8
VAL_SEED = 999
LR = 1e-4  # the reference recipe's Adam lr (fnet_model.py:55)

# arm -> (compute_dtype, train_impl)
ARMS = {
    "reference": ("float32", "expert_sum"),
    "auto_bf16": ("bfloat16", "auto"),
    "expert_sum_bf16": ("bfloat16", "expert_sum"),
}
RECIPE = ("Adam(lr), MSE, BN momentum 0.1, identical seeded init + batches "
          "(reference fnet_model.py:55,104-113); the port's create_train_state, "
          "make_train_step and make_eval_loss_step")


def boxblur3(x: np.ndarray) -> np.ndarray:
    """3^3 mean filter, zero 'same' padding (separable shifted adds)."""
    out = np.zeros_like(x)
    for axis in range(x.ndim - 3, x.ndim):
        out[...] = 0.0
        pad = [(0, 0)] * x.ndim
        pad[axis] = (1, 1)
        xp = np.pad(x, pad)
        n = x.shape[axis]
        sl = [slice(None)] * x.ndim
        for i in range(3):
            sl[axis] = slice(i, i + n)
            out += xp[tuple(sl)]
        x = out / 3.0
    return x


def make_batches(steps: int, batch: int, num_tasks: int, seed: int = 0):
    """[(signal, target, task)] a step, NCDHW fp32 and int64 (the JAX tool's)."""
    rng = np.random.default_rng(seed)
    task_a, task_b = TASK_A_ALL[:num_tasks], TASK_B_ALL[:num_tasks]
    batches = []
    for _ in range(steps):
        sig = rng.standard_normal((batch, 1) + PATCH).astype(np.float32)
        sig = boxblur3(sig)  # smooth-ish input, like real microscopy
        task = rng.integers(0, num_tasks, batch).astype(np.int64)
        a = np.asarray(task_a, np.float32)[task][:, None, None, None, None]
        b = np.asarray(task_b, np.float32)[task][:, None, None, None, None]
        tgt = (a * boxblur3(sig) + b * sig).astype(np.float32)
        batches.append((sig, tgt, task))
    return batches


def make_val(num_tasks: int):
    """One task-uniform batch of 8 a task, never trained on (the JAX tool's)."""
    rngv = np.random.default_rng(VAL_SEED)
    val = []
    for t in range(num_tasks):
        sig = boxblur3(rngv.standard_normal((VAL_PER_TASK, 1) + PATCH).astype(np.float32))
        task = np.full((VAL_PER_TASK,), t, np.int64)
        tgt = (TASK_A_ALL[t] * boxblur3(sig) + TASK_B_ALL[t] * sig).astype(np.float32)
        val.append((sig, tgt, task))
    return val


def to_batch(sig, tgt, task, device) -> Dict[str, torch.Tensor]:
    def ndhwc(a):
        return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 3, 4, 1)))).to(device)

    return {"signal": ndhwc(sig), "target": ndhwc(tgt), "task": torch.from_numpy(task).to(device)}


def config(mult_chan: int, num_tasks: int, batch: int, layout: str,
           compute_dtype: str = "float32", train_impl: str = "expert_sum") -> Config:
    return Config(
        model=ModelConfig(mult_chan=mult_chan, depth=4, train_impl=train_impl,
                          train_s2d=layout == "s2d"),
        data=DataConfig(adopted_datasets=tuple(f"t{i}" for i in range(num_tasks))),
        train=TrainConfig(lr=LR, compute_dtype=compute_dtype, patch_size=PATCH,
                          batch_size=batch),
    )


def seeded_init(cfg: Config, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The port's seeded init: the net ``create_train_state`` builds from a
    ``torch.Generator`` seeded ``seed``, as CPU tensors."""
    state = create_train_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    return {k: v.detach().clone() for k, v in state.net.state_dict().items()}


def flip_one_ulp(init_sd: Dict[str, torch.Tensor], first_param: str,
                 index: int) -> Dict[str, torch.Tensor]:
    """``init_sd`` with one element of ``first_param`` moved up by one fp32
    ulp (``tools/train_parity.py:99-111``): element ``index % numel``."""
    sd = dict(init_sd)
    p = sd[first_param].clone()
    flat = p.view(-1)
    i = index % flat.numel()
    flat[i] = float(np.nextafter(np.float32(flat[i].item()), np.float32(np.inf)))
    sd[first_param] = p
    return sd


def train_arm(cfg: Config, init_sd, batches, val, device: torch.device, eval_cfg: Config,
              nets: Optional[dict] = None) -> dict:
    """Train ``cfg``'s net from ``init_sd`` on ``batches`` with a fresh Adam;
    score it on ``val`` with ``eval_cfg``'s eval net. ``nets`` (a dict the
    caller keeps) holds the nets built so far by config, reloaded for each
    run: a full-width net's random init costs seconds on the host. Returns
    losses, val MSE per task, the trained state_dict (CPU), seconds and
    launches per step."""
    nets = {} if nets is None else nets
    if cfg not in nets:
        nets[cfg] = create_train_state(cfg, torch.Generator().manual_seed(0), device).net
    net = nets[cfg]
    net.load_state_dict(init_sd, strict=True)
    net.train()
    state = TrainState(net=net, optimizer=make_optimizer(cfg, net))
    step = make_train_step(cfg, state)
    dev_batches = [to_batch(*b, device) for b in batches]
    before = kernel_launches()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    losses = [step(b)["loss"] for b in dev_batches]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    launches = {k: (v - before[k]) / len(batches) for k, v in kernel_launches().items()
                if v != before[k]}
    trained = {k: v.detach().cpu().clone() for k, v in state.net.state_dict().items()}
    del state, step, dev_batches
    for p in net.parameters():
        p.grad = None
    return {"losses": [float(v) for v in losses],
            "val": score(eval_cfg, trained, val, device, nets),
            "state": trained, "train_seconds": secs, "launches_per_step": launches}


def score(eval_cfg: Config, trained, val, device: torch.device,
          nets: dict) -> Dict[str, float]:
    """Val MSE per task through ``make_eval_loss_step`` on an eval net."""
    if eval_cfg not in nets:
        nets[eval_cfg] = create_train_state(eval_cfg, torch.Generator().manual_seed(0),
                                            device).net
    net = nets[eval_cfg]
    net.load_state_dict(trained, strict=True)
    state = TrainState(net=net, optimizer=None)
    eval_step = make_eval_loss_step(eval_cfg)
    return {f"t{int(task[0])}": float(eval_step(state, to_batch(sig, tgt, task, device)))
            for sig, tgt, task in val}


def rel_diff(a: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    return {t: abs(a[t] - ref[t]) / ref[t] for t in ref}


def run(steps: int = 300, batch: int = 2, mult_chan: int = 8, num_tasks: int = 12,
        floor_seeds: int = 3, layout: str = "native", device="cuda",
        out: Optional[str] = None, log=print) -> dict:
    """Train the arms, write the record to ``out`` (if given), return it;
    ``record["ok"]`` is the check."""
    dev = resolve_device(device)
    if layout not in ("native", "s2d"):
        raise ValueError(f"layout must be native or s2d, got {layout!r}")
    card = device_record(dev)
    rec = {"steps": steps, "batch": batch, "mult_chan": mult_chan, "num_tasks": num_tasks,
           "lr": LR, "layout": layout, "recipe": RECIPE, "device": dev.type,
           "kind": card.kind, "card": card.card, "power_limit_w": card.power_limit_w,
           "init": "build_model with torch.Generator().manual_seed(0)",
           "eval_yardstick": ("make_eval_loss_step, bf16 eval net (K1)" if dev.type == "cuda"
                              else "make_eval_loss_step, fp32 eval net"),
           "arms": {a: {"compute_dtype": c, "train_impl": t} for a, (c, t) in ARMS.items()}}
    batches = make_batches(steps, batch, num_tasks, seed=0)
    val = make_val(num_tasks)
    base = config(mult_chan, num_tasks, batch, layout)
    eval_cfg = config(mult_chan, num_tasks, batch, layout,
                      compute_dtype="bfloat16" if dev.type == "cuda" else "float32")
    init_sd = seeded_init(base)
    runs, nets = {}, {}
    with exact_backends():
        for name, arm in ARMS.items():
            cfg = config(mult_chan, num_tasks, batch, layout, *arm)
            runs[name] = train_arm(cfg, init_sd, batches, val, dev, eval_cfg, nets)
            log(json.dumps({"arm": name, "val_mse": runs[name]["val"],
                            "train_seconds": runs[name]["train_seconds"]}))
        again = train_arm(base, init_sd, batches, val, dev, eval_cfg, nets)
        ref = runs["reference"]
        rec["reference_deterministic"] = bool(
            again["losses"] == ref["losses"] and again["val"] == ref["val"]
            and all(torch.equal(again["state"][k], v) for k, v in ref["state"].items()))
        log(json.dumps({"arm": "reference (again)",
                        "bit_identical": rec["reference_deterministic"]}))
        first_param = next(n for n, _ in nets[base].named_parameters())
        samples, floor_per_task = [], []
        for s in range(floor_seeds):
            fl = train_arm(base, flip_one_ulp(init_sd, first_param, s), batches, val, dev,
                           eval_cfg, nets)
            ft = rel_diff(fl["val"], ref["val"])
            floor_per_task.append(ft)
            samples.append(max(ft.values()))
            log(json.dumps({"floor_seed": s, "floor_max_rel": samples[-1]}))

    for name, r in runs.items():
        rec[f"{name}_val_mse_per_task"] = r["val"]
        rec.setdefault("final_train_loss", {})[name] = r["losses"][-1]
        rec.setdefault("loss_first10", {})[name] = r["losses"][:10]
        rec.setdefault("loss_curve", {})[name] = r["losses"][:: max(1, steps // 100)]
        rec.setdefault("train_seconds", {})[name] = r["train_seconds"]
        rec.setdefault("launches_per_step", {})[name] = r["launches_per_step"]
    rec["train_seconds"]["reference_again"] = again["train_seconds"]
    rel = rel_diff(runs["auto_bf16"]["val"], ref["val"])
    rec["val_mse_rel_diff_per_task"] = rel
    rec["max_val_mse_rel_diff"] = max(rel.values())
    rel = rel_diff(runs["expert_sum_bf16"]["val"], ref["val"])
    rec["expert_sum_bf16_val_mse_rel_diff_per_task"] = rel
    rec["expert_sum_bf16_max_val_mse_rel_diff"] = max(rel.values())
    if samples:
        rec["reference_noise_floor_rel_diff_per_task"] = floor_per_task
        rec["noise_floor_samples_max_rel"] = samples
        rec["reference_noise_floor_max"] = max(samples)
        rec["reference_noise_floor_min"] = min(samples)
        rec["reference_noise_floor_mean"] = float(np.mean(samples))
        rec["noise_floor_method"] = (
            f"{len(samples)} reference retrains, each from the init with a different single "
            f"element of {first_param} moved up by one fp32 ulp; identical data and recipe")
        rec["parity_within_noise_floor"] = bool(rec["max_val_mse_rel_diff"] <= max(samples))
    rec["limit"] = max(samples + [2 * rec["expert_sum_bf16_max_val_mse_rel_diff"]])
    rec["rule"] = ("auto_bf16's max_val_mse_rel_diff <= max(largest floor sample, "
                   "2 x expert_sum_bf16's)")
    rec["ok"] = bool(rec["max_val_mse_rel_diff"] <= rec["limit"])
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--mult-chan", type=int, default=8)
    ap.add_argument("--num-tasks", type=int, default=12)
    ap.add_argument("--floor-seeds", type=int, default=3)
    ap.add_argument("--layout", default="native", choices=("native", "s2d"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=DEFAULT_OUT, help="the record (JSON)")
    args = ap.parse_args(argv)
    rec = run(args.steps, args.batch, args.mult_chan, args.num_tasks, args.floor_seeds,
              args.layout, args.device, args.out)
    print(json.dumps({k: rec.get(k) for k in (
        "final_train_loss", "max_val_mse_rel_diff", "expert_sum_bf16_max_val_mse_rel_diff",
        "noise_floor_samples_max_rel", "reference_deterministic", "limit", "ok")}, indent=2))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
