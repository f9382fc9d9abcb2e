"""The port's net against the PyTorch reference's goldens, on the CPU or the card.

The counterpart of ``tools/parity_check.py``. The goldens hold the reference
RepMode's outputs, BN running stats, loss and gradients in fp64:

  --golden tests/goldens/repmode_full_fp64.npz   (default)
      the full topology (mult_chan 32, 12 tasks) on x 2x1x16x32x32: weights
      synthesized from the golden's spec (``tools_torch/golden_common.py``);
      gradients held by per-leaf norms and three probe projections, and in
      full for the small leaves.
  --golden tests/goldens/repmode_small.npz --small
      the tiny topology (mult_chan 2, 3 tasks): its post-train state_dict
      (``sd.*``), every gradient in full.

The port keeps the reference's state_dict names and layouts, so weights,
gradients and probes are compared as they are, with no layout conversion.

Checks (each prints ``PASS``/``FAIL  <name>: err=... tol=...``; ``rel`` is a
relative L2 norm):

  train_fwd_native   train-mode forward, native layout, tasks_mixed, fresh stats
  bn_stats:<name>    every BN running stat after that forward (momentum 0.1)
  train_fwd_s2d      the same forward with ``train_s2d`` (the default layout)
  eval_fwd           eval-mode forward with the updated stats, tasks_uniform
  reparam_fwd        ``reparameterize`` then ``plain_forward`` (native route),
  reparam_fwd_s2d    ... ``plain_forward_s2d`` (the XLA s2d route),
  reparam_fwd_k5     ... ``plain_forward_s2d_pallas`` (K5) where
                     ``pallas_geometry_ok`` admits the model (bf16 arms only:
                     the route computes in bf16)
  loss, loss_s2d     the MSE to grad_target (native and s2d train step)
  grad_worst_{full,norm,probe}[_s2d]  the worst leaf of each gradient check

Arms (``--arms``; the default is ``fp64`` on the CPU and the three card arms
on the card):

  fp64             CPU only: fp64 throughout, ``train_impl`` auto (the
                   kernels' plain versions), the JAX tool's tolerances (1e-7
                   on outputs and BN stats, 1e-6 on the loss and gradients).
  fp32_expert_sum  fp32, ``train_impl`` expert_sum (``conv3d_same_autograd``,
                   cuDNN on the card), TF32 off, cuDNN deterministic; the
                   train checks only: its eval checks do not run, because K1,
                   which serves every eval conv on the card, computes in bf16
                   only. Held to ``FP32_LIMITS``, fixed at 10x the errors of
                   this arm on the CPU.
  bf16_auto        bf16 compute, ``train_impl`` auto: on the card the native
                   step runs K2-K4, the s2d step K6 and K2-K4, eval and the
                   native and s2d serving routes K1, the K5 route K5.
  bf16_expert_sum  bf16 compute, ``train_impl`` expert_sum; its serving checks
                   run the kernels' plain versions (cuDNN on the card): the
                   bf16 rounding floor. Its errors print as ``FLOOR`` lines.

Each check of ``bf16_auto`` must meet the larger of ``BF16_RULE`` and twice
``bf16_expert_sum``'s error on the same check: the same output, BN stat or
loss; a gradient leaf's full tensor against the same leaf's; a leaf's norm
or probe error, one scalar reading a leaf, against the floor's largest
reading of that check over the leaf's top-level block (``encoder_block1``,
..., ``conv_out``), because two arms' single readings of one scalar part by
more than 2x by chance. Every gradient error is relative to the leaf's own
reference gradient, the scale on which ``BF16_RULE`` is strictest.

Planted faults: in every held arm, each expert weight's gradient (the
leaves whose dW is K4's on the kernel arm) is also checked zeroed, doubled,
halved and sign-flipped, against the same limits. A fault is caught on a
leaf when one of the leaf's checks fails; ``zero`` and ``double`` must be
caught on every such leaf (``PLANT`` lines), the others are counted.

    python -m tools_torch.parity_check --device cpu [--small] [--json FILE]
    python -m tools_torch.parity_check [--json FILE]            # on the card

Exit code 0 and ``ALL CHECKS PASSED`` on success, 1 on any failure. Without a
card and without ``--device cpu`` it raises (``resolve_device``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.device import resolve_device
from repmode_tpu_torch.models import build_model, reparam
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops import mode as mode_mod
from bench_torch.common import device_record, kernel_launches
from tools_torch import golden_common as gc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL_GOLDEN = os.path.join(REPO, "tests", "goldens", "repmode_full_fp64.npz")
SMALL_GOLDEN = os.path.join(REPO, "tests", "goldens", "repmode_small.npz")


@dataclasses.dataclass(frozen=True)
class Arm:
    name: str
    param_dtype: torch.dtype
    compute_dtype: str  # TrainConfig.compute_dtype
    train_impl: str
    eval_checks: bool   # whether the eval and serving checks run


ARMS = {
    "fp64": Arm("fp64", torch.float64, "float32", "auto", True),
    "fp32_expert_sum": Arm("fp32_expert_sum", torch.float32, "float32", "expert_sum", False),
    "bf16_auto": Arm("bf16_auto", torch.float32, "bfloat16", "auto", True),
    "bf16_expert_sum": Arm("bf16_expert_sum", torch.float32, "bfloat16", "expert_sum", True),
}
DEFAULT_ARMS = {"cpu": ("fp64",), "cuda": ("fp32_expert_sum", "bf16_auto", "bf16_expert_sum")}
FLOOR_ARM = "bf16_expert_sum"
FP32_NOT_RUN = ("eval_fwd and reparam_fwd* not run: K1 (conv3d_same), which serves every "
                "eval-mode conv on the card, computes in bf16 only (ops/conv3d.py)")

# fp64: the JAX tool's tolerances (tools/parity_check.py), rel on outputs and
# BN stats, and on the loss and gradients
FP64_TOL_OUT, FP64_TOL_GRAD = 1e-7, 1e-6
# fp32_expert_sum: 10x the errors this arm measured on the CPU on the full
# golden (PERF.md section 2 states the measured errors)
FP32_LIMITS = {
    "train_fwd_native": 9.2e-05, "bn_stats": 2.5e-05, "train_fwd_s2d": 1.2e-04,
    "loss": 1.9e-07, "loss_s2d": 1.9e-07,
    "grad_full": 5.8e-02, "grad_norm": 1.4e-02, "grad_probe": 1.3e-02,
    "grad_full_s2d": 8.6e-02, "grad_norm_s2d": 2.1e-02, "grad_probe_s2d": 2.5e-02,
}
# bf16_auto's own rule (PERF.md section 2); its limit is the larger of this
# and twice bf16_expert_sum's error on the same check
BF16_RULE = {"out": 2e-2, "loss": 1e-2, "grad": 5e-2}
# planted faults: the scale a fault puts on a gradient leaf, and the faults
# every held arm must catch on every planted leaf
PLANTS = {"zero": 0.0, "double": 2.0, "half": 0.5, "flip": -1.0}
REQUIRED_PLANTS = ("zero", "double")


def planted_leaf(name: str) -> bool:
    """An expert conv weight: its dW is K4's on the kernel arm."""
    return ".expert_" in name


def check_kind(name: str) -> str:
    """The limit family of a check: train_fwd_native, bn_stats, grad_norm_s2d, ..."""
    if name.startswith("bn_stats:"):
        return "bn_stats"
    if name.startswith("grad_"):
        return name.partition(":")[0]
    return name


def bf16_rule(name: str) -> float:
    kind = check_kind(name)
    if kind.startswith("loss"):
        return BF16_RULE["loss"]
    if kind.startswith("grad_"):
        return BF16_RULE["grad"]
    return BF16_RULE["out"]


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def ndhwc(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 3, 4, 1))))


def to_ncdhw(y: torch.Tensor) -> np.ndarray:
    return np.transpose(y.detach().double().cpu().numpy(), (0, 4, 1, 2, 3))


@contextlib.contextmanager
def exact_backends():
    """TF32 off, cuDNN deterministic and no autotuner; restores the flags."""
    keys = (("cuda.matmul", "allow_tf32"), ("cudnn", "allow_tf32"),
            ("cudnn", "deterministic"), ("cudnn", "benchmark"))
    mods = {"cuda.matmul": torch.backends.cuda.matmul, "cudnn": torch.backends.cudnn}
    saved = [getattr(mods[m], k) for m, k in keys]
    for (m, k), v in zip(keys, (False, False, True, False)):
        setattr(mods[m], k, v)
    try:
        yield
    finally:
        for (m, k), v in zip(keys, saved):
            setattr(mods[m], k, v)


@contextlib.contextmanager
def counted(into: Dict[str, Dict[str, int]], name: str, device: torch.device):
    """The launches made inside the block, nonzero ones only, as into[name]."""
    before = kernel_launches()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    into[name] = {k: v - before[k] for k, v in kernel_launches().items() if v != before[k]}


@contextlib.contextmanager
def plain_serving_convs():
    """Serve through the kernels' plain versions (cuDNN on the card): the
    bf16_expert_sum arm's eval and serving checks."""
    with mock.patch.object(mode_mod, "conv3d_same", conv3d_mod.conv3d_same_plain), \
            mock.patch.object(reparam, "conv3d_same", conv3d_mod.conv3d_same_plain), \
            mock.patch.object(reparam, "conv3d_dpad", conv3d_mod.conv3d_dpad_plain):
        yield


class Golden:
    """The golden's inputs, reference outputs and the state to load."""

    def __init__(self, path: str, small: bool):
        self.z = np.load(path)
        self.small = small
        z = self.z
        if small:
            self.state = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
            self.skip = []
            self.num_tasks, self.mult_chan = 3, 2
        else:
            spec = json.loads(str(z["pspec_json"]))
            self.state = gc.synth_state_dict(spec)
            self.skip = [name for name, _, kind in spec if kind == "skip"]
            self.num_tasks, self.mult_chan = 12, 32
        self.grad_names = sorted({k[len("gnorm."):] for k in z.files if k.startswith("gnorm.")}
                                 | {k[3:] for k in z.files if k.startswith("gr.")})
        assert len(self.grad_names) > 50, self.grad_names

    def config(self, arm: Arm, train_s2d: bool) -> Config:
        return Config(
            model=ModelConfig(mult_chan=self.mult_chan, depth=4, train_s2d=train_s2d,
                              train_impl=arm.train_impl),
            data=DataConfig(adopted_datasets=tuple(f"t{i}" for i in range(self.num_tasks))),
            train=TrainConfig(compute_dtype=arm.compute_dtype),
        )

    def net(self, arm: Arm, train_s2d: bool, device: torch.device) -> torch.nn.Module:
        """The port's net with the golden's weights, strict load. The spec's
        'skip' entries (pool kernels, num_batches_tracked) are the
        architecture's constants: they keep the net's own values."""
        net = build_model(self.config(arm, train_s2d), device=device).to(arm.param_dtype)
        own = net.state_dict()
        sd = {k: own[k] for k in self.skip}
        sd.update({k: torch.from_numpy(np.asarray(v)) for k, v in self.state.items()})
        net.load_state_dict(sd, strict=True)
        return net


def leaf_block(name: str) -> str:
    """A gradient check's leaf's top-level block: ``grad_norm:encoder_block1.x.y``
    -> ``encoder_block1``."""
    return name.partition(":")[2].partition(".")[0]


class Checker:
    """Errors and limits of the checks, arm by arm, and the planted faults."""

    def __init__(self):
        self.errs: Dict[str, Dict[str, float]] = {}
        self.rows: List[dict] = []
        # arm -> fault -> leaf (suffix:name) -> {check: err}
        self.planted: Dict[str, Dict[str, Dict[str, Dict[str, float]]]] = {}
        self.plant_rows: List[dict] = []

    def record(self, arm: str, name: str, err: float):
        self.errs.setdefault(arm, {})[name] = float(err)

    def plant(self, arm: str, fault: str, leaf: str, name: str, err: float):
        self.planted.setdefault(arm, {}).setdefault(fault, {}).setdefault(leaf, {})[name] = \
            float(err)

    def floor_err(self, name: str) -> Optional[float]:
        """The floor arm's error on the same check: the same output, stat,
        loss or full gradient leaf; for a leaf's norm or probe, the floor's
        largest reading of that check over the leaf's top-level block."""
        errs = self.errs.get(FLOOR_ARM, {})
        kind = check_kind(name)
        if kind.startswith(("grad_norm", "grad_probe")):
            block = leaf_block(name)
            return max((e for n, e in errs.items()
                        if check_kind(n) == kind and leaf_block(n) == block), default=None)
        return errs.get(name)

    def limit(self, arm: str, name: str) -> Optional[float]:
        kind = check_kind(name)
        if arm == "fp64":
            return FP64_TOL_GRAD if kind.startswith(("loss", "grad_")) else FP64_TOL_OUT
        if arm == "fp32_expert_sum":
            return FP32_LIMITS[kind]
        if arm == "bf16_auto":
            floor = self.floor_err(name)
            return max(bf16_rule(name), 2 * floor) if floor is not None else bf16_rule(name)
        return None  # the floor arm: reported, not held

    def judge(self, arm: str):
        """One row a check; per-leaf gradient checks print only on failure,
        and each gradient family prints its worst leaf (err / limit)."""
        worst: Dict[str, dict] = {}
        for name, err in self.errs.get(arm, {}).items():
            tol = self.limit(arm, name)
            ok = tol is None or err <= tol
            row = {"arm": arm, "check": name, "err": err, "tol": tol, "ok": ok}
            self.rows.append(row)
            if name.startswith("grad_") and ":" in name:
                fam = check_kind(name)
                ratio = err / tol if tol else err
                if fam not in worst or ratio > worst[fam]["ratio"]:
                    worst[fam] = {"ratio": ratio, "err": err, "tol": tol, "leaf": name}
                if ok:
                    continue
            print_row(row)
        for fam, w in sorted(worst.items()):
            leaves = sum(1 for n in self.errs[arm] if n.startswith(fam + ":"))
            row = {"arm": arm, "check": f"grad_worst_{fam[len('grad_'):]}", "err": w["err"],
                   "tol": w["tol"], "ok": w["tol"] is None or w["err"] <= w["tol"],
                   "leaf": w["leaf"].partition(":")[2], "leaves": leaves}
            print_row(row, suffix=f" ({leaves} leaves; worst {row['leaf']})")

    def judge_plants(self, arm: str):
        """Per fault, the planted leaves on which one of the leaf's checks
        fails its limit; one ``PLANT`` line a fault."""
        for fault, leaves in self.planted.get(arm, {}).items():
            missed = sorted(leaf for leaf, errs in leaves.items()
                            if not any(e > self.limit(arm, n) for n, e in errs.items()))
            required = fault in REQUIRED_PLANTS
            row = {"arm": arm, "check": f"plant_{fault}", "scale": PLANTS[fault],
                   "leaves": len(leaves), "caught": len(leaves) - len(missed),
                   "missed": missed, "required": required, "ok": not (required and missed)}
            self.plant_rows.append(row)
            tag = "PLANT" if row["ok"] else "FAIL "
            need = "must catch every leaf" if required else "counted"
            print(f"{tag}  [{arm}] {fault} (x{PLANTS[fault]:g}) on the expert leaves: caught "
                  f"{row['caught']}/{row['leaves']} ({need})"
                  + (f"; missed {missed[:4]}" if missed else ""), flush=True)

    def failures(self) -> List[str]:
        return [f"[{r['arm']}] {r['check']}" for r in self.rows + self.plant_rows
                if not r["ok"]]


def summary(rows: List[dict]) -> Dict[str, Dict[str, dict]]:
    """Per arm, each check that is not a leaf or a stat as it is, and each
    family of leaf or stat checks (``bn_stats``, ``grad_norm``, ...) as its
    worst member (by err/tol, or err where there is no limit)."""
    out: Dict[str, Dict[str, dict]] = {}
    for row in rows:
        name = row["check"]
        fam = check_kind(name) if ":" in name else name
        score = row["err"] / row["tol"] if row["tol"] else row["err"]
        arm = out.setdefault(row["arm"], {})
        if fam not in arm or score > arm[fam]["score"]:
            arm[fam] = {"err": row["err"], "tol": row["tol"], "ok": row["ok"], "score": score,
                        **({"worst": name.partition(":")[2]} if ":" in name else {})}
    for arm in out.values():
        for v in arm.values():
            del v["score"]
    return out


def print_row(row: dict, suffix: str = ""):
    tag = "FLOOR" if row["tol"] is None else ("PASS" if row["ok"] else "FAIL")
    arm = "" if row["arm"] == "fp64" else f"[{row['arm']}] "
    tol = "" if row["tol"] is None else f" tol={row['tol']:.1e}"
    print(f"{tag}  {arm}{row['check']}{suffix}: err={row['err']:.3e}{tol}", flush=True)


def run_arm(arm: Arm, gold: Golden, device: torch.device, chk: Checker,
            probes: Optional[dict]) -> dict:
    """Every check of one arm; returns its routes and launches."""
    z = gold.z
    x = ndhwc(z["x"]).to(device, arm.param_dtype)
    t_mixed = torch.from_numpy(z["tasks_mixed"].astype(np.int64)).to(device)
    t_uni = torch.from_numpy(z["tasks_uniform"].astype(np.int64)).to(device)
    target = ndhwc(z["grad_target"]).to(device, arm.param_dtype)
    launches: Dict[str, Dict[str, int]] = {}
    routes: Dict[str, str] = {}
    floor_ctx = plain_serving_convs if arm.name == FLOOR_ARM else contextlib.nullcontext
    rec = lambda name, err: chk.record(arm.name, name, err)  # noqa: E731

    net = gold.net(arm, False, device)
    if not gold.small:
        # fresh running stats: the train forward reproduces the reference's
        # update. Grad stays on, as in a train step: without it the expert
        # sum would serve its convs on K1 (bf16 only on the card)
        with counted(launches, "train_fwd_native", device):
            y = net.train()(x, t_mixed).detach()
        rec("train_fwd_native", rel_l2(to_ncdhw(y), z["y_train"]))
        stats = net.state_dict()
        for k in z.files:
            if k.startswith("bs."):
                rec(f"bn_stats:{k[3:]}", rel_l2(stats[k[3:]].double().cpu().numpy(), z[k]))
        net_s2d = gold.net(arm, True, device)
        with counted(launches, "train_fwd_s2d", device):
            y = net_s2d.train()(x, t_mixed).detach()
        rec("train_fwd_s2d", rel_l2(to_ncdhw(y), z["y_train"]))
        del net_s2d

    if arm.eval_checks:
        with torch.no_grad(), floor_ctx(), counted(launches, "eval_fwd", device):
            y = net.eval()(x, t_uni)
        rec("eval_fwd", rel_l2(to_ncdhw(y), z["y_eval"]))
        task = int(z["tasks_uniform"][0])
        state = {k: v.detach() for k, v in net.state_dict().items()}
        cfg = gold.config(arm, False)
        serve = [("reparam_fwd", EvalConfig(s2d=False)), ("reparam_fwd_s2d", EvalConfig(s2d=True))]
        if arm.compute_dtype == "bfloat16":
            serve.append(("reparam_fwd_k5", EvalConfig(s2d=True, pallas_conv=True)))
        for name, ecfg in serve:
            c = cfg.replace(eval=ecfg)
            routes[name] = ("native" if not ecfg.s2d else
                            "k5" if ecfg.pallas_conv and reparam.pallas_geometry_ok(c.model)
                            else "xla_s2d")
            prepare, forward = reparam.make_inference(c)
            with torch.no_grad(), floor_ctx(), counted(launches, name, device):
                y = forward(prepare(state, task), x)
            rec(name, rel_l2(to_ncdhw(y), z["y_eval"]))
        del state

    layouts = [("", False)] if gold.small else [("", False), ("_s2d", True)]
    for suffix, s2d in layouts:
        step_net = gold.net(arm, s2d, device).train()
        with counted(launches, "loss_and_grad" + suffix, device):
            out = step_net(x, t_mixed)
            loss = torch.mean((out - target) ** 2)
            loss.backward()
        ref_loss = float(z["grad_loss"])
        rec("loss" + suffix, abs(float(loss.detach()) - ref_loss) / abs(ref_loss))
        grads = {k: p.grad for k, p in step_net.named_parameters()}
        grad_checks(arm.name, suffix, grads, gold, chk, probes, plant=arm.name != FLOOR_ARM)
        del step_net, grads, out, loss
    del net
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"routes": routes, "launches": launches}


def grad_checks(arm: str, suffix: str, grads, gold: Golden, chk: Checker,
                probes: Optional[dict], plant: bool = False):
    """Per leaf, against the golden: the full tensor where it keeps one, and
    the norm and the worst of the probe projections where it keeps those.
    With ``plant``, each expert leaf's gradient is also checked under every
    planted fault (the gradient times ``PLANTS[fault]``)."""
    for name in gold.grad_names:
        ours = grads[name].detach().double().cpu().numpy()
        faults = dict(PLANTS) if plant and planted_leaf(name) else {}
        errs = leaf_errors(ours, name, gold.z, probes, [1.0] + list(faults.values()))
        for fam, err in errs[1.0].items():
            chk.record(arm, f"{fam}{suffix}:{name}", err)
        for fault, scale in faults.items():
            for fam, err in errs[scale].items():
                chk.plant(arm, fault, f"{suffix}:{name}", f"{fam}{suffix}:{name}", err)


def leaf_errors(ours: np.ndarray, name: str, z, probes: Optional[dict],
                scales: List[float]) -> Dict[float, Dict[str, float]]:
    """The errors of ``scale * ours`` against the golden's leaf, per scale:
    ``grad_full`` (rel L2), ``grad_norm`` (rel) and ``grad_probe`` (the worst
    projection error over the Cauchy-Schwarz bound), as the golden keeps them."""
    out: Dict[float, Dict[str, float]] = {s: {} for s in scales}
    if ("gr." + name) in z.files:
        ref = z["gr." + name]
        for s in scales:
            out[s]["grad_full"] = rel_l2(ours if s == 1.0 else s * ours, ref)
    if ("gnorm." + name) in z.files:
        gn_ref = float(z["gnorm." + name])
        flat = ours.ravel()
        gn = float(np.linalg.norm(flat))
        dots_ref = np.asarray(z["gdot." + name])
        proj = []
        for j in range(int(z["n_probes"])):
            p = probes_for(probes, name, ours.shape, j)
            proj.append((float(flat @ p.ravel()), float(dots_ref[j]),
                         float(np.linalg.norm(p)) * gn_ref))
        for s in scales:
            out[s]["grad_norm"] = abs(abs(s) * gn - gn_ref) / gn_ref
            out[s]["grad_probe"] = max(abs(s * d - d_ref) / bound for d, d_ref, bound in proj)
    return out


def probes_for(cache: Optional[dict], name: str, shape, j: int) -> np.ndarray:
    """The j-th probe of a leaf (torch layout, as the golden took it), kept in
    ``cache`` where one is given (several arms read the same probes)."""
    if cache is None:
        return gc.probe(name, shape, j)
    if (name, j) not in cache:
        cache[(name, j)] = gc.probe(name, shape, j)
    return cache[(name, j)]


def run(golden: str = FULL_GOLDEN, small: bool = False, device="cuda",
        arms: Optional[List[str]] = None, json_out: Optional[str] = None) -> dict:
    """Run the checks; returns the record (``record["ok"]``), printing one
    line a check. Raises without a card unless ``device`` is the CPU."""
    dev = resolve_device(device)
    arms = list(arms or DEFAULT_ARMS[dev.type])
    if "fp64" in arms and dev.type != "cpu":
        raise ValueError("the fp64 arm runs on the CPU only: the card's kernels compute in bf16")
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        raise ValueError(f"unknown arms {unknown}; choose from {sorted(ARMS)}")
    if "bf16_auto" in arms and FLOOR_ARM in arms:  # the floor first: bf16_auto's limits read it
        arms.remove(FLOOR_ARM)
        arms.insert(arms.index("bf16_auto"), FLOOR_ARM)
    rec_dev = device_record(dev)
    if rec_dev.card:
        print(rec_dev.card, flush=True)
    gold = Golden(golden, small)
    chk = Checker()
    probes = {} if len(arms) > 1 else None
    record = {"golden": os.path.relpath(os.path.abspath(golden), REPO), "small": small,
              "device": dev.type, "kind": rec_dev.kind, "card": rec_dev.card,
              "power_limit_w": rec_dev.power_limit_w, "arms": {}}
    with exact_backends():
        for name in arms:
            arm = ARMS[name]
            t0 = time.perf_counter()
            out = run_arm(arm, gold, dev, chk, probes)
            chk.judge(name)
            chk.judge_plants(name)
            if not arm.eval_checks:
                print(f"NOTE  [{name}] {FP32_NOT_RUN}", flush=True)
                out["not_run"] = FP32_NOT_RUN
            out["seconds"] = time.perf_counter() - t0
            record["arms"][name] = out
    failures = chk.failures()
    record["summary"] = summary(chk.rows)
    record["checks"] = chk.rows
    record["planted"] = chk.plant_rows
    record["ok"] = not failures
    if json_out:
        with open(json_out, "w") as f:
            json.dump(record, f, indent=1)
    if failures:
        print(f"FAILED: {len(failures)} checks: {failures[:20]}", flush=True)
    else:
        print("ALL CHECKS PASSED", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--golden", default=None,
                    help="the golden (.npz); default: the full golden, or the small one "
                         "with --small")
    ap.add_argument("--small", action="store_true", help="the small golden's protocol")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arms", default="",
                    help=f"comma-separated arms of {sorted(ARMS)}; default: fp64 on the CPU, "
                         "fp32_expert_sum,bf16_auto,bf16_expert_sum on the card")
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: torch's)")
    ap.add_argument("--json", default=None, help="write the record here")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    golden = args.golden or (SMALL_GOLDEN if args.small else FULL_GOLDEN)
    record = run(golden, args.small, args.device, [a for a in args.arms.split(",") if a],
                 args.json)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
