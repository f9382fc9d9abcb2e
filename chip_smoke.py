#!/usr/bin/env python3
"""Smoke test of repmode_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout and drives
the serving path at full width (mult_chan 32, depth 4, 5^3 kernels):

  build   compile every kernel (one nvcc per source, started together);
  kernel  the conv kernel at each conv shape of the serving net at batch 8,
          held against its plain PyTorch version (TF32 off) and timed beside
          that version, a cuDNN bf16 conv (yardstick only) and its bound;
  model   the MoDE net in eval mode (12 tasks) against plain_forward of its
          re-parameterization, on one 32x128x128 patch;
  serve   cli.evaluate on a reference-layout checkpoint and synthetic data
          (the main path: launch counts are read from this run), then the
          tiled predictor on a 32x256x256 volume against the same predictor
          with the plain conv.

One JSON object per line; a failed check raises, so the script exits
non-zero and prints no result. It also fails without a CUDA card, and when
the repmode_tpu_torch package is not beside it. The last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import torch
import torch.nn.functional as F

from repmode_tpu_torch.cli import evaluate
from repmode_tpu_torch.config import (
    DEFAULT_DATASETS, Config, DataConfig, EvalConfig, ModelConfig, TrainConfig)
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models import reparam
from repmode_tpu_torch.models.repmode import MoDEConv, RepModeNet
from repmode_tpu_torch.ops.conv3d import conv3d_same, conv3d_same_plain
from repmode_tpu_torch.ops.kernels import build

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SEED = 0
# The model check's net. Its output is one 4,000-term sum (conv_out, Co=1)
# of ReLU activations, so its mean is the activations' mean times the sum of
# the merged kernel: with seed 0 that sum nearly cancels, the output's norm
# is ~7x smaller than with seed 2 and the same rounding error (every hidden
# conv agrees within ~4e-3 either way) reads as a ~7x larger relative one.
MODEL_SEED = 2
PATCH = (32, 128, 128)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def serving_convs(cfg, patch, batch):
    """Every 'same' conv of plain_forward, in launch order: name, input
    shape (N,D,H,W,Ci), Co, fused bias+ReLU, input and output dtypes."""
    c = cfg.in_channels * cfg.mult_chan
    chans = [c * 2**i for i in range(cfg.depth + 1)]
    convs = []

    def add(name, level, ci, co, in_dtype="bfloat16", bias_relu=True):
        d, h, w = (s >> level for s in patch)
        convs.append(dict(name=name, x=(batch, d, h, w, ci), co=co, bias_relu=bias_relu,
                          in_dtype=in_dtype, out_dtype="bfloat16" if bias_relu else "float32"))

    in_ch = cfg.in_channels
    for i in range(1, cfg.depth + 1):
        # the patch and the downsample outputs are fp32; conv outputs are bf16
        add(f"encoder_block{i}.conv1", i - 1, in_ch, chans[i - 1], in_dtype="float32")
        add(f"encoder_block{i}.conv2", i - 1, chans[i - 1], chans[i - 1])
        in_ch = chans[i - 1]
    add("bottle_block.conv1", cfg.depth, chans[-2], chans[-1], in_dtype="float32")
    add("bottle_block.conv2", cfg.depth, chans[-1], chans[-1])
    for i in range(cfg.depth, 0, -1):
        add(f"decoder_block{i}.conv1", i - 1, 2 * chans[i - 1], chans[i - 1])
        add(f"decoder_block{i}.conv2", i - 1, chans[i - 1], chans[i - 1])
    add("conv_out", 0, c, cfg.out_channels, bias_relu=False)
    return convs


def device_breakdown(fn, top=6):
    """One call of fn under torch.profiler: device time by kernel name and
    the device's busy share of the call's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's device time repeats its kernels'
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "top_kernels_ms": [[name[:80], ms] for name, ms in kernels[:top]],
            "conv3d_same_ms": sum(ms for name, ms in kernels if "conv3d_same_kernel" in name)}


def build_phase():
    t0 = time.perf_counter()
    report = build.build(ptxas_verbose=True)
    for name, r in report.items():
        print(f"[{name}] nvcc/ptxas:\n{r['log']}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                      for k, v in report.items()}})


def kernel_phase(convs):
    """Each distinct conv shape once: check against the plain version, time."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    distinct = {}
    for cv in convs:
        key = (cv["x"], cv["co"], cv["bias_relu"], cv["in_dtype"])
        distinct.setdefault(key, dict(cv, count=0, names=[]))
        distinct[key]["count"] += 1
        distinct[key]["names"].append(cv["name"])

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                  ops_ms=0.0, bytes_ms=0.0)
    for cv in distinct.values():
        n, d, h, w, ci = cv["x"]
        co, relu = cv["co"], cv["bias_relu"]
        odt = getattr(torch, cv["out_dtype"])
        x = torch.randn(cv["x"], generator=gen, device=dev).to(getattr(torch, cv["in_dtype"]))
        wk = torch.randn((5, 5, 5, ci, co), generator=gen, device=dev) / (125 * ci) ** 0.5
        b = torch.randn((co,), generator=gen, device=dev) * 0.1 if relu else None

        def kernel():
            return conv3d_same(x, wk, b, relu=relu, compute_dtype=torch.bfloat16, out_dtype=odt)

        def plain():
            return conv3d_same_plain(x, wk, b, relu=relu, compute_dtype=torch.bfloat16)

        xl = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)  # channels_last_3d view
        wl = wk.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        bl = None if b is None else b.to(torch.bfloat16)

        def library():
            y = F.conv3d(xl, wl, bl, padding=2)
            return torch.relu_(y) if relu else y

        # the reference is the plain version evaluated in fp64 on the same
        # bf16-rounded inputs: cuDNN may pick fp32 algorithms (FFT,
        # Winograd) whose own error exceeds a bf16 ulp near zero
        y = kernel()
        ref = conv3d_same_plain(
            x.to(torch.bfloat16).double(), wk.to(torch.bfloat16).double(),
            None if b is None else b.double(), relu=relu)
        torch.cuda.synchronize()
        err = (y.double() - ref).abs()
        top = ref.abs().max()
        if odt == torch.float32:
            tol = "max|k-r| <= 1e-3*max|r|, r = plain version in fp64"
            bad = err > 1e-3 * top
        else:
            tol = ("|k-r| <= 2^-7*|r| + 1e-4*max|r| (one bf16 ulp; the floor covers fp32 "
                   "accumulation near zero), r = plain version in fp64")
            bad = err > 2.0**-7 * ref.abs() + 1e-4 * top
        ok = not bool(bad.any())
        worst = None if ok else [float(ref[bad][0]), float(y[bad][0])]
        check(bool(torch.isfinite(y).all()) and float(top) > 0, f"{cv['names']}: degenerate")
        max_abs = float(err.max())
        del y, ref, err, bad

        kernel_ms = cuda_ms(kernel, reps=10, warmup=2)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        library_ms = cuda_ms(library, reps=10, warmup=2)
        flops = 2.0 * n * d * h * w * 125 * ci * co
        nbytes = (x.numel() * x.element_size() + wk.numel() * 2 + (0 if b is None else co * 4)
                  + n * d * h * w * co * odt.itemsize)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        emit({"phase": "kernel", "convs": cv["names"], "launches_per_batch": cv["count"],
              "x": list(cv["x"]), "co": co, "epilogue": "bias_relu" if relu else "none",
              "out_dtype": cv["out_dtype"], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "tflops": flops / kernel_ms / 1e9, "max_abs_err": max_abs, "max_abs_ref": float(top),
              "tolerance": tol, "ok": ok, "first_violation_ref_kernel": worst})
        check(ok, f"{cv['names']}: kernel disagrees with the plain version ({max_abs})")
        k = cv["count"]
        totals["ms"] += k * kernel_ms
        totals["plain_ms"] += k * plain_ms
        totals["library_ms"] += k * library_ms
        totals["bound_ms"] += k * bound_ms
        totals["ops_ms"] += k * t_ops
        totals["bytes_ms"] += k * t_bytes
        totals["max_abs_err"] = max(totals["max_abs_err"], max_abs)
        del x, wk, b, xl, wl, bl
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "per_batch_of": 8, "convs_per_batch": len(convs), **totals})
    return totals


def seeded_net(cfg, num_tasks, seed):
    """A full-width net from a seeded generator. BN running stats are drawn so
    that activations stay alive through the ReLUs and each layer contracts
    slightly: BN stats fitted to the data make this random net chaotic, and
    bf16 rounding alone then moves its output by ~25 %."""
    gen = torch.Generator().manual_seed(seed)
    net = RepModeNet(cfg, num_tasks, compute_dtype="bfloat16", generator=gen, device="cuda")
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_((torch.rand(buf.shape, generator=gen) - 0.5) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.3 + 0.3)
    return net.eval()


def model_phase(cfg, num_tasks, task=3):
    """The MoDE net in eval mode against plain_forward of its
    re-parameterization, both in bf16 compute, conv by conv and at the
    output, and both against the plain net in fp64 (cuDNN, TF32 off)."""
    t0 = time.perf_counter()
    net = seeded_net(cfg, num_tasks, MODEL_SEED)
    x = torch.randn((1, *PATCH, 1), generator=torch.Generator().manual_seed(MODEL_SEED + 1))
    x = x.cuda()
    mode_outs, plain_outs = [], []
    hooks = [m.register_forward_hook(lambda m, i, o: mode_outs.append(o))
             for m in net.modules() if isinstance(m, MoDEConv)]

    def recorded(*args, **kwargs):
        y = conv3d_same(*args, **kwargs)
        plain_outs.append(y)
        return y

    with torch.no_grad():
        y_mode = net(x, torch.tensor([task], device="cuda"))
        for h in hooks:
            h.remove()
        plain = reparam.reparameterize(net.state_dict(), cfg, num_tasks, task)
        with mock.patch.object(reparam, "conv3d_same", recorded):
            y_plain = reparam.plain_forward(plain, x, cfg, compute_dtype=torch.bfloat16)
        plain64 = {k: {kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.double() for k, v in plain.items()}
        with mock.patch.object(reparam, "conv3d_same", conv3d_same_plain):
            y64 = reparam.plain_forward(plain64, x.double(), cfg)
    torch.cuda.synchronize()
    check(len(mode_outs) == len(plain_outs) == 19, "model: expected 19 convs on each path")
    check(bool(torch.isfinite(y_mode).all()) and float(y_plain.std()) > 0,
          "model: degenerate output")
    per_conv = [rel_l2(a, b) for a, b in zip(mode_outs, plain_outs)]
    out = {"phase": "model", "seconds": time.perf_counter() - t0, "tasks": num_tasks,
           "task": task, "rel_l2_mode_vs_plain": rel_l2(y_mode, y_plain),
           "max_rel_l2_hidden_conv": max(per_conv[:-1]), "rel_l2_per_conv": per_conv,
           "rel_l2_mode_vs_fp64": rel_l2(y_mode, y64), "rel_l2_plain_vs_fp64": rel_l2(y_plain, y64),
           "out_mean": float(y_plain.mean()), "out_std": float(y_plain.std()),
           "tolerance": "rel L2 <= 2e-2 at the output (conv_out) and <= 1e-2 at each of the "
                        "18 conv+BN+ReLU outputs before it (bf16 compute)"}
    emit(out)
    check(out["rel_l2_mode_vs_plain"] <= 2e-2, "model: MoDE vs reparameterized net")
    check(out["max_rel_l2_hidden_conv"] <= 1e-2, "model: a conv output disagrees")


def serve_phase(cfg, num_convs):
    """cli.evaluate on a reference checkpoint (the main path), then the tiled
    predictor on one volume. Returns the main path's kernel launch count."""
    tasks = ("dna", "lamin_b1")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        net = seeded_net(cfg, len(tasks), SEED + 2)
        ckpt = os.path.join(tmp, "model_best.p")
        torch.save({"nn_module": "RepMode",
                    "opts": types.SimpleNamespace(adopted_datasets=list(tasks)),
                    "nn_state": {k: v.cpu() for k, v in net.state_dict().items()},
                    "count_iter": 0, "count_epoch": 0}, ckpt)
        exp_dir = os.path.join(tmp, "serve")
        conv3d_same.launches = 0
        t1 = time.perf_counter()
        log = evaluate.main(["--torch_checkpoint", ckpt, "--synthetic",
                             "--adopted_datasets", *tasks, "--path_exp_dir", exp_dir])
        torch.cuda.synchronize()
        main_launches = conv3d_same.launches
        eval_s = time.perf_counter() - t1
        csvs = [os.path.join(exp_dir, "metrics", f"{p}_serve.csv") for p in ("comp", "spec", "final")]
        # 2 tasks x 2 synthetic test volumes, one 32x128x128 patch each,
        # one batch of 8 per volume, 19 convs per batch
        expected = 2 * len(tasks) * num_convs
        emit({"phase": "serve_cli", "seconds": eval_s, "test_mse": log["metric_test/MSE"],
              "test_r2": log["metric_test/R2"], "conv3d_same_launches": main_launches,
              "expected_launches": expected, "csvs": [os.path.basename(p) for p in csvs]})
        check(all(os.path.exists(p) for p in csvs), "serve: metric CSVs missing")
        check(all(v == v and abs(v) != float("inf") for v in log.values()), "serve: non-finite metric")
        check(main_launches > 0, "serve: the conv kernel was never launched on the main path")
        check(main_launches == expected, f"serve: {main_launches} launches, expected {expected}")

        # ---- the tiled predictor on a 32x256x256 volume ----
        pcfg = Config(model=cfg, data=DataConfig(adopted_datasets=tasks),
                      train=TrainConfig(batch_size_eval=8), eval=EvalConfig(s2d=False))
        prepare, _ = reparam.make_inference(pcfg)
        with torch.no_grad():
            plain = prepare(net.state_dict(), 0)
        vol = torch.randn((32, 256, 256), generator=torch.Generator().manual_seed(SEED + 3))
        pred = TiledPredictor(pcfg)
        check(pred.num_patches(vol.shape) == 9, "serve: expected 9 patches")
        pred(plain, vol)  # warm-up
        torch.cuda.synchronize()
        conv3d_same.launches = 0
        t1 = time.perf_counter()
        y = pred(plain, vol)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        pred_launches = conv3d_same.launches
        emit({"phase": "serve_profile", **device_breakdown(lambda: pred(plain, vol))})
        with mock.patch.object(reparam, "conv3d_same", conv3d_same_plain):
            y_ref = TiledPredictor(pcfg)(plain, vol)
        torch.cuda.synchronize()
        rel = rel_l2(y, y_ref)
        emit({"phase": "serve_predictor", "volume": [32, 256, 256], "patches": 9, "batches": 2,
              "seconds": secs, "mvox_per_s": vol.numel() / secs / 1e6,
              "conv3d_same_launches": pred_launches,
              "max_abs_diff_vs_plain": float((y - y_ref).abs().max()),
              "max_abs_ref": float(y_ref.abs().max()), "rel_l2_vs_plain": rel,
              "tolerance": "rel L2 <= 1e-2", "serve_seconds": time.perf_counter() - t0})
        check(bool(torch.isfinite(y).all()) and y.shape == vol.shape, "serve: bad prediction")
        check(pred_launches == 2 * num_convs, f"serve: predictor launched {pred_launches}")
        check(rel <= 1e-2, f"serve: kernel vs plain predictor rel L2 {rel}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return main_launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = ModelConfig()  # mult_chan 32, depth 4, 5^3 kernels

    build_phase()
    t0 = time.perf_counter()
    convs = serving_convs(cfg, PATCH, batch=8)
    check(len(convs) == 19, f"expected 19 convs, got {len(convs)}")
    totals = kernel_phase(convs)
    emit({"phase": "kernel_done", "seconds": time.perf_counter() - t0})
    model_phase(cfg, len(DEFAULT_DATASETS))
    torch.cuda.empty_cache()
    main_launches = serve_phase(cfg, len(convs))

    emit({"kernels": [{
        "name": "conv3d_same", "route": "cuda",
        "source": "repmode_tpu_torch/csrc/conv3d_same.cu",
        "replaces": "repmode_tpu/ops/pallas/conv3d.py:641",
        "launches": main_launches, "max_abs_err": totals["max_abs_err"],
        "ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": "operations" if totals["ops_ms"] >= totals["bytes_ms"] else "bytes",
        "library_ms": totals["library_ms"],
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"total seconds {time.perf_counter() - t_start:.1f}", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
