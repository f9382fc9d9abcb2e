#!/usr/bin/env python3
"""Smoke test of repmode_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and drives
the serving and training paths at full width (mult_chan 32, depth 4, 5^3
kernels):

  build         compile every kernel (one nvcc per source, started together);
                whether K1's, K2/K3's, K4's, K5's and K6's libraries hold
                warpgroup MMA (HGMMA in their SASS) and whether ptxas
                serialized any;
  kernel        K1 (shared-kernel conv) at each conv shape of the serving net
                at batch 8, held against its plain PyTorch version (TF32 off)
                and timed beside that version, a cuDNN bf16 conv (yardstick
                only) and its bound; K1's launch plan at each shape
                (instance, tile, KC, stages, shared memory, registers,
                spills);
  model         the MoDE net in eval mode (12 tasks) against plain_forward of
                its re-parameterization, on one 32x128x128 patch;
  serve         cli.evaluate on a reference-layout checkpoint and synthetic
                data (the serving path: K1's launch count is read from this
                run), then the tiled predictor on a 32x256x256 volume against
                the same predictor with the plain conv;
  train_kernel  K2 (per-sample conv), K3 (its transpose, the dx) and K4 (the
                per-sample dW) at each MoDE conv shape of training at batch
                8, each held against its plain version in fp64 and timed
                beside it, a cuDNN yardstick and its bound; each kernel's
                launch plan at each shape (K2/K3: instance, tile, KC, stages,
                shared memory, grid, registers, spills; K4: instance, tile,
                taps a block, position groups, splits, stages, shared memory,
                blocks, registers, spills); every plan for the card's SM
                count, as its wrapper launches;
  train         cli.train --synthetic on the card (the training path: K2-K4
                launch counts are read from this run; K1 runs in val/test);
  train_step    the full-width train step's time, its device profile, and
                the gate-merge einsums' time;
  train_check   one bf16 step through the merged route against the same step
                through the expert-sum route (its convs through
                conv3d_same_autograd);
  train_faults  cli.train --synthetic --train_impl expert_sum for one step at
                full width (no K1 launch in the step, every parameter
                changes), then one full-width native step with remat beside
                one without, from the same weights and batch (equal
                gradients, K2 twice as often under remat, peak memory of
                both);
  ingest        the real data path: per-task train/val/test CSVs in the
                reference's schema (one unlabeled test row) and two-channel
                uint16 CZI files (one LZW-compressed), written here; cli.train
                at full width from them (host ingest with the native LZW
                decoder, --path_save_dataset, one epoch, val, the test TIFFs:
                K2-K4 launches per step and K1's in val/test read from this
                run); the saved manifests reload; the TIFFs carry the JAX
                package's names and equal a fresh predictor call; metrics.jsonl;
                cli.evaluate on the saved dataset gives the same test MSE; the
                ingest seconds (decode, LZW, normalize, resize) and the host
                sampler's share of a cli.train step (native batcher and numpy,
                against the step on a batch already on the card); its
                cli.train holds the host sampler (--on_device_pipeline off);
  unet          the UNet baseline (cli --nn_module UNet) at full width: its
                train step (time, peak memory, device profile, the same step
                under cuDNN's autotuner; no port kernel launched; every
                parameter gets a finite gradient and changes), cli.train for
                2 epochs then cli.evaluate on its .p (the same test MSE; K1
                only in val/test), the tiled predictor on a 32x256x256
                volume (Mvox/s, K1 19 launches a batch, held against the same
                net through conv3d_same_autograd);
  bank          the device bank under on_device_pipeline auto: run_experiment
                with the native net from a ragged train store of 24 volumes
                (mostly 32x624x924, 3.54 GB padded, under the 4 GiB budget):
                the bank is chosen and logged, K2-K4 19/18/19 a step, the
                run's batches repeat bit for bit from a fresh sampler, a check
                bank with NaN padding shows every crop inside its volume and
                each volume visited once an epoch; its build seconds; the
                step with the bank, with the host sampler and on a batch
                already on the card, in turns;
  s2d_kernel    K5 (the depth-padded conv chain of the space-to-depth serving
                levels) at each of its conv shapes at batch 8, held against
                its plain version in fp64 with exact-zero halo rows, timed
                beside that version, a cuDNN bf16 conv (yardstick only) and
                its bound; its launch plan at each shape (instance, tile, KC,
                stages, shared memory, grid, registers, spills);
  serve_s2d     the native, XLA s2d (K1) and K5 routes on one batch against
                each other, with their launch counts; run_eval_pass on the K5
                route (the s2d serving path: K5's launch count is read from
                this run); the tiled predictor on a 32x256x256 volume, fused
                and two_phase (equal), beside the other two routes;
  train_s2d_kernel  K6 (the tap-concat s2d entry conv) at its training shape,
                held against its plain version in fp64 and timed beside it, a
                cuDNN yardstick, K2 on the same conv, its mma.sync instance,
                a plain write of its output (the card's write floor) and its
                bound, with its launch plan (instance, tile, Co tile, blocks,
                weight loads a block, shared memory, registers, spills), the
                kernels wrapper calls launch and the bytes a call allocates
                besides y; K2, K3 and K4 at every per-sample conv shape of
                the s2d train step;
  train_s2d     run_experiment with the default ModelConfig (train_s2d, the JAX
                package's default) on synthetic data (the s2d training path:
                K6 and K2-K4 launch counts are read from this run);
  train_s2d_step  the s2d train step's time beside the native one's (one pair,
                interleaved), its device profile and peak memory;
  train_s2d_check  one bf16 step of the s2d route against the native route on
                the same weights and batch.

The phases before train_s2d_kernel build their nets with train_s2d=False:
they hold the native layout, as they did before the s2d training path.

One JSON object per line; a failed check raises, so the script exits
non-zero and prints no result. It also fails without a CUDA card, and when
the repmode_tpu_torch package is not beside it. The last line is
{"ok": true, "device": {...}}.
"""

import argparse
import csv
import json
import logging
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from repmode_tpu_torch import native
from repmode_tpu_torch.cli import evaluate
from repmode_tpu_torch.cli import train as train_cli
from repmode_tpu_torch.compat.weights import load_reference_checkpoint
from repmode_tpu_torch.config import (
    DEFAULT_DATASETS, Config, DataConfig, EvalConfig, ModelConfig, TrainConfig)
from repmode_tpu_torch.data import ingest as ingest_mod
from repmode_tpu_torch.data.czi import CziFile
from repmode_tpu_torch.data.device_sampler import DeviceVolumeBank, make_device_sampler
from repmode_tpu_torch.data.sampler import PatchSampler
from repmode_tpu_torch.data.store import VolumeRecord, VolumeStore
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models import build_model, reparam
from repmode_tpu_torch.models import unet as unet_mod
from repmode_tpu_torch.models.repmode import MoDEConv, RepModeNet
from repmode_tpu_torch.ops.conv3d import (
    conv3d_dpad,
    conv3d_dpad_plain,
    conv3d_dpad_plan,
    conv3d_dw_persample,
    conv3d_dw_persample_plain,
    conv3d_dw_persample_plan,
    conv3d_same,
    conv3d_same_persample,
    conv3d_same_persample_plain,
    conv3d_same_persample_plan,
    conv3d_same_plain,
    conv3d_same_plan,
    conv3d_tapconcat_persample,
    conv3d_tapconcat_persample_plain,
    conv3d_tapconcat_persample_plan,
)
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops.kernels import build
from repmode_tpu_torch.train import loop as loop_mod
from repmode_tpu_torch.train.loop import (
    run_eval_pass, run_experiment, run_train_epoch, run_train_epoch_device)
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step
from repmode_tpu_torch.utils import tiff

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


def profiled_events(fn, calls=1):
    """calls of fn under torch.profiler, twice: the first step is traced and
    dropped (the schedule's warm-up), the second recorded, because a session
    loses the device events of its first moments (3 calls of K6 recorded
    none, 30 recorded 25). Returns ([device events of the recorded step],
    its wall ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    # device-side events only (a CPU op's device time repeats its kernels'),
    # less the schedule's own step annotation on the device's timeline
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")], wall_ms


def device_breakdown(fn, top=6):
    """One call of fn under torch.profiler (after a warm-up call): device
    time by kernel name and the device's busy share of the call's wall
    time. Returns (summary, [(kernel name, ms)])."""
    events, wall_ms = profiled_events(fn)
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in events]
    kernels.sort(key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "top_kernels_ms": [[name[:80], ms] for name, ms in kernels[:top]],
            "conv3d_same_ms": sum(ms for name, ms in kernels if "conv3d_same_kernel" in name),
            "conv3d_dpad_ms": sum(ms for name, ms in kernels if "conv3d_dpad_kernel" in name),
            }, kernels


def launched_kernels(fn, calls=30):
    """{device kernel name: launches} that the profiler recorded in calls
    of fn (after as many calls of warm-up)."""
    return {e.key[:80]: e.count for e in profiled_events(fn, calls)[0]}


def per_sample_kernel_ms(kernels):
    """Device ms of K2, K3, K4 and K6 in a profile's kernel list."""
    def ms_of(pred):
        return sum(ms for name, ms in kernels if pred(name))

    return {"k2_ms": ms_of(lambda nm: "conv3d_persample_kernel" in nm and "false>" in nm),
            "k3_ms": ms_of(lambda nm: "conv3d_persample_kernel" in nm and "true>" in nm),
            # K4's three instances (conv3d_dw_kernel, _wide, _wgmma) and its split sum
            "k4_ms": ms_of(lambda nm: "conv3d_dw_kernel" in nm or "sum_partials_kernel" in nm),
            # K6's two instances (conv3d_tapconcat_kernel, _wgmma)
            "k6_ms": ms_of(lambda nm: "conv3d_tapconcat_kernel" in nm)}


def sass_report(name, ptxas_log):
    """Whether a kernel library was compiled to warpgroup MMA: HGMMA
    instructions in its SASS (cuobjdump -sass, where the toolkit has it), and
    the kernels whose wgmma ptxas serialized (its C7513/C7515 notes)."""
    serialized = sorted({line.split("function '")[-1].rstrip("'")
                         for line in ptxas_log.splitlines()
                         if "wgmma.mma_async instructions are serialized" in line})
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"hgmma": None, "note": "not shown: no cuobjdump in this toolkit",
                "wgmma_serialized_in": serialized}
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300).stdout
    return {"hgmma": sum("HGMMA" in line for line in sass.splitlines()),
            "kernels_with_hgmma": sum("HGMMA" in blk for blk in sass.split("Function : ")[1:]),
            "wgmma_serialized_in": serialized}


def build_phase():
    t0 = time.perf_counter()
    report = build.build(ptxas_verbose=True)
    for name, r in report.items():
        print(f"[{name}] nvcc/ptxas:\n{r['log']}", file=sys.stderr)
    # K1 (conv3d_same), K2/K3 (conv3d_persample), K4 (conv3d_dw_persample),
    # K5 (conv3d_dpad) and K6 (conv3d_tapconcat) have wgmma instances
    sass = {name: sass_report(name, report[name]["log"])
            for name in ("conv3d_same", "conv3d_persample", "conv3d_dw_persample", "conv3d_dpad",
                         "conv3d_tapconcat")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "num_sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                      for k, v in report.items()},
          **{f"{name}_sass": r for name, r in sass.items()}})
    for name, r in sass.items():
        if r["hgmma"] is not None:
            check(r["hgmma"] > 0, f"{name}'s library holds no warpgroup MMA (HGMMA)")
        check(not r["wgmma_serialized_in"],
              f"ptxas serialized the wgmma of {name}: {r['wgmma_serialized_in']}")


def kernel_phase(convs, phase="kernel"):
    """Each distinct conv shape once: check against the plain version, time.
    A conv's taps are (5,5,5) unless it names others; its epilogue is
    bias+ReLU or none (``bias_relu``) unless it names one ("bias_relu",
    "bias" or "none")."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    distinct = {}
    for cv in convs:
        cv = dict(cv, epilogue=cv.get("epilogue") or ("bias_relu" if cv["bias_relu"] else "none"))
        key = (cv["x"], cv["co"], cv["epilogue"], cv["in_dtype"], cv["out_dtype"], cv.get("taps"))
        distinct.setdefault(key, dict(cv, count=0, names=[]))
        distinct[key]["count"] += 1
        distinct[key]["names"].append(cv["name"])

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                  ops_ms=0.0, bytes_ms=0.0)
    for cv in distinct.values():
        n, d, h, w, ci = cv["x"]
        co, relu = cv["co"], cv["epilogue"] == "bias_relu"
        taps = cv.get("taps", (5, 5, 5))
        ntaps = taps[0] * taps[1] * taps[2]
        odt = getattr(torch, cv["out_dtype"])
        x = torch.randn(cv["x"], generator=gen, device=dev).to(getattr(torch, cv["in_dtype"]))
        wk = torch.randn((*taps, ci, co), generator=gen, device=dev) / (ntaps * ci) ** 0.5
        b = (None if cv["epilogue"] == "none"
             else torch.randn((co,), generator=gen, device=dev) * 0.1)

        def kernel():
            return conv3d_same(x, wk, b, relu=relu, compute_dtype=torch.bfloat16, out_dtype=odt)

        def plain():
            return conv3d_same_plain(x, wk, b, relu=relu, compute_dtype=torch.bfloat16)

        xl = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)  # channels_last_3d view
        wl = wk.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        bl = None if b is None else b.to(torch.bfloat16)

        def library():
            y = F.conv3d(xl, wl, bl, padding=tuple(k // 2 for k in taps))
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
        plan = conv3d_same_plan(cv["x"], co, taps, odt, device=dev)
        flops = 2.0 * n * d * h * w * ntaps * ci * co
        nbytes = (x.numel() * x.element_size() + wk.numel() * 2 + (0 if b is None else co * 4)
                  + n * d * h * w * co * odt.itemsize)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        emit({"phase": phase, "convs": cv["names"], "launches_per_batch": cv["count"],
              "x": list(cv["x"]), "taps": list(taps), "co": co,
              "epilogue": cv["epilogue"], "in_dtype": cv["in_dtype"],
              "out_dtype": cv["out_dtype"], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "tflops": flops / kernel_ms / 1e9, "max_abs_err": max_abs, "max_abs_ref": float(top),
              "tolerance": tol, "ok": ok, "first_violation_ref_kernel": worst,
              "plan": {"instance": plan["instance"], "tile": f"{plan['bm']}x{plan['bn']}",
                       "m64_tiles_a_warpgroup": plan["mt"], "kc": plan["kc"],
                       "stages": plan["stages"],
                       "shared_bytes": plan["smem_bytes"], "blocks": plan["blocks"],
                       "registers": plan["registers"], "spill_bytes": plan["local_bytes"]}})
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
    emit({"phase": phase, "per_batch_of": 8, "convs_per_batch": len(convs), **totals})
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
        log = evaluate.main(["--torch_checkpoint", ckpt, "--synthetic", "--debugging",
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
        emit({"phase": "serve_profile", **device_breakdown(lambda: pred(plain, vol))[0]})
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

BF16_TOL = ("|k-r| <= 2^-7*|r| + 1e-4*max|r| (one bf16 ulp; the floor covers fp32 "
            "accumulation near zero), r = plain version in fp64 on the same bf16 inputs")
DW_TOL = "max|k-r| <= 1e-3*max|r|, r = plain version in fp64 on the same bf16 inputs"
CHECKED_SAMPLES = [0, 7]  # samples are independent: two of the batch keep fp64 cheap


def check_samples(name, y, ref, fp32_out):
    """Hold kernel output y (samples CHECKED_SAMPLES) against the fp64 reference."""
    y = y[CHECKED_SAMPLES].double()
    err = (y - ref).abs()
    top = ref.abs().max()
    bad = err > 1e-3 * top if fp32_out else err > 2.0**-7 * ref.abs() + 1e-4 * top
    ok = not bool(bad.any())
    check(bool(torch.isfinite(y).all()) and float(top) > 0, f"{name}: degenerate")
    return ok, float(err.max()), float(top)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def train_kernel_phase(convs, phase="train_kernel"):
    """K2, K3 and K4 at each distinct per-sample conv shape of training at
    batch 8: each against its plain version in fp64 on samples 0 and 7, then
    timed beside its plain version (fp32, TF32 off), a cuDNN yardstick the
    port does not call, and its bound. A conv's taps are (5,5,5) unless it
    names others; K2 runs unless it says ``k2=False`` (K6 takes the s2d entry
    conv), K3 for every conv but encoder_block1.conv1, whose input is data.
    Returns per-kernel totals over one train step."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf = torch.bfloat16
    distinct = {}
    for cv in convs:
        key = (cv["x"], cv["co"], cv.get("taps", (5, 5, 5)))
        distinct.setdefault(key, dict(cv, names=[], k2_count=0))
        distinct[key]["names"].append(cv["name"])
        distinct[key]["k2_count"] += cv.get("k2", True)
    names = ("conv3d_same_persample", "conv3d_same_persample_T", "conv3d_dw_persample")
    totals = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                      bytes_ms=0.0, max_abs_err=0.0, convs=0) for k in names}
    for cv in distinct.values():
        n, d, h, w, ci = cv["x"]
        co, count = cv["co"], len(cv["names"])
        taps = cv.get("taps", (5, 5, 5))
        ntaps = taps[0] * taps[1] * taps[2]
        pads = tuple(k // 2 for k in taps)
        count_dx = sum(nm != "encoder_block1.conv1" for nm in cv["names"])
        p = d * h * w
        x = torch.randn(cv["x"], generator=gen, device=dev).to(bf)
        wk = (torch.randn((n, *taps, ci, co), generator=gen, device=dev)
              / (ntaps * ci) ** 0.5).to(bf)
        dy = torch.randn((n, d, h, w, co), generator=gen, device=dev).to(bf)
        idx = CHECKED_SAMPLES
        # cuDNN yardsticks: grouped convs on channels_last_3d copies made here
        xl = x.permute(0, 4, 1, 2, 3).reshape(1, n * ci, d, h, w).contiguous(
            memory_format=torch.channels_last_3d)
        dyl = dy.permute(0, 4, 1, 2, 3).reshape(1, n * co, d, h, w).contiguous(
            memory_format=torch.channels_last_3d)
        wl = wk.permute(0, 5, 4, 1, 2, 3).reshape(n * co, ci, *taps).contiguous(
            memory_format=torch.channels_last_3d)
        wtl = wk.flip((1, 2, 3)).permute(0, 4, 5, 1, 2, 3).reshape(n * ci, co, *taps).contiguous(
            memory_format=torch.channels_last_3d)
        flops = 2.0 * n * p * ntaps * ci * co
        wbytes = n * ntaps * ci * co
        runs = {
            "conv3d_same_persample": dict(
                count=cv["k2_count"], fp32_out=False,
                kernel=lambda: conv3d_same_persample(x, wk, compute_dtype=bf),
                plain=lambda: conv3d_same_persample_plain(x, wk, compute_dtype=bf),
                ref=lambda: conv3d_same_persample_plain(x[idx].double(), wk[idx].double()),
                library=lambda: F.conv3d(xl, wl, padding=pads, groups=n),
                library_call="F.conv3d grouped (groups=N), bf16, channels_last_3d",
                nbytes=x.numel() * 2 + wbytes * 2 + n * p * co * 2),
            "conv3d_same_persample_T": dict(
                count=count_dx, fp32_out=False,
                kernel=lambda: conv3d_same_persample(dy, wk, transpose_taps=True,
                                                     compute_dtype=bf),
                plain=lambda: conv3d_same_persample_plain(dy, wk, transpose_taps=True,
                                                          compute_dtype=bf),
                ref=lambda: conv3d_same_persample_plain(dy[idx].double(), wk[idx].double(),
                                                        transpose_taps=True),
                library=lambda: F.conv3d(dyl, wtl, padding=pads, groups=n),
                library_call="F.conv3d grouped on a flipped, io-swapped copy of w (copy "
                             "made outside the timing), bf16, channels_last_3d",
                nbytes=dy.numel() * 2 + wbytes * 2 + n * p * ci * 2),
            "conv3d_dw_persample": dict(
                count=count, fp32_out=True,
                kernel=lambda: conv3d_dw_persample(x, dy, *taps, compute_dtype=bf),
                plain=lambda: conv3d_dw_persample_plain(x, dy, *taps, compute_dtype=bf),
                ref=lambda: conv3d_dw_persample_plain(x[idx].double(), dy[idx].double(), *taps),
                library=lambda: torch.nn.grad.conv3d_weight(
                    xl, (n * co, ci, *taps), dyl, padding=pads, groups=n),
                library_call="torch.nn.grad.conv3d_weight grouped (groups=N), bf16, "
                             "channels_last_3d",
                nbytes=x.numel() * 2 + dy.numel() * 2 + wbytes * 4),
        }
        for name, r in runs.items():
            if r["count"] == 0:
                continue
            y = r["kernel"]()
            ok, max_abs, top = check_samples(f"{name} {cv['names']}", y, r["ref"](), r["fp32_out"])
            torch.cuda.synchronize()
            del y
            kernel_ms = cuda_ms(r["kernel"], reps=10, warmup=2)
            plain_ms = cuda_ms(r["plain"], reps=3, warmup=1)
            library_ms = cuda_ms(r["library"], reps=5, warmup=1)
            bound_ms, bound_by = bound(flops, r["nbytes"])
            if name == "conv3d_dw_persample":
                kp = conv3d_dw_persample_plan(cv["x"], co, taps, device=dev)
                plan = {"plan": {k: kp[k] for k in (
                    "instance", "tile_i", "tile_o", "taps_per_block", "position_groups",
                    "splits", "stages", "shared_bytes", "blocks", "threads", "accumulators",
                    "a_k_stride", "registers", "local_bytes")}}
                check(kp["instance"] != "wgmma" or kp["local_bytes"] == 0,
                      f"K4's wgmma instance spills at {cv['names']}: {kp}")
            else:
                transpose = name == "conv3d_same_persample_T"
                shape = (n, d, h, w, co) if transpose else cv["x"]
                plan = {"plan": conv3d_same_persample_plan(shape, ci if transpose else co, taps,
                                                           transpose, device=dev)}
            emit({"phase": phase, "kernel": name, "convs": cv["names"],
                  "launches_per_step": r["count"], "x": list(cv["x"]), "co": co,
                  "taps": list(taps), **plan,
                  "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "library_call": r["library_call"], "bound_ms": bound_ms, "bound_by": bound_by,
                  "tflops": flops / kernel_ms / 1e9, "max_abs_err": max_abs, "max_abs_ref": top,
                  "tolerance": DW_TOL if r["fp32_out"] else BF16_TOL, "ok": ok})
            check(ok, f"{name} {cv['names']}: kernel disagrees with the plain version ({max_abs})")
            t, k = totals[name], r["count"]
            t["ms"] += k * kernel_ms
            t["plain_ms"] += k * plain_ms
            t["library_ms"] += k * library_ms
            t["bound_ms"] += k * bound_ms
            t["ops_ms"] += k * flops / PEAK_BF16_FLOPS * 1e3
            t["bytes_ms"] += k * r["nbytes"] / PEAK_BYTES * 1e3
            t["max_abs_err"] = max(t["max_abs_err"], max_abs)
            t["convs"] += k
        del x, wk, dy, xl, dyl, wl, wtl, runs
        torch.cuda.empty_cache()
    for name, t in totals.items():
        emit({"phase": phase, "kernel": name, "per_step_of": 8, **t})
    return totals


def kernel_counts():
    return {"conv3d_same": conv3d_same.launches,
            "conv3d_same_persample": conv3d_same_persample.launches,
            "conv3d_same_persample_transpose": conv3d_same_persample.transpose_launches,
            "conv3d_dw_persample": conv3d_dw_persample.launches,
            "conv3d_dpad": conv3d_dpad.launches,
            "conv3d_tapconcat_persample": conv3d_tapconcat_persample.launches}


def reset_counts():
    conv3d_same.launches = conv3d_dw_persample.launches = conv3d_dpad.launches = 0
    conv3d_same_persample.launches = conv3d_same_persample.transpose_launches = 0
    conv3d_tapconcat_persample.launches = 0


def param_report(net, init):
    """The parameters of a trained net that lack a gradient, have a
    non-finite one, or equal their initial value in ``init``."""
    params = dict(net.named_parameters())
    return {"params_without_grad": [k for k, v in params.items() if v.grad is None],
            "params_nonfinite_grad": [k for k, v in params.items() if v.grad is not None
                                      and not bool(torch.isfinite(v.grad).all())],
            "params_unchanged": [k for k, v in init.named_parameters()
                                 if torch.equal(v, params[k])]}


def check_params(phase, report):
    check(not report["params_without_grad"] and not report["params_nonfinite_grad"],
          f"{phase}: a parameter lacks a finite gradient")
    check(not report["params_unchanged"], f"{phase}: a parameter did not change")


def hold_gradients(phase, losses, grads, a, b, ref, **extra):
    """Hold route a's loss and gradients to route b's (both bf16): loss rel
    <= 1e-2, global gradient rel L2 <= 5e-2, and every tensor's gradient
    direction. Tensors whose two bf16 gradients point apart (cosine < 0.99)
    are ones whose gradient bf16 rounding does not resolve (near-cancelling
    sums, e.g. a BN bias ahead of a batch-normalized conv); over those
    tensors together, a's error against the fp32 gradient of route ``ref``
    may be at most twice b's."""
    def cos(u, v):
        return float((u.flatten() @ v.flatten()) / (u.norm() * v.norm() + 1e-30))

    def rel(u, v):
        return float((u - v).norm() / (v.norm() + 1e-30))

    def global_rel(u, v):
        return (sum(float((u[k] - v[k]).norm() ** 2) for k in u)
                / sum(float(v[k].norm() ** 2) for k in u)) ** 0.5

    ga, gb, g32 = grads[a], grads[b], grads[ref]
    cos_ab = {k: cos(ga[k], gb[k]) for k in ga}
    total = sum(float(v.norm() ** 2) for v in g32.values())
    low = sorted(k for k in ga if cos_ab[k] < 0.99)
    unresolved = {k: {f"cos_{a}_vs_{b}": cos_ab[k], f"rel_l2_{a}_vs_fp32": rel(ga[k], g32[k]),
                      f"rel_l2_{b}_vs_fp32": rel(gb[k], g32[k]),
                      "norm_share_fp32": float(g32[k].norm() ** 2) / total} for k in low}
    pooled = ({a: global_rel({k: ga[k] for k in low}, {k: g32[k] for k in low}),
               b: global_rel({k: gb[k] for k in low}, {k: g32[k] for k in low})}
              if low else None)
    out = {"phase": phase, "losses": losses, **extra,
           "loss_rel": abs(losses[a] - losses[b]) / abs(losses[b]),
           "global_grad_rel_l2": global_rel(ga, gb), "tensors": len(ga),
           "global_grad_rel_l2_vs_fp32": {a: global_rel(ga, g32), b: global_rel(gb, g32)},
           "tensors_cosine_below_0.99": unresolved,
           "below_0.99_pooled_rel_l2_vs_fp32": pooled,
           "tolerance": f"{a} vs {b}, both bf16: loss rel <= 1e-2, global gradient rel L2 <= "
                        f"5e-2, per-tensor gradient cosine >= 0.99; over the tensors below 0.99 "
                        f"together, {a}'s rel L2 to the fp32 {ref} <= 2x {b}'s"}
    emit(out)
    check(out["loss_rel"] <= 1e-2, f"{phase}: loss differs")
    check(out["global_grad_rel_l2"] <= 5e-2, f"{phase}: gradients differ")
    check(pooled is None or pooled[a] <= 2 * pooled[b],
          f"{phase}: gradients of {low} differ beyond the bf16 rounding of {b}")


def train_phase(num_convs, tasks=DEFAULT_DATASETS[:4], epochs=3, impl="auto", phase="train"):
    """cli.train --synthetic --train_impl <impl> at full width: 4 tasks x 2
    volumes = one mixed batch of 8 per epoch, val and the best checkpoint
    after the last epoch, its reload and the test pass. The merged route
    launches K2/K3/K4 19/18/19 times a step, the expert sum none of them;
    K1 runs in val and test only. Returns the launch counts of the run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    per_step = ((num_convs, num_convs - 1, num_convs) if impl != "expert_sum" else (0, 0, 0))
    try:
        exp_dir = os.path.join(tmp, "train")
        argv = ["--synthetic", "--debugging", "--adopted_datasets", *tasks,
                "--num_epochs", str(epochs), "--interval_val", str(epochs),
                "--path_exp_dir", exp_dir, "--train_impl", impl]
        reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernel_counts()
        net = res["state"].net
        steps = res["state"].step
        # the run's initial weights, drawn again from the same seed
        init_cfg = train_cli.to_config(train_cli.build_parser().parse_args(argv))
        init = create_train_state(init_cfg, torch.Generator().manual_seed(init_cfg.train.seed),
                                  "cuda").net
        report = param_report(net, init)
        csvs = [os.path.join(exp_dir, "metrics", f"{p}_train.csv")
                for p in ("comp", "spec", "final")]
        # 2 volumes per task in val and in test, one 32x128x128 patch each:
        # one predictor batch of 8 per volume, num_convs K1 launches per batch
        k1_expected = 2 * (2 * len(tasks)) * num_convs
        out = {"phase": phase, "train_impl": impl, "seconds": secs, "tasks": list(tasks),
               "epochs": epochs, "steps": steps, "launches": counts,
               "launches_per_step": {k: counts[k] / steps for k in
                                     ("conv3d_same_persample", "conv3d_same_persample_transpose",
                                      "conv3d_dw_persample")},
               "k1_launches_val_test": counts["conv3d_same"], "k1_expected": k1_expected,
               "train_loss": res["train_log"]["loss/epoch"],
               "test_mse": res["test_log"]["metric_test/MSE"],
               "best_path": os.path.basename(res["best_path"] or ""), **report}
        emit(out)
        check(steps == epochs, f"{phase}: {steps} steps, expected {epochs}")
        for k, v in zip(("conv3d_same_persample", "conv3d_same_persample_transpose",
                         "conv3d_dw_persample"), per_step):
            check(counts[k] == v * steps, f"{phase}: {k} launched {counts[k]} times in {steps} "
                                          f"steps, expected {v} per step")
        # K1 launches in val/test only: none in the train steps
        check(counts["conv3d_same"] == k1_expected, f"{phase}: K1 launches outside val/test")
        check(abs(out["train_loss"]) < float("inf") and out["train_loss"] == out["train_loss"],
              f"{phase}: non-finite loss")
        check_params(phase, report)
        check(res["best_path"] is not None, f"{phase}: no best checkpoint")
        check(all(os.path.exists(p) for p in csvs), f"{phase}: metric CSVs missing")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def full_width_batch(num_tasks, batch=8, seed=SEED + 20):
    gen = torch.Generator().manual_seed(seed)
    sig = torch.randn((batch, *PATCH, 1), generator=gen)
    return {"signal": sig.cuda(), "target": (0.5 * sig + 0.1 * torch.randn(
                sig.shape, generator=gen)).cuda(),
            "task": (torch.arange(batch) % num_tasks).int().cuda()}


def train_step_phase(convs, num_tasks, steps=6):
    """The full-width train step (batch 8, mixed tasks, bf16): its time
    (median over steps after one warm-up), its device profile, and the time
    of the gate-merge einsums (forward and backward) at the 19 conv shapes."""
    cfg = Config(model=ModelConfig(train_s2d=False),
                 data=DataConfig(adopted_datasets=DEFAULT_DATASETS[:num_tasks]))
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED + 21), "cuda")
    step = make_train_step(cfg, state)
    batch = full_width_batch(num_tasks)
    torch.cuda.reset_peak_memory_stats()
    step(batch)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof, kernels = device_breakdown(lambda: step(batch), top=10)
    del prof["conv3d_same_ms"], prof["conv3d_dpad_ms"]
    kms = per_sample_kernel_ms(kernels)

    # the gate merge of every MoDE conv: einsum forward, then its backward
    # (gradients of the bank and of the gate) from a per-sample dW
    merge_ms = 0.0
    dev = torch.device("cuda")
    for cv in convs:
        n, _, _, _, ci = cv["x"]
        co = cv["co"]
        bank = torch.randn((5, 5, 5, 5, ci, co), device=dev, requires_grad=True)
        g = torch.rand((n, 5, co), device=dev, requires_grad=True)
        dwn = torch.randn((n, 5, 5, 5, ci, co), device=dev)

        def merge():
            torch.einsum("neo,edhwio->ndhwio", g, bank).backward(dwn)

        merge_ms += cuda_ms(merge, reps=3, warmup=1)
        del bank, g, dwn
    torch.cuda.empty_cache()
    times.sort()
    out = {"phase": "train_step", "batch": 8, "patch": list(PATCH), "tasks": num_tasks,
           "step_ms_median": times[len(times) // 2], "step_ms_all": times,
           "peak_memory_gb": peak_gb, **prof, "k2_ms": kms["k2_ms"], "k3_ms": kms["k3_ms"],
           "k4_ms": kms["k4_ms"], "gate_merge_einsum_ms": merge_ms,
           "gate_merge_note": "forward einsum + its backward at the 19 conv shapes, fp32, "
                              "timed apart from the step with CUDA events"}
    emit(out)
    check(out["k2_ms"] > 0 and out["k3_ms"] > 0 and out["k4_ms"] > 0,
          "train_step: a per-sample kernel is missing from the profile")
    del state, step
    torch.cuda.empty_cache()


def train_check_phase(num_tasks):
    """One full-width forward+backward, batch 8, from the same weights on the
    same batch, three ways: the merged route in bf16 (K2-K4), the expert-sum
    route in bf16 and the expert-sum route in fp32 (both with their convs
    through conv3d_same_autograd). The merged route is held to the bf16
    expert sum by ``hold_gradients``."""
    cfg = Config(model=ModelConfig(train_s2d=False),
                 data=DataConfig(adopted_datasets=DEFAULT_DATASETS[:num_tasks]))
    batch = full_width_batch(num_tasks, seed=SEED + 30)
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED + 31), "cuda")
    net = state.net
    grads, losses, peaks = {}, {}, {}
    for run, impl, cdt in (("merged", "auto", torch.bfloat16),
                           ("expert_sum", "expert_sum", torch.bfloat16),
                           ("expert_sum_fp32", "expert_sum", None)):
        for m in net.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = cdt
            if isinstance(m, MoDEConv):
                m.train_impl = impl
        net.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        loss = ((net(batch["signal"], batch["task"]) - batch["target"]) ** 2).mean()
        loss.backward()
        losses[run] = float(loss.detach())
        peaks[run] = torch.cuda.max_memory_allocated() / 1e9
        grads[run] = {k: v.grad.detach().double() for k, v in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        del loss
        torch.cuda.empty_cache()

    hold_gradients("train_check", losses, grads, "merged", "expert_sum", "expert_sum_fp32",
                   peak_memory_gb=peaks)
    del state, net, grads
    torch.cuda.empty_cache()


def train_remat_check(num_tasks):
    """One full-width native forward+backward (batch 8, bf16) with remat and
    one without, from the same weights on the same batch: each gradient
    bit-identical or within K4's tolerance (max|a-b| <= 1e-3 max|b|), K2
    launched twice as often under remat (the backward recomputes the
    forward), K3 and K4 as often; peak memory of both."""
    batch = full_width_batch(num_tasks, seed=SEED + 70)
    state = create_train_state(s2d_config(num_tasks, train_s2d=False),
                               torch.Generator().manual_seed(SEED + 71), "cuda").net.state_dict()
    state = {k: v.clone() for k, v in state.items()}
    grads, losses, peaks, counts = {}, {}, {}, {}
    for remat in (False, True):
        net = RepModeNet(s2d_config(num_tasks, train_s2d=False, remat=remat).model, num_tasks,
                         compute_dtype="bfloat16", device="cuda")
        net.load_state_dict(state, strict=True)
        net.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss = ((net(batch["signal"], batch["task"]) - batch["target"]) ** 2).mean()
        loss.backward()
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 1e9
        counts[remat] = kernel_counts()
        losses[remat] = float(loss.detach())
        grads[remat] = {k: v.grad.detach().clone() for k, v in net.named_parameters()}
        del net, loss
        torch.cuda.empty_cache()
    g0, g1 = grads[False], grads[True]
    identical = sum(bool(torch.equal(g0[k], g1[k])) for k in g0)
    worst = max(float((g1[k] - g0[k]).abs().max() / g0[k].abs().max().clamp_min(1e-30))
                for k in g0)
    out = {"phase": "train_faults_remat", "losses": {str(k): v for k, v in losses.items()},
           "peak_memory_gb": {"remat": peaks[True], "no_remat": peaks[False]},
           "launches": {"remat": counts[True], "no_remat": counts[False]},
           "tensors": len(g0), "tensors_bit_identical": identical,
           "max_rel_grad_diff": worst,
           "tolerance": "each gradient bit-identical or max|a-b| <= 1e-3 max|b|"}
    emit(out)
    check(abs(losses[True] - losses[False]) <= 1e-6 * abs(losses[False]),
          "train_faults: remat changed the loss")
    check(worst <= 1e-3, "train_faults: remat changed a gradient")
    for k, factor in (("conv3d_same_persample", 2), ("conv3d_same_persample_transpose", 1),
                      ("conv3d_dw_persample", 1)):
        check(counts[False][k] > 0 and counts[True][k] == factor * counts[False][k],
              f"train_faults: {k} launched {counts[True][k]} times under remat, "
              f"{counts[False][k]} without")
    check(counts[True]["conv3d_same"] == counts[False]["conv3d_same"] == 0,
          "train_faults: K1 launched in a train step")
    del grads
    torch.cuda.empty_cache()


def train_faults_phase(num_convs, num_tasks):
    """The training options that must work on the card as in JAX: one
    cli.train step through the expert sum, and remat."""
    train_phase(num_convs, epochs=1, impl="expert_sum", phase="train_faults_expert_sum")
    torch.cuda.empty_cache()
    train_remat_check(num_tasks)

# ------------------------------------------------ space-to-depth serving (K5)


def s2d_dpad_convs(cfg, patch, batch):
    """Every K5 conv of plain_forward_s2d_pallas in launch order: name,
    depth-padded input shape (N, D+kD-1, H/2, W/2, Ci) in s2d channels, Co.
    encoder_block1.conv1 (4 s2d input channels) runs on K1 instead."""
    levels = reparam.default_s2d_levels(cfg)
    pd = (cfg.kernel_size - 1) // 2
    c = [4 * cfg.in_channels * cfg.mult_chan * 2**i for i in range(cfg.depth)]
    convs = []

    def add(name, level, ci, co):
        d, h, w = (s >> (level - 1) for s in patch)
        convs.append(dict(name=name, x=(batch, d + 2 * pd, h // 2, w // 2, ci), co=co))

    for i in levels:
        if i > 1:
            add(f"encoder_block{i}.conv1", i, c[i - 2], c[i - 1])
        add(f"encoder_block{i}.conv2", i, c[i - 1], c[i - 1])
    for i in reversed(levels):
        add(f"decoder_block{i}.conv1", i, 2 * c[i - 1], c[i - 1])
        add(f"decoder_block{i}.conv2", i, c[i - 1], c[i - 1])
    return convs


def s2d_kernel_phase(cfg, batch=8):
    """K5 at each distinct conv shape of the K5 route at batch 8: against its
    plain version in fp64 on samples 0 and 7, halo rows exactly zero, then
    timed beside its plain version (fp32, TF32 off), a cuDNN bf16 conv over
    the padded rows (a yardstick the port does not call) and its bound.
    The plan of each shape is printed beside its time.
    Returns K5's totals per batch. (K1 at the s2d routes' shapes is held in
    serve_s2d_phase, at every call the routes make.)"""
    convs = s2d_dpad_convs(cfg, PATCH, batch)
    check(len(convs) == 7, f"expected 7 K5 convs, got {len(convs)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    bf = torch.bfloat16
    kd = cfg.kernel_size
    pd = (kd - 1) // 2
    distinct = {}
    for cv in convs:
        distinct.setdefault((cv["x"], cv["co"]), dict(cv, names=[]))["names"].append(cv["name"])
    check(len(distinct) == 5, f"expected 5 distinct K5 shapes, got {len(distinct)}")
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                  bytes_ms=0.0, max_abs_err=0.0, convs=0)
    for cv in distinct.values():
        n, dp, h, w, ci = cv["x"]
        co, count, d = cv["co"], len(cv["names"]), cv["x"][1] - 2 * pd
        x = torch.zeros(cv["x"], dtype=bf, device=dev)
        x[:, pd:dp - pd] = torch.randn((n, d, h, w, ci), generator=gen, device=dev).to(bf)
        wk = (torch.randn((kd, 3, 3, ci, co), generator=gen, device=dev)
              / (kd * 9 * ci) ** 0.5).to(bf)
        b = torch.randn((co,), generator=gen, device=dev) * 0.1
        xl = x.permute(0, 4, 1, 2, 3)  # channels_last_3d view
        wl = wk.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        bl = b.to(bf)

        def kernel():
            return conv3d_dpad(x, wk, b, relu=True)

        def plain():
            return conv3d_dpad_plain(x, wk, b, relu=True, compute_dtype=bf)

        def library():
            return torch.relu_(F.conv3d(xl, wl, bl, padding=(0, 1, 1)))

        y = kernel()
        torch.cuda.synchronize()
        halo_zero = bool((y[:, :pd] == 0).all()) and bool((y[:, dp - pd:] == 0).all())
        ref = conv3d_dpad_plain(x[CHECKED_SAMPLES].double(), wk.double(), b.double(), relu=True)
        ok, max_abs, top = check_samples(f"conv3d_dpad {cv['names']}", y, ref, fp32_out=False)
        del y, ref
        torch.cuda.empty_cache()
        kernel_ms = cuda_ms(kernel, reps=10, warmup=2)
        plan = conv3d_dpad_plan(cv["x"], co, (kd, 3, 3), device=dev)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        library_ms = cuda_ms(library, reps=10, warmup=2)
        flops = 2.0 * n * d * h * w * kd * 9 * ci * co
        nbytes = x.numel() * 2 + wk.numel() * 2 + co * 4 + n * dp * h * w * co * 2
        bound_ms, bound_by = bound(flops, nbytes)
        emit({"phase": "s2d_kernel", "kernel": "conv3d_dpad", "convs": cv["names"],
              "launches_per_batch": count, "x_padded": list(cv["x"]), "taps": [kd, 3, 3],
              "co": co, "plan": plan, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library_call": "F.conv3d bf16, channels_last_3d, padding (0,1,1) over the "
                              "padded rows, bias, ReLU",
              "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / kernel_ms / 1e9,
              "max_abs_err": max_abs, "max_abs_ref": top, "halo_rows_zero": halo_zero,
              "tolerance": BF16_TOL, "ok": ok})
        check(halo_zero, f"conv3d_dpad {cv['names']}: a halo row is not zero")
        check(ok, f"conv3d_dpad {cv['names']}: kernel disagrees with the plain version "
                  f"({max_abs})")
        totals["ms"] += count * kernel_ms
        totals["plain_ms"] += count * plain_ms
        totals["library_ms"] += count * library_ms
        totals["bound_ms"] += count * bound_ms
        totals["ops_ms"] += count * flops / PEAK_BF16_FLOPS * 1e3
        totals["bytes_ms"] += count * nbytes / PEAK_BYTES * 1e3
        totals["max_abs_err"] = max(totals["max_abs_err"], max_abs)
        totals["convs"] += count
        del x, wk, b, xl, wl, bl
        torch.cuda.empty_cache()
    emit({"phase": "s2d_kernel", "kernel": "conv3d_dpad", "per_batch_of": batch, **totals})
    return totals


def s2d_k1_names(cfg, levels, route):
    """The K1 calls of an s2d route ("xla_s2d" or "k5") in launch order."""
    names = []
    for i in range(1, cfg.depth + 1):
        if route == "k5" and i in levels:  # K5 takes all but the 4-channel entry conv
            names += ["encoder_block1.conv1 (s2d)"] if i == 1 else []
        else:
            s2d = " (s2d)" if i in levels else ""
            names += [f"encoder_block{i}.conv1{s2d}", f"encoder_block{i}.conv2{s2d}"]
    names += ["bottle_block.conv1", "bottle_block.conv2"]
    for i in range(cfg.depth, 0, -1):
        if i not in levels:
            names += [f"decoder_block{i}.conv1", f"decoder_block{i}.conv2"]
        elif route == "xla_s2d":
            names += [f"decoder_block{i}.conv1 (s2d, skip half)",
                      f"decoder_block{i}.conv1 (s2d, up half)", f"decoder_block{i}.conv2 (s2d)"]
    return names + (["conv_out (s2d)"] if route == "k5" else [])  # XLA route: tap-major


def recording_k1(calls):
    """A stand-in for reparam's conv3d_same: appends each call's input
    shape, taps, Co, epilogue and dtypes to ``calls``, then launches K1."""
    def conv(x, w, bias=None, *, relu=False, compute_dtype=None, out_dtype=None):
        check(compute_dtype == torch.bfloat16 and (bias is not None or not relu),
              "an s2d route calls K1 outside bf16 compute or with ReLU but no bias")
        calls.append(dict(
            x=tuple(x.shape), co=w.shape[-1], taps=tuple(w.shape[:3]),
            epilogue="bias_relu" if relu else ("none" if bias is None else "bias"),
            in_dtype=str(x.dtype).removeprefix("torch."),
            out_dtype=str(out_dtype or torch.float32).removeprefix("torch.")))
        return conv3d_same(x, w, bias, relu=relu, compute_dtype=compute_dtype, out_dtype=out_dtype)
    return conv


def serve_s2d_phase(cfg, tasks=("dna", "lamin_b1")):
    """The space-to-depth serving routes at full width. (1) One batch of 8
    patches through the native route (K1), the XLA s2d route (K1 at s2d
    shapes) and the K5 route, against each other, with their launch counts.
    (2) run_eval_pass on the K5 route over 2 tasks x 2 synthetic volumes:
    the s2d serving path, whose launch counts are returned. (3) The tiled
    predictor on a 32x256x256 volume: the K5 route fused and two_phase
    (equal), the XLA s2d and native routes, each with its device profile.
    After (1), K1 is held against its plain version at every distinct call
    (input shape, taps, Co, epilogue, dtypes) that each s2d route made."""
    t0 = time.perf_counter()
    bf = torch.bfloat16
    net = seeded_net(cfg, len(tasks), SEED + 2)
    state = net.state_dict()
    levels = reparam.default_s2d_levels(cfg)
    convs = 4 * cfg.depth + 3
    k5_per_batch = 4 * len(levels) - 1  # all chained s2d convs but encoder_block1.conv1
    expected = {"native": {"conv3d_same": convs, "conv3d_dpad": 0},
                # conv_out is the tap-major matmul; each s2d decoder conv1 is two K1 calls
                "xla_s2d": {"conv3d_same": convs - 1 + len(levels), "conv3d_dpad": 0},
                "k5": {"conv3d_same": convs - k5_per_batch, "conv3d_dpad": k5_per_batch}}
    with torch.no_grad():
        plain = reparam.reparameterize(state, cfg, len(tasks), 0)
        plain2 = reparam.to_s2d_plain(plain, cfg, levels)
    x = torch.randn((8, *PATCH, 1), generator=torch.Generator().manual_seed(SEED + 41)).cuda()
    routes = {
        "native": lambda: reparam.plain_forward(plain, x, cfg, compute_dtype=bf),
        "xla_s2d": lambda: reparam.plain_forward_s2d(plain2, x, cfg, levels, compute_dtype=bf),
        "k5": lambda: reparam.plain_forward_s2d_pallas(plain2, x, cfg, levels, compute_dtype=bf),
    }
    outs, counts, fwd_ms, k1_calls = {}, {}, {}, {}
    with torch.no_grad():
        for name, fn in routes.items():
            reset_counts()
            k1_calls[name] = []
            with mock.patch.object(reparam, "conv3d_same", recording_k1(k1_calls[name])):
                outs[name] = fn()
            torch.cuda.synchronize()
            c = kernel_counts()
            counts[name] = {k: c[k] for k in ("conv3d_same", "conv3d_dpad")}
            fwd_ms[name] = cuda_ms(fn, reps=3, warmup=0)
    rel = {"k5_vs_xla_s2d": rel_l2(outs["k5"], outs["xla_s2d"]),
           "xla_s2d_vs_native": rel_l2(outs["xla_s2d"], outs["native"]),
           "k5_vs_native": rel_l2(outs["k5"], outs["native"])}
    emit({"phase": "serve_s2d_batch", "batch": 8, "patch": list(PATCH), "levels": list(levels),
          "forward_ms": fwd_ms, "launches": counts, "expected_launches": expected,
          "rel_l2": rel, "out_std": float(outs["native"].std()),
          "tolerance": "rel L2 at the output: K5 route vs XLA s2d route <= 1e-2, each s2d "
                       "route vs native <= 2e-2 (bf16 compute)"})
    check(all(bool(torch.isfinite(y).all()) for y in outs.values())
          and float(outs["native"].std()) > 0, "serve_s2d: degenerate output")
    check(counts == expected, f"serve_s2d: launches {counts}, expected {expected}")
    check(rel["k5_vs_xla_s2d"] <= 1e-2, "serve_s2d: K5 route vs XLA s2d route")
    check(rel["xla_s2d_vs_native"] <= 2e-2 and rel["k5_vs_native"] <= 2e-2,
          "serve_s2d: an s2d route vs the native route")
    del outs, x
    torch.cuda.empty_cache()
    for route in ("xla_s2d", "k5"):
        names = s2d_k1_names(cfg, levels, route)
        check(len(names) == len(k1_calls[route]), f"serve_s2d: {route} made "
              f"{len(k1_calls[route])} K1 calls, expected {names}")
        kernel_phase([dict(c, name=n) for n, c in zip(names, k1_calls[route])],
                     phase=f"s2d_kernel_k1_{route}")

    # ---- the s2d serving path: run_eval_pass on the K5 route ----
    def k5_cfg(mode="fused"):
        return Config(model=cfg, data=DataConfig(adopted_datasets=tasks),
                      train=TrainConfig(batch_size_eval=8),
                      eval=EvalConfig(s2d=True, pallas_conv=True, predictor=mode))

    ecfg = k5_cfg()
    store = synthetic_store(tasks, volumes_per_task=2, seed=SEED + 42)  # 32x128x128 each
    predictor = TiledPredictor(ecfg)
    reset_counts()
    t1 = time.perf_counter()
    log, _ = run_eval_pass(ecfg, state, store, predictor, "test")
    torch.cuda.synchronize()
    eval_counts = kernel_counts()
    eval_s = time.perf_counter() - t1
    batches = len(store)  # one patch per volume, one batch of 8 per volume
    emit({"phase": "serve_s2d_eval", "seconds": eval_s, "volumes": len(store),
          "test_mse": log["metric_test/MSE"], "test_r2": log["metric_test/R2"],
          "launches": {k: eval_counts[k] for k in ("conv3d_same", "conv3d_dpad")},
          "expected_launches": {k: v * batches for k, v in expected["k5"].items()}})
    check(all(v == v and abs(v) != float("inf") for v in log.values()),
          "serve_s2d: non-finite metric")
    check(eval_counts["conv3d_dpad"] == k5_per_batch * batches,
          f"serve_s2d: run_eval_pass launched K5 {eval_counts['conv3d_dpad']} times")
    check(eval_counts["conv3d_same"] == expected["k5"]["conv3d_same"] * batches,
          f"serve_s2d: run_eval_pass launched K1 {eval_counts['conv3d_same']} times")

    # ---- the tiled predictor on a 32x256x256 volume, four ways ----
    vol = torch.randn((32, 256, 256), generator=torch.Generator().manual_seed(SEED + 3))
    runs = {"k5_fused": (k5_cfg(), plain2), "k5_two_phase": (k5_cfg("two_phase"), plain2),
            "xla_s2d_fused": (ecfg.replace(eval=EvalConfig(s2d=True)), plain2),
            "native_fused": (ecfg.replace(eval=EvalConfig(s2d=False)), plain)}
    preds, results = {}, {}
    for name, (pcfg, params) in runs.items():
        pred = TiledPredictor(pcfg)
        check(pred.num_patches(vol.shape) == 9, "serve_s2d: expected 9 patches")
        pred(params, vol)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            preds[name] = pred(params, vol)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        secs = sorted(times)[1]
        prof = device_breakdown(lambda: pred(params, vol))[0]
        results[name] = {"seconds_median_of_3": secs, "seconds_all": times,
                         "mvox_per_s": vol.numel() / secs / 1e6, **prof}
    same = torch.equal(preds["k5_fused"], preds["k5_two_phase"])
    rel_vol = {k: rel_l2(v, preds["native_fused"]) for k, v in preds.items() if k != "native_fused"}
    emit({"phase": "serve_s2d_predictor", "volume": [32, 256, 256], "patches": 9, "batches": 2,
          "runs": results, "two_phase_equals_fused": same,
          "max_abs_two_phase_vs_fused": float((preds["k5_fused"] - preds["k5_two_phase"]).abs().max()),
          "rel_l2_vs_native": rel_vol, "seconds": time.perf_counter() - t0})
    check(all(bool(torch.isfinite(y).all()) and y.shape == vol.shape for y in preds.values()),
          "serve_s2d: bad prediction")
    check(same, "serve_s2d: two_phase differs from fused")
    check(max(rel_vol.values()) <= 2e-2, f"serve_s2d: a route's volume vs native {rel_vol}")
    return eval_counts


# ------------------------------------------- space-to-depth training (K6)


def s2d_train_convs(cfg, patch, batch):
    """Every per-sample conv of the s2d train step in forward order: name,
    input shape (N,D,H,W,Ci) in its layout (s2d channels at the s2d levels),
    Co, taps, and whether K2 runs it (``k2``; K6 takes the 4-lane s2d entry
    conv). The s2d conv_out runs as tap-major einsums and is not listed."""
    levels = reparam.default_s2d_levels(cfg)
    c = cfg.in_channels * cfg.mult_chan
    chans = [c * 2**i for i in range(cfg.depth + 1)]
    convs = []

    def add(name, level, ci, co, s2d):
        d, h, w = (s >> (level - 1) for s in patch)
        if s2d:
            convs.append(dict(name=name, x=(batch, d, h // 2, w // 2, 4 * ci), co=4 * co,
                              taps=(5, 3, 3), k2=4 * ci != 4))
        else:
            convs.append(dict(name=name, x=(batch, d, h, w, ci), co=co))

    in_ch = cfg.in_channels
    for i in range(1, cfg.depth + 1):
        add(f"encoder_block{i}.conv1", i, in_ch, chans[i - 1], i in levels)
        add(f"encoder_block{i}.conv2", i, chans[i - 1], chans[i - 1], i in levels)
        in_ch = chans[i - 1]
    add("bottle_block.conv1", cfg.depth + 1, chans[-2], chans[-1], False)
    add("bottle_block.conv2", cfg.depth + 1, chans[-1], chans[-1], False)
    for i in range(cfg.depth, 0, -1):
        add(f"decoder_block{i}.conv1", i, 2 * chans[i - 1], chans[i - 1], i in levels)
        add(f"decoder_block{i}.conv2", i, chans[i - 1], chans[i - 1], i in levels)
    if 1 not in levels:
        add("conv_out", 1, c, cfg.out_channels, False)
    return convs


def s2d_step_launches(convs):
    """K6, K2, K3 and K4 launches of one s2d train step, from its conv list."""
    k6 = sum(not cv.get("k2", True) for cv in convs)
    return {"conv3d_tapconcat_persample": k6,
            "conv3d_same_persample": len(convs) - k6,
            "conv3d_same_persample_transpose": sum(cv["name"] != "encoder_block1.conv1"
                                                   for cv in convs),
            "conv3d_dw_persample": len(convs)}


def tapconcat_kernel_phase(cfg, batch=8):
    """K6 at the s2d entry conv of training (batch 8 of 32x128x128 patches:
    x (8,32,64,64,4), Co = 4*mult_chan): against its plain version in fp64 on
    samples 0 and 7, then timed beside its plain version (fp32 sums, TF32
    off), a cuDNN grouped conv (a yardstick the port does not call), K2 on
    the same conv and its mma.sync instance forced at this shape (both
    checked too), a plain write of its output (y.zero_(): the card's write
    floor, a yardstick) and its bound; with its plan, the device kernels
    wrapper calls launch (K6 alone, at most once a call) and the bytes a call
    allocates besides y (none: w is read in place). Returns K6's totals."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    bf = torch.bfloat16
    n, (d, h, w) = batch, (PATCH[0], PATCH[1] // 2, PATCH[2] // 2)
    co = 4 * cfg.in_channels * cfg.mult_chan
    x = torch.randn((n, d, h, w, 4), generator=gen, device=dev).to(bf)
    w6 = (torch.randn((n, 5, 3, 3, 4, co), generator=gen, device=dev) / 180 ** 0.5).to(bf)
    wn = w6.reshape(n, 180, co)

    def kernel():
        return conv3d_tapconcat_persample(x, wn)

    def plain():
        return conv3d_tapconcat_persample_plain(x, wn, compute_dtype=bf)

    def k2_same_conv():
        return conv3d_same_persample(x, w6, compute_dtype=bf)

    xl = x.permute(0, 4, 1, 2, 3).reshape(1, n * 4, d, h, w).contiguous(
        memory_format=torch.channels_last_3d)
    wl = w6.permute(0, 5, 4, 1, 2, 3).reshape(n * co, 4, 5, 3, 3).contiguous(
        memory_format=torch.channels_last_3d)

    def library():
        return F.conv3d(xl, wl, padding=(2, 1, 1), groups=n)

    plan = conv3d_tapconcat_persample_plan(x.shape, co, device=dev)
    check(plan["instance"] == "wgmma" and plan["local_bytes"] == 0,
          f"conv3d_tapconcat_persample: the training shape plans {plan}")

    def mma_sync():
        return conv3d_mod._k6_launch(x, wn, co, dict(plan, instance="mma_sync"))

    y_floor = torch.empty((n, d, h, w, co), dtype=bf, device=dev)
    ref = conv3d_tapconcat_persample_plain(x[CHECKED_SAMPLES].double(), wn[CHECKED_SAMPLES].double())
    y = kernel()
    ok, max_abs, top = check_samples("conv3d_tapconcat_persample", y, ref, fp32_out=False)
    ok_k2, max_abs_k2, _ = check_samples("conv3d_same_persample (K6's conv)", k2_same_conv(), ref,
                                         fp32_out=False)
    ok_mma, max_abs_mma, _ = check_samples("conv3d_tapconcat_persample (mma.sync)", mma_sync(),
                                           ref, fp32_out=False)
    deterministic = bool(torch.equal(y, kernel()))
    torch.cuda.synchronize()
    del ref, y
    calls = 30
    launched = launched_kernels(kernel, calls)
    # no tensor but y is allocated in a call (a copy of w would be)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = kernel()
    torch.cuda.synchronize()
    extra_bytes = torch.cuda.max_memory_allocated() - before - y.numel() * y.element_size()
    del y
    kernel_ms = cuda_ms(kernel, reps=20, warmup=3)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    library_ms = cuda_ms(library, reps=10, warmup=2)
    k2_ms = cuda_ms(k2_same_conv, reps=10, warmup=2)
    mma_sync_ms = cuda_ms(mma_sync, reps=20, warmup=3)
    write_floor_ms = cuda_ms(y_floor.zero_, reps=20, warmup=3)
    flops = 2.0 * n * d * h * w * 180 * co
    nbytes = x.numel() * 2 + wn.numel() * 2 + n * d * h * w * co * 2
    bound_ms, bound_by = bound(flops, nbytes)
    out = {"phase": "train_s2d_kernel", "kernel": "conv3d_tapconcat_persample",
           "convs": ["encoder_block1.conv1 (s2d)"], "launches_per_step": 1,
           "x": [n, d, h, w, 4], "taps": [5, 3, 3], "co": co, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "F.conv3d grouped (groups=N), bf16, channels_last_3d, padding (2,1,1)",
           "k2_same_conv_ms": k2_ms, "mma_sync_ms": mma_sync_ms,
           "write_floor_ms": write_floor_ms, "write_floor_call": "y.zero_() (bf16, y's shape)",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gflop": flops / 1e9, "gbytes": nbytes / 1e9, "tflops": flops / kernel_ms / 1e9,
           "tb_per_s": nbytes / kernel_ms / 1e9, "plan": plan,
           "wrapper_calls_profiled": calls,
           "wrapper_launches": launched or "not shown: the profiler recorded no device event",
           "wrapper_extra_bytes": extra_bytes,
           "max_abs_err": max_abs, "max_abs_ref": top, "k2_max_abs_err": max_abs_k2,
           "mma_sync_max_abs_err": max_abs_mma, "deterministic": deterministic,
           "tolerance": BF16_TOL, "ok": ok and ok_k2 and ok_mma and deterministic}
    emit(out)
    check(ok, f"conv3d_tapconcat_persample: kernel disagrees with the plain version ({max_abs})")
    check(ok_k2, f"conv3d_same_persample at K6's conv disagrees ({max_abs_k2})")
    check(ok_mma, f"conv3d_tapconcat_persample's mma.sync instance disagrees ({max_abs_mma})")
    check(deterministic, "conv3d_tapconcat_persample: two calls differ")
    check(extra_bytes == 0, f"conv3d_tapconcat_persample: a call allocates {extra_bytes} bytes "
                            "besides y")
    # K6 alone, at most once a call: the profiler may still drop an event,
    # never add one (the wrapper's count, once a launch, is the main path's)
    check(all("conv3d_tapconcat_kernel_wgmma" in k for k in launched)
          and sum(launched.values()) <= calls,
          f"conv3d_tapconcat_persample: {calls} calls launch {launched}")
    del x, w6, wn, xl, wl, y_floor
    torch.cuda.empty_cache()
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "ops_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "bytes_ms": nbytes / PEAK_BYTES * 1e3, "max_abs_err": max_abs, "k2_same_conv_ms": k2_ms}


def train_s2d_kernel_phase(cfg):
    """K6 at its shape, then K2, K3 and K4 at every per-sample conv shape of
    the s2d levels of the train step (taps (5,3,3); the native levels' shapes
    are train_kernel's). Returns (K6 totals, K2-K4 totals over the s2d levels
    of one step)."""
    k6 = tapconcat_kernel_phase(cfg)
    convs = [cv for cv in s2d_train_convs(cfg, PATCH, batch=8) if "taps" in cv]
    return k6, train_kernel_phase(convs, phase="train_s2d_kernel")


def s2d_config(num_tasks, **model):
    return Config(model=ModelConfig(**model),
                  data=DataConfig(adopted_datasets=DEFAULT_DATASETS[:num_tasks]))


def train_s2d_phase(cfg_model, tasks=DEFAULT_DATASETS[:4], epochs=3):
    """run_experiment with the default Config (s2d training, and the JAX
    package's default serving route for val and test) at full width on
    synthetic data: 4 tasks x 2 volumes = one mixed batch of 8 per epoch, val
    after the last epoch, the best checkpoint, its reload and the test pass.
    Returns the launch counts of the run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_s2d_")
    try:
        cfg = Config(data=DataConfig(adopted_datasets=tasks),
                     train=TrainConfig(num_epochs=epochs, interval_val=epochs),
                     path_exp_dir=os.path.join(tmp, "train_s2d"), exp_name="train_s2d")
        check(cfg.model == cfg_model and cfg.model.train_s2d, "train_s2d: not the default config")
        stores = train_cli.build_stores(cfg, logging.getLogger("chip_smoke"), synthetic=True)
        reset_counts()
        t0 = time.perf_counter()
        res = run_experiment(cfg, stores, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernel_counts()
        net, steps = res["state"].net, res["state"].step
        check(net.s2d_levels == reparam.default_s2d_levels(cfg.model), "train_s2d: s2d levels")
        init = create_train_state(cfg, torch.Generator().manual_seed(cfg.train.seed), "cuda").net
        report = param_report(net, init)
        per_step = s2d_step_launches(s2d_train_convs(cfg.model, PATCH, cfg.train.batch_size))
        # val and test: 2 volumes per task each, one batch per volume, on the
        # XLA s2d serving route (K1 at every conv but conv_out, two K1 calls
        # per s2d decoder conv1)
        levels = reparam.default_s2d_levels(cfg.model)
        k1_expected = 2 * (2 * len(tasks)) * (4 * cfg.model.depth + 2 + len(levels))
        out = {"phase": "train_s2d", "seconds": secs, "tasks": list(tasks), "epochs": epochs,
               "steps": steps, "s2d_levels": list(net.s2d_levels), "launches": counts,
               "launches_per_step": {k: counts[k] / steps for k in per_step},
               "expected_launches_per_step": per_step,
               "k1_launches_val_test": counts["conv3d_same"], "k1_expected": k1_expected,
               "train_loss": res["train_log"]["loss/epoch"],
               "test_mse": res["test_log"]["metric_test/MSE"], **report}
        emit(out)
        check(steps == epochs, f"train_s2d: {steps} steps, expected {epochs}")
        check(tuple(per_step.values()) == (1, 17, 17, 18),
              f"train_s2d: the conv list gives {per_step} launches per step")
        for k, v in per_step.items():
            check(counts[k] == v * steps, f"train_s2d: {k} launched {counts[k]} times in {steps} "
                                          f"steps, expected {v} per step")
        check(counts["conv3d_same"] == k1_expected, "train_s2d: K1 launches in val/test")
        check(counts["conv3d_dpad"] == 0, "train_s2d: K5 launched")
        check(out["train_loss"] == out["train_loss"] and abs(out["train_loss"]) < float("inf"),
              "train_s2d: non-finite loss")
        check_params("train_s2d", report)
        check(res["best_path"] is not None, "train_s2d: no best checkpoint")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def train_s2d_step_phase(num_tasks, steps=6):
    """The full-width train step (batch 8, mixed tasks, bf16) in the s2d
    layout beside the native one, from the same weights on the same batch:
    warm-up, then native, s2d, s2d, native in rounds of steps/2, so that each
    median over `steps` steps sits beside the other's on the same card. Then
    the s2d step's device profile and peak memory."""
    states = {name: create_train_state(s2d_config(num_tasks, train_s2d=name == "s2d"),
                                       torch.Generator().manual_seed(SEED + 21), "cuda")
              for name in ("native", "s2d")}
    fns = {name: make_train_step(s2d_config(num_tasks), st) for name, st in states.items()}
    batch = full_width_batch(num_tasks)
    times, peaks = {"native": [], "s2d": []}, {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(batch)  # warm-up
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
    for name in ("native", "s2d", "s2d", "native"):
        for _ in range(steps // 2):
            t0 = time.perf_counter()
            fns[name](batch)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    prof, kernels = device_breakdown(lambda: fns["s2d"](batch), top=10)
    del prof["conv3d_same_ms"], prof["conv3d_dpad_ms"]
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    out = {"phase": "train_s2d_step", "batch": 8, "patch": list(PATCH), "tasks": num_tasks,
           "step_ms_median": med, "step_ms_all": times, "s2d_over_native": med["s2d"] / med["native"],
           "peak_memory_gb": peaks, "s2d_profile": {**prof, **per_sample_kernel_ms(kernels)}}
    emit(out)
    check(all(out["s2d_profile"][k] > 0 for k in ("k2_ms", "k3_ms", "k4_ms", "k6_ms")),
          "train_s2d_step: a per-sample kernel is missing from the s2d profile")
    del states, fns
    torch.cuda.empty_cache()


def train_s2d_check_phase(num_tasks):
    """One full-width forward+backward, batch 8, from the same weights on the
    same batch, three ways: the s2d merged route in bf16 (K6, K2-K4), the
    native merged route in bf16 (K2-K4) and the native expert-sum route in
    fp32 (conv3d_same_autograd). The s2d route is held to the
    native one by ``hold_gradients``, train_check's rule."""
    batch = full_width_batch(num_tasks, seed=SEED + 60)
    state = create_train_state(s2d_config(num_tasks, train_s2d=False),
                               torch.Generator().manual_seed(SEED + 61), "cuda").net.state_dict()
    state = {k: v.clone() for k, v in state.items()}
    grads, losses = {}, {}
    for run, s2d_on, impl, cdt in (("s2d", True, "auto", "bfloat16"),
                                   ("native", False, "auto", "bfloat16"),
                                   ("native_fp32", False, "expert_sum", "float32")):
        net = RepModeNet(s2d_config(num_tasks, train_s2d=s2d_on, train_impl=impl).model,
                         num_tasks, compute_dtype=cdt, device="cuda")
        net.load_state_dict(state, strict=True)
        net.train()
        loss = ((net(batch["signal"], batch["task"]) - batch["target"]) ** 2).mean()
        loss.backward()
        losses[run] = float(loss.detach())
        grads[run] = {k: v.grad.detach().double() for k, v in net.named_parameters()}
        del net, loss
        torch.cuda.empty_cache()

    hold_gradients("train_s2d_check", losses, grads, "s2d", "native", "native_fp32")
    del grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- ingest

INGEST_TASKS = ("dna", "lamin_b1")
INGEST_RAW = (32, 344, 344)  # 32x128x128 after the 0.37241 XY resize: one patch
INGEST_LZW_IMAGE = 2  # the LZW-compressed CZI
# split -> task -> [(image, channel_target or None)]: 8 train rows (one batch
# of 8), 2 val, 3 test of which one unlabeled; the images are shared between
# the tasks as the reference's dna task shares the other tasks' images
INGEST_LAYOUT = {
    "train": {"dna": [(0, 1), (1, 1), (2, 1), (3, 1)], "lamin_b1": [(2, 1), (3, 1), (4, 1), (5, 1)]},
    "val": {"dna": [(4, 1)], "lamin_b1": [(0, 1)]},
    "test": {"dna": [(5, 1), (1, None)], "lamin_b1": [(1, 1)]},
}
INGEST_CSV_COLUMNS = ("path_czi", "channel_signal", "channel_target", "structureProteinName",
                      "colony_position")


def lzw_encode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, 9->12 bits, early change, a clear
    before the table fills): the stream tests/lzw_ref.py:tiff_lzw_encode
    writes, byte for byte, with codes packed into an integer instead of a
    list of bits, which is too slow for a 32x344x344 channel."""
    table = {}
    next_code, bits = 258, 9
    out = bytearray()
    acc, nacc = 256, 9  # the leading clear code
    w = -1
    for ch in data:
        if w < 0:
            w = ch
            continue
        c = table.get((w << 8) | ch)
        if c is not None:
            w = c
            continue
        acc, nacc = (acc << bits) | w, nacc + bits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
        table[(w << 8) | ch] = next_code
        next_code += 1
        if next_code == (1 << bits) and bits < 12:
            bits += 1
        if next_code >= 4094:
            acc, nacc = (acc << bits) | 256, nacc + bits
            table.clear()
            next_code, bits = 258, 9
        w = ch
    for code in ([w] if w >= 0 else []) + [257]:
        acc, nacc = (acc << bits) | code, nacc + bits
    while nacc >= 8:
        nacc -= 8
        out.append((acc >> nacc) & 0xFF)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _czi_segment(sid: bytes, payload: bytes) -> bytes:
    alloc = (len(payload) + 31) // 32 * 32
    return struct.pack("<16sqq", sid, alloc, len(payload)) + payload + b"\0" * (alloc - len(payload))


def write_czi(path, data, compression=0):
    """A ZISRAW file of (C, Z, Y, X) uint16 data, one subblock a channel, in
    the layout of tests/test_czi.py:write_czi (header, metadata, subblocks,
    directory; dimension entries X first); compression 2 stores each
    subblock TIFF-LZW-compressed."""
    c, z, y, x = data.shape
    xml = (b'<ImageDocument><Metadata><Scaling><Items><Distance Id="X"><Value>1.08e-07'
           b"</Value></Distance></Items></Scaling></Metadata></ImageDocument>")
    meta = _czi_segment(b"ZISRAWMETADATA", struct.pack("<ii", len(xml), 0) + b"\0" * 248 + xml)
    pos = 32 + 512 + len(meta)
    entries, subblocks = [], []
    for ci in range(c):
        dims = [(b"X", 0, x), (b"Y", 0, y), (b"Z", 0, z), (b"C", ci, 1)]
        entry = (b"DV" + struct.pack("<iqii", 1, pos, 0, compression) + b"\0" * 6
                 + struct.pack("<i", len(dims))
                 + b"".join(struct.pack("<4siifi", n, s, k, 0.0, k) for n, s, k in dims))
        raw = np.ascontiguousarray(data[ci], "<u2").tobytes()
        if compression == 2:
            raw = lzw_encode(raw)
        inline = struct.pack("<iiq", 0, 0, len(raw)) + entry
        inline += b"\0" * (max(256, len(entry) + 16) - len(inline))
        subblocks.append(_czi_segment(b"ZISRAWSUBBLOCK", inline + raw))
        entries.append(entry)
        pos += len(subblocks[-1])
    directory = _czi_segment(b"ZISRAWDIRECTORY",
                             struct.pack("<i", c) + b"\0" * 124 + b"".join(entries))
    hdr = (struct.pack("<iiii", 1, 0, 0, 0) + b"\0" * 32
           + struct.pack("<iqqiq", 0, pos, 32 + 512, 0, 0))
    with open(path, "wb") as f:
        f.write(struct.pack("<16sqq", b"ZISRAWFILE", 512, 512) + hdr + b"\0" * (512 - len(hdr)))
        f.write(meta)
        for seg in subblocks:
            f.write(seg)
        f.write(directory)


def write_ingest_dataset(root):
    """The reference's layout under root: csvs/<task>/<split>.csv (its schema;
    an empty channel_target for the unlabeled row) and czi/<image>.czi, the
    CSVs' paths 'data'-prefixed (the reference strips the prefix). Returns
    {image: raw (C, Z, Y, X) uint16}."""
    rng = np.random.default_rng(SEED + 40)
    zz, yy, xx = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in INGEST_RAW), indexing="ij")
    os.makedirs(os.path.join(root, "czi"))
    images = sorted({k for tasks in INGEST_LAYOUT.values() for rows in tasks.values()
                     for k, _ in rows})
    raws = {}
    for k in images:
        # cell-like blobs and a depth ramp under shot noise: brightfield-ish
        # signal, a fluorescence-ish target that depends on it
        blob = np.sin(xx / (9.0 + k)) * np.cos(yy / (7.0 + k)) + zz / INGEST_RAW[0]
        sig = 1000 + 300 * blob + rng.normal(0, 30, blob.shape)
        tgt = 400 + 250 * np.maximum(blob, 0) ** 2 + rng.normal(0, 20, blob.shape)
        raws[k] = np.stack([sig, tgt]).clip(0, 65535).astype(np.uint16)
        write_czi(os.path.join(root, "czi", f"cell_{k}.czi"), raws[k],
                  compression=2 if k == INGEST_LZW_IMAGE else 0)
    for split, tasks in INGEST_LAYOUT.items():
        for ds, rows in tasks.items():
            os.makedirs(os.path.join(root, "csvs", ds), exist_ok=True)
            with open(os.path.join(root, "csvs", ds, f"{split}.csv"), "w", newline="") as f:
                w = csv.writer(f, lineterminator="\n")
                w.writerow(INGEST_CSV_COLUMNS)
                for k, t in rows:
                    w.writerow([f"data/cell_{k}.czi", 0, "" if t is None else t, ds, ""])
    return raws


class PhaseClock:
    """Seconds spent inside wrapped functions, summed over calls and threads."""

    def __init__(self):
        self.seconds, self.calls = {}, {}
        self._lock = threading.Lock()

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                    self.calls[name] = self.calls.get(name, 0) + 1
        return timed


def sampler_share(cfg, train_store, epochs=2, repeat=4, bank=None):
    """A cli.train step with the host sampler in it (run_train_epoch: the
    sampler's prefetch thread, the host-to-device copy, the step) against
    the step on a batch already on the card, with the native batcher and
    with use_native=False; in turns fixed, native, numpy, numpy, native,
    fixed after one warm-up epoch. The train store's volumes ``repeat``
    times over make an epoch (the ingest phase's 8 volumes four times over:
    4 batches of 8). With ``bank``, a device bank of the store, the device
    sampler (run_train_epoch_device) takes numpy's turns. Also the host-only
    assembly time of one batch and its host-to-device copy."""
    store = VolumeStore(train_store.records * repeat, train_store.adopted_datasets)
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED + 41), "cuda")
    step = make_train_step(cfg, state)
    names = ("native", "numpy") if bank is None else ("native",)
    samplers = {name: PatchSampler(store, cfg.train.batch_size, cfg.train.patch_size,
                                   seed=SEED + 42, use_native=name == "native")
                for name in names}
    steps = samplers["native"].batches_per_epoch()
    host = next(samplers[names[-1]].epoch())
    fixed = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    other = "numpy"
    if bank is not None:
        other = "bank"
        sample, bank_steps = make_device_sampler(bank, cfg.train.batch_size,
                                                 cfg.train.patch_size, seed=SEED + 43)
        check(bank_steps == steps, "sampler_share: the bank's steps differ from the host's")
    run_train_epoch(cfg, state, step, samplers["native"], 0)  # warm-up
    ms = {"fixed": [], "native": [], other: []}
    for name in ("fixed", "native", other, other, "native", "fixed"):
        for _ in range(epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "fixed":
                pending = [step(fixed) for _ in range(steps)]
                float(pending[-1]["loss"])
                torch.cuda.synchronize()
            elif name == "bank":
                run_train_epoch_device(cfg, state, step, sample, steps, 0)
            else:
                run_train_epoch(cfg, state, step, samplers[name], 0)
            ms[name].append((time.perf_counter() - t0) * 1e3 / steps)
    assembly = {}
    for name, s in samplers.items():
        idx = np.arange(cfg.train.batch_size)
        s._make_batch(idx)
        t0 = time.perf_counter()
        for _ in range(5):
            s._make_batch(idx)
        assembly[name] = (time.perf_counter() - t0) * 1e3 / 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3 / 5
    med = {k: float(np.median(v)) for k, v in ms.items()}
    del state, step
    torch.cuda.empty_cache()
    return {"steps_per_epoch": steps, "batch": cfg.train.batch_size,
            "step_ms_median": med, "step_ms_all": ms,
            **{f"sampler_share_{k}": (med[k] - med["fixed"]) / med[k] for k in ("native", other)},
            "batch_assembly_ms": assembly, "host_to_device_copy_ms": copy_ms}


def ingest_phase(num_convs, card):
    """The real data path on the card: CSVs and CZI files (one LZW) ->
    cli.train at full width (ingest, --path_save_dataset, one epoch, val,
    the best checkpoint, the test pass with --save_test_preds and
    --save_test_signals_and_targets) -> cli.evaluate on the saved dataset
    and the best checkpoint. Returns the launch counts of the cli.train
    run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        raws = write_ingest_dataset(tmp)
        write_s = time.perf_counter() - t0
        with CziFile(os.path.join(tmp, "czi", f"cell_{INGEST_LZW_IMAGE}.czi")) as czi:
            check([e.compression for e in czi.entries] == [2, 2], "ingest: no LZW subblocks")
            check(np.array_equal(czi.asarray()[..., 0], raws[INGEST_LZW_IMAGE]),
                  "ingest: the LZW CZI does not read back as written")

        saved, exp_dir = os.path.join(tmp, "saved"), os.path.join(tmp, "train")
        argv = ["--adopted_datasets", *INGEST_TASKS, "--path_dataset_csv", os.path.join(tmp, "csvs"),
                "--path_dataset_czi", os.path.join(tmp, "czi"), "--path_save_dataset", saved,
                "--num_epochs", "1", "--interval_val", "1", "--save_test_preds",
                "--save_test_signals_and_targets", "--debugging", "--on_device_pipeline", "off",
                "--path_exp_dir", exp_dir]
        clock = PhaseClock()
        with mock.patch.object(ingest_mod, "CziVolumeReader",
                               clock.wrap("decode", ingest_mod.CziVolumeReader)), \
                mock.patch.object(native, "lzw_decode", clock.wrap("lzw", native.lzw_decode)), \
                mock.patch.object(ingest_mod, "normalize",
                                  clock.wrap("normalize", ingest_mod.normalize)), \
                mock.patch.object(ingest_mod, "resize", clock.wrap("resize", ingest_mod.resize)), \
                mock.patch.object(train_cli, "ingest_split",
                                  clock.wrap("ingest_wall", train_cli.ingest_split)), \
                mock.patch.object(VolumeStore, "save", clock.wrap("save", VolumeStore.save)):
            reset_counts()
            t0 = time.perf_counter()
            res = train_cli.main(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = kernel_counts()
        rows = sum(len(r) for tasks in INGEST_LAYOUT.values() for r in tasks.values())
        emit({"phase": "ingest_time", "card": card, "rows": rows,
              "images": len(raws), "raw_shape": list(INGEST_RAW), "lzw_images": 1,
              "workers": train_cli.build_parser().get_default("num_workers"),
              "ingest_wall_s": clock.seconds["ingest_wall"],
              "thread_s": {k: clock.seconds[k] for k in ("decode", "lzw", "normalize", "resize")},
              "calls": clock.calls, "save_s": clock.seconds["save"],
              "write_dataset_s": write_s, "cli_train_s": train_s,
              "note": "thread_s sums the worker threads' time inside each function (decode "
                      "includes lzw); ingest_wall_s is the three splits' ingest_split calls"})
        check(clock.calls["lzw"] == 2 * sum(k == INGEST_LZW_IMAGE for tasks in
                                            INGEST_LAYOUT.values() for r in tasks.values()
                                            for k, _ in r), "ingest: LZW decode calls")

        # ---- the main path's launches: one step (8 train rows, batch 8),
        # K1 in val and test (one batch of 8 patches a volume)
        steps = res["state"].step
        k1_expected = (2 + 3) * num_convs
        out = {"phase": "ingest_train", "card": card, "seconds": train_s, "steps": steps,
               "launches": counts,
               "launches_per_step": {k: counts[k] / max(steps, 1) for k in
                                     ("conv3d_same_persample", "conv3d_same_persample_transpose",
                                      "conv3d_dw_persample")},
               "k1_launches_val_test": counts["conv3d_same"], "k1_expected": k1_expected,
               "train_loss": res["train_log"]["loss/epoch"],
               "test_mse": res["test_log"]["metric_test/MSE"],
               "best_path": os.path.basename(res["best_path"] or "")}
        emit(out)
        check(steps == 1, f"ingest: {steps} steps, expected 1")
        for k, v in zip(out["launches_per_step"], (num_convs, num_convs - 1, num_convs)):
            check(counts[k] == v * steps, f"ingest: {k} launched {counts[k]} times, expected {v}")
        check(counts["conv3d_same"] == k1_expected, "ingest: K1 launches outside val/test")
        check(np.isfinite(out["train_loss"]) and np.isfinite(out["test_mse"]),
              "ingest: non-finite loss or test MSE")
        check(res["best_path"] is not None, "ingest: no best checkpoint")

        # ---- the manifests reload
        stores = {s: VolumeStore.load(saved, s) for s in INGEST_LAYOUT}
        for split, tasks in INGEST_LAYOUT.items():
            want = [(ds, f"data/cell_{k}.czi") for ds in sorted(tasks) for k, _ in tasks[ds]]
            got = [(r.dataset, r.info["path_czi"]) for r in stores[split].records]
            check(got == want, f"ingest: {split} manifest holds {got}")
            for r in stores[split].records:
                check(r.signal.shape == PATCH and np.isfinite(r.signal).all(),
                      f"ingest: {split} signal {r.signal.shape}")
        unlabeled = stores["test"].records[1]
        check(unlabeled.target is None and math.isnan(unlabeled.info["channel_target"]),
              "ingest: the unlabeled row has a target")

        # ---- the TIFFs: JAX's names; the predictions equal a fresh predictor
        # call (K1 is bit-identical across calls); signal and target as stored
        cfg = train_cli.to_config(train_cli.build_parser().parse_args(argv))
        loaded = load_reference_checkpoint(res["best_path"])
        net = RepModeNet(cfg.model, cfg.num_tasks, compute_dtype=cfg.train.compute_dtype,
                         device="cuda")
        net.load_state_dict(loaded["state_dict"], strict=True)
        prepare, _ = reparam.make_inference(cfg)
        predictor = TiledPredictor(cfg)
        preds_dir = os.path.join(exp_dir, "preds")
        names, max_diff = [], 0.0
        with torch.no_grad():
            for i, rec in enumerate(stores["test"].records):
                img_id = os.path.basename(rec.info["path_czi"]).rstrip(".czi")
                base = os.path.join(preds_dir, f"{i:0>3d}_{{}}_{rec.dataset}_{img_id}.tiff")
                fresh = predictor(prepare(net.state_dict(), rec.task), rec.signal).cpu().numpy()
                saved_pred = tiff.imread(base.format("pred"))
                max_diff = max(max_diff, float(np.abs(saved_pred - fresh).max()))
                check(np.array_equal(saved_pred, fresh), f"ingest: {base.format('pred')} differs "
                                                         "from a fresh predictor call")
                check(np.array_equal(tiff.imread(base.format("signal")), rec.signal),
                      "ingest: signal TIFF")
                if rec.target is not None:
                    check(np.array_equal(tiff.imread(base.format("target")), rec.target),
                          "ingest: target TIFF")
                names += [os.path.basename(base.format(k)) for k in ("pred", "signal", "target")
                          if k != "target" or rec.target is not None]
        check(sorted(os.listdir(preds_dir)) == sorted(names), "ingest: unexpected TIFFs")

        # ---- the run record
        with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        check(len(lines) == 2 and "loss/epoch" in lines[0] and "metric_val/MSE" in lines[1],
              "ingest: metrics.jsonl lacks the epoch and val lines")

        # ---- cli.evaluate on the saved dataset and the best checkpoint
        t0 = time.perf_counter()
        log = evaluate.main(["--torch_checkpoint", res["best_path"], "--path_load_dataset", saved,
                             "--debugging", "--path_exp_dir", os.path.join(tmp, "eval")])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        emit({"phase": "ingest_outputs", "card": card, "tiffs": sorted(names),
              "pred_max_abs_diff_vs_fresh_call": max_diff,
              "metrics_jsonl_lines": [sorted(x)[:4] for x in lines],
              "evaluate_seconds": eval_s, "evaluate_test_mse": log["metric_test/MSE"],
              "train_test_mse": out["test_mse"],
              "equal": log["metric_test/MSE"] == out["test_mse"]})
        check(log["metric_test/MSE"] == out["test_mse"],
              "ingest: cli.evaluate's test MSE differs from the train run's test pass")
        del net, predictor
        torch.cuda.empty_cache()

        # ---- the host sampler's share of a cli.train step (ROADMAP A8b)
        share = sampler_share(cfg, stores["train"])
        emit({"phase": "ingest_sampler", "card": card, **share,
              "phase_seconds": time.perf_counter() - t_phase})
        check(all(np.isfinite(v) for v in share["step_ms_median"].values()),
              "ingest: sampler timing")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


# --------------------------------------------------- the UNet baseline (A9)

UNET_TASKS = DEFAULT_DATASETS[:4]


def seeded_unet(cfg, seed):
    """A full-width UNet from a seeded generator, in eval mode, with BN
    running statistics drawn as seeded_net draws them (activations stay
    alive through its 19 convs)."""
    gen = torch.Generator().manual_seed(seed)
    net = build_model(cfg, gen, "cuda")
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_((torch.rand(buf.shape, generator=gen) - 0.5) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.3 + 0.3)
    return net.eval()


def unet_phase(num_convs, card):
    """The UNet baseline at full width (mult_chan 32, depth 4, 5^3 kernels,
    bf16 compute, batch 8 of 32x128x128): its train step (no port kernel
    launches; cuDNN convs), cli.train --nn_module UNet then cli.evaluate on
    its .p (the same test MSE), and the tiled predictor on a 32x256x256
    volume (K1 at all 19 'same' convs of a batch, held against the same
    net's conv3d_same_autograd forward)."""
    t_phase = time.perf_counter()
    cfg = Config(model=ModelConfig(name="UNet"), data=DataConfig(adopted_datasets=UNET_TASKS))

    # ---- the train step
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED + 80), "cuda")
    init = {k: v.detach().clone() for k, v in state.net.named_parameters()}
    step = make_train_step(cfg, state)
    batch = full_width_batch(len(UNET_TASKS), seed=SEED + 81)
    torch.cuda.reset_peak_memory_stats()
    step(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()

    def step_ms():
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    times = sorted(step_ms() for _ in range(6))
    counts = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof, _ = device_breakdown(lambda: step(batch), top=8)
    # the same step with cuDNN's autotuner on (not the port's setting; the
    # first step under it tunes every conv and is dropped)
    torch.backends.cudnn.benchmark = True
    try:
        step_ms()
        bench = sorted(step_ms() for _ in range(6))
    finally:
        torch.backends.cudnn.benchmark = False
    params = dict(state.net.named_parameters())
    report = {"params_without_grad": [k for k, v in params.items() if v.grad is None],
              "params_nonfinite_grad": [k for k, v in params.items() if v.grad is not None
                                        and not bool(torch.isfinite(v.grad).all())],
              "params_unchanged": [k for k, v in params.items() if torch.equal(v, init[k])]}
    emit({"phase": "unet_step", "card": card, "batch": 8, "patch": list(PATCH),
          "params": sum(v.numel() for v in params.values()),
          "step_ms_median": times[len(times) // 2], "step_ms_all": times,
          "step_ms_median_cudnn_benchmark": bench[len(bench) // 2],
          "step_ms_all_cudnn_benchmark": bench,
          "peak_memory_gb": peak_gb, "launches_in_6_steps": counts, **prof, **report})
    check(all(v == 0 for v in counts.values()), "unet: a port kernel launched in a train step")
    check_params("unet", report)
    del state, step, init, params, batch
    torch.cuda.empty_cache()

    # ---- cli.train --nn_module UNet, then cli.evaluate on its .p
    tmp = tempfile.mkdtemp(prefix="chip_smoke_unet_")
    try:
        exp_dir = os.path.join(tmp, "train")
        common = ["--synthetic", "--debugging", "--nn_module", "UNet",
                  "--adopted_datasets", *UNET_TASKS]
        reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main([*common, "--num_epochs", "2", "--interval_val", "2",
                              "--path_exp_dir", exp_dir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = kernel_counts()
        reset_counts()
        t0 = time.perf_counter()
        log = evaluate.main([*common, "--torch_checkpoint", res["best_path"],
                             "--path_exp_dir", os.path.join(tmp, "eval")])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = kernel_counts()
        # 2 synthetic volumes a task in val and in test, one batch of 8 each
        k1_train = 2 * (2 * len(UNET_TASKS)) * num_convs
        out = {"phase": "unet_cli", "card": card, "train_seconds": train_s,
               "steps": res["state"].step, "train_launches": train_counts,
               "k1_expected_val_test": k1_train, "evaluate_seconds": eval_s,
               "evaluate_launches": eval_counts, "train_loss": res["train_log"]["loss/epoch"],
               "train_test_mse": res["test_log"]["metric_test/MSE"],
               "evaluate_test_mse": log["metric_test/MSE"],
               "equal": log["metric_test/MSE"] == res["test_log"]["metric_test/MSE"]}
        emit(out)
        check(res["state"].step == 2, "unet: cli.train steps")
        check(train_counts["conv3d_same"] == k1_train and sum(train_counts.values()) == k1_train,
              "unet: cli.train launched a kernel other than K1, or K1 outside val/test")
        check(eval_counts["conv3d_same"] == k1_train // 2, "unet: cli.evaluate K1 launches")
        check(np.isfinite(out["train_loss"]) and out["equal"],
              "unet: cli.evaluate's test MSE differs from the train run's test pass")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- the predictor: K1 against the conv3d_same_autograd route
    net = seeded_unet(cfg, SEED + 82)
    prepare, _ = reparam.make_inference(cfg)
    with torch.no_grad():
        served = prepare(net.state_dict(), 0)
    vol = torch.randn((32, 256, 256), generator=torch.Generator().manual_seed(SEED + 83))
    pred = TiledPredictor(cfg)
    pred(served, vol)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    y = pred(served, vol)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = conv3d_same.launches
    serve_prof, _ = device_breakdown(lambda: pred(served, vol), top=8)

    def autograd_conv(x, w, compute_dtype=None):
        return conv3d_mod.conv3d_same_autograd(x, w, compute_dtype=compute_dtype).float()

    with mock.patch.object(unet_mod, "conv3d_same", autograd_conv):
        y_ref = TiledPredictor(cfg)(served, vol)
    torch.cuda.synchronize()
    rel = rel_l2(y, y_ref)
    batches = pred.grid(tuple(vol.shape))[0].shape[0]
    emit({"phase": "unet_predictor", "card": card, "volume": list(vol.shape),
          "patches": pred.num_patches(vol.shape), "batches": batches, "seconds": secs,
          "mvox_per_s": vol.numel() / secs / 1e6, "k1_launches": launches,
          "k1_launches_per_batch": launches / batches, "rel_l2_vs_conv3d_same_autograd": rel,
          "max_abs_ref": float(y_ref.abs().max()), "out_std": float(y.std()),
          "tolerance": "rel L2 <= 1e-2 (K1's fp32 conv outputs against cuDNN's bf16 ones)",
          "profile": serve_prof, "phase_seconds": time.perf_counter() - t_phase})
    check(bool(torch.isfinite(y).all()) and y.shape == vol.shape and float(y.std()) > 0,
          "unet: bad prediction")
    check(launches == batches * num_convs, f"unet: K1 launched {launches} times in {batches} "
                                           f"batches, expected {num_convs} a batch")
    check(rel <= 1e-2, f"unet: K1 vs conv3d_same_autograd prediction rel L2 {rel}")
    del net, served, pred
    torch.cuda.empty_cache()


# ------------------------------------------------------ the device bank (A8b)

# the corpus's size at the JAX bench's volume (BENCH_r05.json): most volumes
# 32x624x924, a few smaller, so the bank is ragged; padded, 3.54 GB, just
# under the default 4 GiB budget
BANK_SHAPES = [(32, 624, 924)] * 20 + [(32, 400, 600), (32, 624, 700), (32, 512, 924),
                                       (32, 300, 300)]


def bank_store(seed):
    """A train store of BANK_SHAPES from the seed, 4 tasks: signal uniform,
    target an affine map of it (the sampler moves voxels, whatever they hold)."""
    rng = np.random.default_rng(seed)
    records = []
    for i, shape in enumerate(BANK_SHAPES):
        sig = rng.random(shape, dtype=np.float32)
        tgt = sig * np.float32(0.5) + np.float32(0.1)
        task = i % len(UNET_TASKS)
        records.append(VolumeRecord(sig, tgt, UNET_TASKS[task], task,
                                    {"path_czi": f"bank_{i}.czi"}))
    return VolumeStore(records, UNET_TASKS)


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def bank_phase(num_convs, card):
    """The device bank under on_device_pipeline auto: run_experiment with the
    native RepMode net for 2 epochs from a ragged train store of 24 volumes
    (3.54 GB padded): the bank is chosen and logged, K2/K3/K4 launch
    19/18/19 times a step, the batches the run drew repeat bit for bit from
    a fresh sampler on its bank; a check bank of the same extents whose
    padding is NaN and whose volumes hold their index shows every crop
    inside its volume and each volume visited once an epoch; then the step
    with the bank, with the host sampler and on a batch already on the card,
    in turns (sampler_share)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    train = bank_store(SEED + 90)
    make_s = time.perf_counter() - t0
    small = synthetic_store(UNET_TASKS[:1], 1, seed=SEED + 91)  # one val and one test volume
    cfg = Config(model=ModelConfig(train_s2d=False), data=DataConfig(adopted_datasets=UNET_TASKS),
                 train=TrainConfig(num_epochs=2, interval_val=2), eval=EvalConfig(s2d=False))
    nbytes = DeviceVolumeBank.padded_nbytes(train)
    check(0 < nbytes <= cfg.train.device_bank_budget_bytes, "bank: the store overflows the budget")

    built, drawn = [], []
    from_store = DeviceVolumeBank.from_store

    def timed_from_store(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        bank = from_store(*args, **kwargs)
        torch.cuda.synchronize()
        built.append((bank, time.perf_counter() - t))
        return bank

    def recording_sampler(*args, **kwargs):
        sample, steps = make_device_sampler(*args, **kwargs)

        def recorded(epoch, step):
            batch = sample(epoch, step)
            drawn.append(((epoch, step), {k: v.clone() for k, v in batch.items()}))
            return batch
        return recorded, steps

    logger = logging.getLogger("chip_smoke_bank")
    logger.setLevel(logging.INFO)
    lines = LogLines()
    logger.addHandler(lines)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bank_")
    try:
        with mock.patch.object(loop_mod.DeviceVolumeBank, "from_store", timed_from_store), \
                mock.patch.object(loop_mod, "make_device_sampler", recording_sampler):
            reset_counts()
            t0 = time.perf_counter()
            res = run_experiment(cfg.replace(path_exp_dir=tmp, exp_name="bank"),
                                 {"train": train, "val": small, "test": small},
                                 logger=logger, device="cuda")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = kernel_counts()
    finally:
        logger.removeHandler(lines)
        shutil.rmtree(tmp, ignore_errors=True)
    steps = res["state"].step
    bank, build_s = built[0]
    per_step = {k: counts[k] / steps for k in ("conv3d_same_persample",
                                               "conv3d_same_persample_transpose",
                                               "conv3d_dw_persample")}
    bank_lines = [x for x in lines.lines if "[DATA]" in x]
    out = {"phase": "bank_run", "card": card, "volumes": len(BANK_SHAPES),
           "bank_shape": list(bank.vol_shape), "bank_bytes": nbytes,
           "bank_bytes_allocated": bank.signals.numel() * 4 * 2,
           "budget_bytes": cfg.train.device_bank_budget_bytes, "store_make_seconds": make_s,
           "bank_build_seconds": build_s, "run_seconds": run_s, "steps": steps,
           "launches": counts, "launches_per_step": per_step, "log": bank_lines,
           "train_loss": res["train_log"]["loss/epoch"],
           "test_mse": res["test_log"]["metric_test/MSE"]}
    emit(out)
    check(len(built) == 1 and any("On-device pipeline: bank of 24 volumes" in x
                                  for x in bank_lines), "bank: auto did not take the bank")
    check(steps == 2 * 3 and len(drawn) == steps, f"bank: {steps} steps, expected 6")
    for k, v in zip(per_step, (num_convs, num_convs - 1, num_convs)):
        check(counts[k] == v * steps, f"bank: {k} launched {counts[k]} times in {steps} steps")
    check(counts["conv3d_same"] == 2 * num_convs, "bank: K1 launches outside val/test")
    check(np.isfinite(out["train_loss"]) and np.isfinite(out["test_mse"]), "bank: non-finite")

    # ---- the run's batches from a fresh sampler on its bank, bit for bit
    sample, _ = make_device_sampler(bank, cfg.train.batch_size, cfg.train.patch_size,
                                    cfg.train.random_flip_prob, seed=cfg.train.seed + 1)
    repeats = True
    for at, batch in reversed(drawn):  # a resume may start anywhere
        again = sample(*at)
        repeats &= all(torch.equal(again[k], batch[k]) for k in batch)
    del drawn

    # ---- a check bank: the run's extents, volume i holds i + 1, NaN padding
    v = bank.num_volumes
    check_bank = DeviceVolumeBank(torch.full_like(bank.signals, float("nan")),
                                  torch.full_like(bank.targets, float("nan")),
                                  torch.arange(v, dtype=torch.int32, device="cuda"),
                                  bank.extents.clone())
    for i, (d, h, w) in enumerate(BANK_SHAPES):
        check_bank.signals[i, :d, :h, :w] = i + 1
        check_bank.targets[i, :d, :h, :w] = -(i + 1)
    csample, csteps = make_device_sampler(check_bank, cfg.train.batch_size, cfg.train.patch_size,
                                          cfg.train.random_flip_prob, seed=cfg.train.seed + 1)
    visits, inside = [], True
    for epoch in range(2):
        seen = []
        for s in range(csteps):
            b = csample(epoch, s)
            idx = b["task"].long() + 1
            want = idx.float()[:, None, None, None, None]
            inside &= bool((b["signal"] == want).all()) and bool((b["target"] == -want).all())
            seen += b["task"].tolist()
        visits.append(np.bincount(seen, minlength=v).tolist())
    once = all(min(c) >= 1 and sum(c) == csteps * cfg.train.batch_size for c in visits)
    emit({"phase": "bank_law", "card": card, "run_batches_repeat_bit_for_bit": repeats,
          "crops_inside_extents_no_nan": inside, "visits_per_epoch": visits,
          "each_volume_once_an_epoch": once})
    check(repeats, "bank: a fresh sampler does not repeat the run's batches")
    check(inside, "bank: a crop read padding or another volume")
    check(once, "bank: an epoch missed a volume")
    del check_bank, csample
    torch.cuda.empty_cache()

    # ---- the step: bank, host sampler (native batcher), batch already on the card
    share = sampler_share(cfg, train, repeat=1, bank=bank)
    emit({"phase": "bank_step", "card": card, **share,
          "phase_seconds": time.perf_counter() - t_phase})
    check(all(np.isfinite(x) for x in share["step_ms_median"].values()), "bank: step timing")
    del bank, built, res
    torch.cuda.empty_cache()


def card_name_and_limit():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after build (a debugging aid: "
                         "prints no kernels or ok line); default: every phase")
    only = [p for p in ap.parse_args(argv).only.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = ModelConfig(train_s2d=False)  # mult_chan 32, depth 4, 5^3 kernels; native nets
    cfg_s2d = ModelConfig()  # the same net in the s2d layout, the default
    convs = serving_convs(cfg, PATCH, batch=8)
    check(len(convs) == 19, f"expected 19 convs, got {len(convs)}")
    card = card_name_and_limit()
    build_phase()
    if only:
        phases = {"kernel": lambda: kernel_phase(convs),
                  "model": lambda: model_phase(cfg, len(DEFAULT_DATASETS)),
                  "serve": lambda: serve_phase(cfg, len(convs)),
                  "train_kernel": lambda: train_kernel_phase(convs),
                  "train": lambda: train_phase(len(convs)),
                  "train_step": lambda: train_step_phase(convs, num_tasks=4),
                  "train_check": lambda: train_check_phase(num_tasks=4),
                  "train_faults": lambda: train_faults_phase(len(convs), num_tasks=4),
                  "ingest": lambda: ingest_phase(len(convs), card),
                  "unet": lambda: unet_phase(len(convs), card),
                  "bank": lambda: bank_phase(len(convs), card),
                  "s2d_kernel": lambda: s2d_kernel_phase(cfg),
                  "serve_s2d": lambda: serve_s2d_phase(cfg),
                  "train_s2d_kernel": lambda: train_s2d_kernel_phase(cfg_s2d),
                  "train_s2d": lambda: train_s2d_phase(cfg_s2d),
                  "train_s2d_step": lambda: train_s2d_step_phase(num_tasks=4),
                  "train_s2d_check": lambda: train_s2d_check_phase(num_tasks=4)}
        for name in only:
            phases[name]()
            torch.cuda.empty_cache()
        print(f"total seconds {time.perf_counter() - t_start:.1f}", file=sys.stderr)
        return 0

    t0 = time.perf_counter()
    totals = kernel_phase(convs)
    emit({"phase": "kernel_done", "seconds": time.perf_counter() - t0})
    model_phase(cfg, len(DEFAULT_DATASETS))
    torch.cuda.empty_cache()
    serve_launches = serve_phase(cfg, len(convs))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s2d_totals = s2d_kernel_phase(cfg)
    emit({"phase": "s2d_kernel_done", "seconds": time.perf_counter() - t0})
    s2d_counts = serve_s2d_phase(cfg)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_totals = train_kernel_phase(convs)
    emit({"phase": "train_kernel_done", "seconds": time.perf_counter() - t0})
    train_counts = train_phase(len(convs))
    torch.cuda.empty_cache()
    train_step_phase(convs, num_tasks=4)
    train_check_phase(num_tasks=4)
    torch.cuda.empty_cache()
    train_faults_phase(len(convs), num_tasks=4)
    torch.cuda.empty_cache()
    ingest_phase(len(convs), card)
    torch.cuda.empty_cache()
    unet_phase(len(convs), card)
    torch.cuda.empty_cache()
    bank_phase(len(convs), card)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k6_totals, s2d_train_totals = train_s2d_kernel_phase(cfg_s2d)
    emit({"phase": "train_s2d_kernel_done", "seconds": time.perf_counter() - t0,
          "s2d_levels_per_step": s2d_train_totals})
    s2d_train_counts = train_s2d_phase(cfg_s2d)
    torch.cuda.empty_cache()
    train_s2d_step_phase(num_tasks=4)
    train_s2d_check_phase(num_tasks=4)

    def entry(name, source, replaces, launches, t):
        return {"name": name, "route": "cuda", "source": f"repmode_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
                "library_ms": t["library_ms"]}

    emit({"kernels": [
        entry("conv3d_same", "conv3d_same.cu", "repmode_tpu/ops/pallas/conv3d.py:641",
              serve_launches, totals),
        entry("conv3d_same_persample", "conv3d_persample.cu",
              "repmode_tpu/ops/pallas/conv3d.py:396", train_counts["conv3d_same_persample"],
              train_totals["conv3d_same_persample"]),
        entry("conv3d_same_persample_transpose_taps", "conv3d_persample.cu",
              "repmode_tpu/ops/pallas/conv3d.py:396",
              train_counts["conv3d_same_persample_transpose"],
              train_totals["conv3d_same_persample_T"]),
        entry("conv3d_dw_persample", "conv3d_dw_persample.cu",
              "repmode_tpu/ops/pallas/conv3d.py:553", train_counts["conv3d_dw_persample"],
              train_totals["conv3d_dw_persample"]),
        entry("conv3d_dpad", "conv3d_dpad.cu", "repmode_tpu/ops/pallas/conv3d.py:242",
              s2d_counts["conv3d_dpad"], s2d_totals),
        entry("conv3d_tapconcat_persample", "conv3d_tapconcat.cu",
              "tools/bench_enc1c1_kernel.py:85", s2d_train_counts["conv3d_tapconcat_persample"],
              k6_totals),
    ]})
    print(card, flush=True)
    print(f"total seconds {time.perf_counter() - t_start:.1f}", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
