"""Time variants of K4's source in turns, at every K4 call of a train step.

    python -m repmode_tpu_torch.ops.kernels.k4_variants NEW=path/a.cu OLD=path/b.cu [--out f.json]

Compiles each source (``conv3d_dw_persample.cu`` or an edited copy of it;
local headers are found in ``repmode_tpu_torch/csrc``) with the flags of
``ops/kernels/build.py``, in parallel, then, at each distinct K4 shape of
the full-width train steps (batch 8 of 32x128x128, native and s2d
layouts), launches every variant on the same bf16 inputs: each is held
against the first variant whose C interface is the current one (its max
|difference| over max |value| is printed), then timed with CUDA events (10
launches after 2, twice, the variants in order and then in reverse). A
variant with the older interface (``conv3d_dw_persample_splits``, before
the wgmma instance) runs at its own split count. It times the kernel
launches alone: no operand packing, no output unpacking. Needs the card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from repmode_tpu_torch.ops import conv3d
from repmode_tpu_torch.ops.kernels import build

# (D, H, W, Ci, Co, taps) of each distinct K4 call a step, batch 8
SHAPES = [
    (32, 128, 128, 1, 32, (5, 5, 5)), (32, 128, 128, 32, 32, (5, 5, 5)),
    (16, 64, 64, 32, 64, (5, 5, 5)), (16, 64, 64, 64, 64, (5, 5, 5)),
    (8, 32, 32, 64, 128, (5, 5, 5)), (8, 32, 32, 128, 128, (5, 5, 5)),
    (4, 16, 16, 128, 256, (5, 5, 5)), (4, 16, 16, 256, 256, (5, 5, 5)),
    (2, 8, 8, 256, 512, (5, 5, 5)), (2, 8, 8, 512, 512, (5, 5, 5)),
    (4, 16, 16, 512, 256, (5, 5, 5)), (8, 32, 32, 256, 128, (5, 5, 5)),
    (16, 64, 64, 128, 64, (5, 5, 5)), (32, 128, 128, 64, 32, (5, 5, 5)),
    (32, 128, 128, 32, 1, (5, 5, 5)),
    (32, 64, 64, 4, 128, (5, 3, 3)), (32, 64, 64, 128, 128, (5, 3, 3)),
    (16, 32, 32, 128, 256, (5, 3, 3)), (16, 32, 32, 256, 256, (5, 3, 3)),
    (16, 32, 32, 512, 256, (5, 3, 3)), (32, 64, 64, 256, 128, (5, 3, 3)),
]


def load_variants(variants, out_dir: Path) -> dict:
    """{label: (library, has the current C interface)}, built in parallel."""
    procs = {}
    for label, src in variants:
        lib_path = out_dir / f"lib_{label}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib_path),
               src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib_path)
    libs = {}
    for label, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        current = not hasattr(lib, "conv3d_dw_persample_splits")
        if current:
            lib.conv3d_dw_persample_plan.argtypes = [i32] * 10 + [ctypes.POINTER(i32)]
            lib.conv3d_dw_persample_plan.restype = i32
            lib.conv3d_dw_persample_bf16.argtypes = [ptr] * 4 + [i32] * 11 + [ptr]
        else:
            lib.conv3d_dw_persample_splits.argtypes = [i32] * 9
            lib.conv3d_dw_persample_splits.restype = i32
            lib.conv3d_dw_persample_bf16.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
        lib.conv3d_dw_persample_bf16.restype = i32
        libs[label] = (lib, current)
    return libs


def launcher(lib, current, xb, dyb, kd, kh, kw, sms, stream):
    """(launch, plan summary) of one variant on packed operands."""
    n, d, h, wl, ci = xb.shape
    co = dyb.shape[-1]
    if current:
        o = (ctypes.c_int * 13)()
        lib.conv3d_dw_persample_plan(n, d, h, wl, ci, co, kd, kh, kw, sms, o)
        splits = o[5]
        info = {"instance": o[0], "tile": f"{o[2]}x{o[3]}", "splits": splits, "stages": o[9],
                "registers": o[6], "local_bytes": o[7]}
    else:
        splits = lib.conv3d_dw_persample_splits(n, d, h, wl, ci, co, kd, kh, kw)
        info = {"splits": splits}
    y = torch.empty((n, kd, kh, kw, ci, co), device=xb.device)
    work = torch.empty((splits, *y.shape), device=xb.device) if splits > 1 else None
    args = [xb.data_ptr(), dyb.data_ptr(), y.data_ptr(),
            None if work is None else work.data_ptr(), n, d, h, wl, ci, co, kd, kh, kw]
    args += [sms, splits] if current else []

    def launch():
        err = lib.conv3d_dw_persample_bf16(*args, stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({err}) at {tuple(xb.shape)} -> {co}")
        return y

    launch.buffers = (y, work)  # the kernel writes them: keep them alive with the launcher

    return launch, info


def time_ms(fn, reps=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="LABEL=path/to/conv3d_dw_persample.cu")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: no CUDA device; this script runs on the card")
    variants = [v.split("=", 1) for v in args.variants]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = load_variants(variants, Path(tmp))
        ref_label = next(label for label, (_, current) in libs.items() if current)
        rows = []
        for d, h, w, ci, co, taps in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(1)
            x = torch.randn((8, d, h, w, ci), generator=gen, device=dev).to(torch.bfloat16)
            dy = torch.randn((8, d, h, w, co), generator=gen, device=dev).to(torch.bfloat16)
            xb, dyb, kw = conv3d._dw_operands(x, dy, taps[2])
            xb, dyb = conv3d._aligned(xb), conv3d._aligned(dyb)
            runs = {label: launcher(lib, current, xb, dyb, taps[0], taps[1], kw, sms, stream)
                    for label, (lib, current) in libs.items()}
            outs = {label: launch().clone() for label, (launch, _) in runs.items()}
            ref = outs[ref_label].double()
            top = ref.abs().max().item()
            ms = {label: [] for label in runs}
            for order in (list(runs), list(reversed(runs))):
                for label in order:
                    ms[label].append(time_ms(runs[label][0]))
            row = {"x": [8, d, h, w, ci], "co": co, "taps": list(taps),
                   "ms": {label: sum(v) / len(v) for label, v in ms.items()},
                   "turns_ms": ms,
                   "rel_diff": {label: (o.double() - ref).abs().max().item() / top
                                for label, o in outs.items()},
                   "plan": {label: info for label, (_, info) in runs.items()}}
            rows.append(row)
            print(json.dumps({k: row[k] for k in ("x", "co", "taps", "ms", "rel_diff", "plan")}),
                  flush=True)
            del x, dy, xb, dyb, outs, runs
            torch.cuda.empty_cache()
    print(json.dumps({"sum_ms": {label: sum(r["ms"][label] for r in rows) for label in libs}}))
    if args.out:
        Path(args.out).write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
