"""Time K6's instances, edited copies of its source and the card's write
floor, in turns, at the full-width training shape.

    python -m repmode_tpu_torch.ops.kernels.k6_variants LABEL=path.cu[:opt,...] ... [--out f.json]

Each ``LABEL=path`` names a copy of ``conv3d_tapconcat.cu`` (local headers
are found in ``repmode_tpu_torch/csrc``), compiled with the flags of
``ops/kernels/build.py``, all in parallel. Options after the colon:

  mma_sync, wgmma  the instance to launch (a source with the plan interface;
                   default: the one its plan picks); a source without it
                   has only the mma.sync kernel;
  no_store         probe: the mma.sync kernel's epilogue stores nothing;
  no_patch         probe: its patch matrix is not built (left stale);
  weights_once     probe: only block 0 copies the weights, the other
                   blocks read stale shared memory;
  no_mma           probe: its MMA loop is skipped;
  wg_no_store, wg_no_build, wg_no_mma, wg_no_staging
                   probes of the wgmma kernel: no TMA store, no paired slab
                   built (the plain slabs still land), no wgmma, no bf16
                   writes to the staging tile.

A probe leaves one phase out of a kernel so that its share of the time
shows; its output is wrong by design. Every variant
is launched on the same bf16 inputs, x (8, 32, 64, 64, 4) -> Co 128 unless
``--shape`` says otherwise; each is held against the first variant without
a probe (its max |difference| over max |value| is printed), then timed with
CUDA events (20 launches after 3), the variants in order and then in
reverse, twice. Also timed, as a yardstick: a plain write of y's bytes
(``y.zero_()``), the card's practical write floor. It times the kernel
launches alone (no wrapper). Needs the card and nvcc.
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

# probe -> (text of the mma.sync kernel, its replacement); each text occurs once
PROBES = {
    "no_store": ("if (r >= cur.rows) continue;", "if (r >= cur.rows || p.cout > 0) continue;"),
    "no_patch": ("for (int i = tid; i < BM * TAP_SLOTS; i += THREADS) {",
                 "for (int i = tid; i < BM * TAP_SLOTS * (p.cout < 0); i += THREADS) {"),
    "weights_once": ("for (int i = tid; i < KP * (BN / 8); i += THREADS) {",
                     "for (int i = tid; i < KP * (BN / 8) * (blockIdx.x == 0); i += THREADS) {"),
    "no_mma": ("for (int kk = 0; kk < KP / 16; ++kk) {",
               "for (int kk = 0; kk < KP / 16 * (p.cout < 0); ++kk) {"),
    # the wgmma kernel's phases
    "wg_no_store": ("        tma_store_5d(&tmy, ", "        if (p.d < 0) tma_store_5d(&tmy, "),
    "wg_no_build": ("      build_pairs(p, walk, reinterpret_cast<const uint2*>(gen + x_base + nb",
                    "      if (p.d < 0) build_pairs(p, walk, reinterpret_cast<const uint2*>(gen + x_base + nb"),
    "wg_no_mma": ("      tcw_group_mma<BN_>(acc, a + ", "      if (p.d < 0) tcw_group_mma<BN_>(acc, a + "),
    "wg_no_staging": ("        *reinterpret_cast<__nv_bfloat162*>(yt + ",
                      "        if (p.d < 0) *reinterpret_cast<__nv_bfloat162*>(yt + "),
}
INSTANCES = ("mma_sync", "wgmma")


def parse(spec: str):
    label, rest = spec.split("=", 1)
    path, _, opts = rest.partition(":")
    opts = [o for o in opts.split(",") if o]
    bad = [o for o in opts if o not in PROBES and o not in INSTANCES]
    if bad:
        raise SystemExit(f"k6_variants: unknown options {bad} in {spec!r}")
    return label, Path(path), opts


def probed_source(path: Path, probes, out: Path) -> Path:
    text = path.read_text()
    for name in probes:
        old, new = PROBES[name]
        if text.count(old) != 1:
            raise SystemExit(f"k6_variants: probe {name} expects one {old!r} in {path}")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def load_variants(variants, out_dir: Path) -> dict:
    """{label: (library, has the plan interface, options)}, built in parallel."""
    procs = {}
    for label, path, opts in variants:
        src = probed_source(path, [o for o in opts if o in PROBES], out_dir / f"{label}.cu")
        lib_path = out_dir / f"lib_{label}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib_path),
               str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib_path, opts)
    libs = {}
    for label, (proc, lib_path, opts) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        planned = hasattr(lib, "conv3d_tapconcat_plan")
        if planned:
            lib.conv3d_tapconcat_plan.argtypes = [i32] * 8 + [ctypes.POINTER(i32)]
            lib.conv3d_tapconcat_plan.restype = i32
            lib.conv3d_tapconcat_bf16.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
        else:
            lib.conv3d_tapconcat_bf16.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        lib.conv3d_tapconcat_bf16.restype = i32
        libs[label] = (lib, planned, opts)
    return libs


def launcher(lib, planned, opts, x, wn, sms, stream):
    """(launch, plan summary) of one variant."""
    n, d, h, wl, _ = x.shape
    co = wn.shape[-1]
    y = torch.empty((n, d, h, wl, co), dtype=torch.bfloat16, device=x.device)
    args = [x.data_ptr(), wn.data_ptr(), y.data_ptr(), n, d, h, wl, co, co]
    info = {"instance": "mma_sync"}
    if planned:
        forced = [o for o in opts if o in INSTANCES]
        plan = conv3d.conv3d_tapconcat_persample_plan(tuple(x.shape), co, num_sms=sms)
        instance = forced[0] if forced else plan["instance"]
        o = (ctypes.c_int * 5)()
        err = lib.conv3d_tapconcat_plan(n, d, h, wl, co, co, INSTANCES.index(instance), sms, o)
        if err:
            raise RuntimeError(f"plan of {instance} refused ({err})")
        info = {"instance": instance, "smem_bytes": o[0], "grid": [o[1], o[2]],
                "registers": o[3], "local_bytes": o[4]}
        args += [INSTANCES.index(instance), sms]

    def launch():
        err = lib.conv3d_tapconcat_bf16(*args, stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({err}) at {tuple(x.shape)} -> {co}")
        return y

    launch.buffers = (y,)  # the kernel writes it: keep it alive with the launcher
    return launch, info


def time_ms(fn, reps=20, warmup=3) -> float:
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
    ap.add_argument("variants", nargs="+", help="LABEL=path/to/conv3d_tapconcat.cu[:opt,...]")
    ap.add_argument("--shape", default="8,32,64,64,128", help="N,D,H,W,Co")
    ap.add_argument("--out", help="write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_variants: no CUDA device; this script runs on the card")
    variants = [parse(v) for v in args.variants]
    n, d, h, wl, co = (int(v) for v in args.shape.split(","))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, d, h, wl, 4), generator=gen, device=dev).to(torch.bfloat16)
    wn = (torch.randn((n, 180, co), generator=gen, device=dev) / 180 ** 0.5).to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        libs = load_variants(variants, Path(tmp))
        runs = {label: launcher(lib, planned, opts, x, wn, sms, stream)
                for label, (lib, planned, opts) in libs.items()}
        y_floor = torch.empty((n, d, h, wl, co), dtype=torch.bfloat16, device=dev)
        runs["write_floor"] = (y_floor.zero_, {"call": "y.zero_()"})
        outs = {label: launch().clone() for label, (launch, _) in runs.items()
                if label != "write_floor"}
        ref_label = next(label for label, (_, _, opts) in libs.items()
                         if not any(o in PROBES for o in opts))
        ref = outs[ref_label].double()
        top = ref.abs().max().item()
        ms = {label: [] for label in runs}
        for _ in range(2):
            for order in (list(runs), list(reversed(runs))):
                for label in order:
                    ms[label].append(time_ms(runs[label][0]))
    ybytes = n * d * h * wl * co * 2
    result = {"x": [n, d, h, wl, 4], "co": co,
              "device": torch.cuda.get_device_name(0),
              "ms": {label: sum(v) / len(v) for label, v in ms.items()},
              "turns_ms": ms,
              "y_tb_per_s": {label: ybytes / (sum(v) / len(v)) / 1e9 for label, v in ms.items()},
              "rel_diff": {label: (o.double() - ref).abs().max().item() / top
                           for label, o in outs.items()},
              "plan": {label: info for label, (_, info) in runs.items()}}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
