"""A run of each cell on the CPU at a small size, with the chip check skipped:
the keys of the result line, ``correct`` true on the sound program, and
``correct`` false with each fault the cell can have planted under the timed
path (``benchmark/faults.py``). The program runs in float32 here, so the
committed limits, set from bfloat16 on the card, are far above its readings."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import cell, counts, faults, run, spec, trace

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


def small_cell(name):
    w = spec.workload(name, spec.benchmark())
    cfg = spec.config(w["config"])
    cli = [a if a != "bfloat16" else "float32" for a in cfg["cli"]]
    return {"config": {"mult_chan": 4, "depth": 2, "train_records": 8, "distinct_volumes": 4,
                       "cli": cli, "compute_dtype": "float32"},
            "traffic": {"volume_shape": [16, 40, 48], "patch_size": [16, 32, 32],
                        "batch_size": 2, "batch_size_eval": 2, "trace_first": 1,
                        "trace_units": 1}}


def run_small(name, traced=False, seconds=0.2):
    torch.set_num_threads(2)
    return cell.run(name, 2**31 + 11, seconds, traced, torch.device("cpu"), time.perf_counter(),
                    small=small_cell(name))


@pytest.mark.parametrize("name", WORKLOADS)
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(spec.limits(name))


def _faults(name):
    w = spec.workload(name, spec.benchmark())
    kind = spec.traffic(w["traffic"])["kind"]
    cfg = {**spec.config(w["config"]), **small_cell(name)["config"]}
    grid = counts.tiling_patch_count((16, 40, 48), (16, 32, 32))
    return [(name, f, plant) for f, plant in faults.for_kind(kind, -(-grid // 2), cfg).items()]


@pytest.mark.parametrize("name,fault,plant", [f for w in WORKLOADS for f in _faults(w)],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_planted_fault_is_not_correct(name, fault, plant):
    with plant():
        out = run_small(name)
    assert not out["correct"], (fault, out["numbers"])


def test_result_line_keys(monkeypatch):
    monkeypatch.setattr(run, "device_line", lambda dev, peak: {"platform": "gpu", "kind": "k",
                                                               "count": 1,
                                                               "memory_peak_bytes": peak})
    name = "repmode.serve"
    out = run_small(name)
    out["kind"], out["voxels"] = "serve", 16 * 40 * 48 * out["units"]
    line = run.result_line(spec.benchmark(), name, out, False, None)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"setup_s", "serve_vox_per_s"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_result_line_from_a_reading(monkeypatch):
    monkeypatch.setattr(run, "device_line", lambda dev, peak: {"platform": "gpu", "kind": "k",
                                                               "count": 1,
                                                               "memory_peak_bytes": peak})
    reading = trace.Reading(kind="train", units=3, window_s=1.0, busy_s=0.9,
                            bucket_s={"k2_conv3d_persample": 0.1, "gemm": 0.05, "copies": 0.2},
                            conv_buckets=("k2_conv3d_persample",), merge_buckets=("gemm",),
                            model_flops=9.89e13, conv_bound_s=0.05, peak_flops=989e12,
                            peak_bytes_per_s=3.35e12)
    out = {"correct": True, "attempted": 5, "failed": 0, "memory_peak_bytes": 1, "kind": "train",
           "reading": reading, "checks": {"loss_gap": {"value": 0.0, "limit": 1.0}},
           "trace": {"busy_s": 0.9, "window_s": 1.0,
                     "breakdown": {"device_ops": [["a", 0.1]], "idle_gaps": [["b", 0.1]]}}}
    line = run.result_line(spec.benchmark(), "repmode.train", out, True, None)
    m = line["metrics"]
    assert m["device_idle_share.train"]["value"] == pytest.approx(10.0)
    assert m["mfu.train"]["value"] == pytest.approx(10.0)
    assert m["conv_roofline.train"]["value"] == pytest.approx(50.0)
    assert m["glue_ms.train"]["value"] == pytest.approx(1e3 * 0.2 / 3)
    assert m["merge_ms.train"]["value"] == pytest.approx(1e3 * 0.05 / 3)
    assert "mfu.serve" not in m
    assert list(line)[-1] == "checks" and line["breakdown"]["device_ops"]


def test_trace_summary_from_events():
    t = trace.Tracer(torch.device("cpu"), 1, 1)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    t.events = [("ProfilerStep#1", cpu, 0.0, 1000.0),
                ("bench.step", cpu, 0.0, 900.0), ("aten::copy_", cpu, 100.0, 300.0),
                ("conv3d_same_kernel<1>", cuda, 50.0, 100.0),
                ("conv3d_same_kernel<1>", cuda, 80.0, 150.0),      # overlaps: busy is a union
                ("vectorized_elementwise_kernel", cuda, 400.0, 900.0),
                ("ProfilerStep#1", cuda, 0.0, 1000.0)]
    s = t.summary(spec.buckets())
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(600e-6)
    assert s["bucket_s"]["k1_conv3d_same"] == pytest.approx(120e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["bench.step > aten::copy_"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(400e-6)


def test_traced_window_waits_for_its_units():
    out = run_small("repmode.serve", traced=True, seconds=0.0)
    assert out["units"] >= 2     # the dropped unit and the traced one


def test_process_age_from_proc(tmp_path):
    tck = os.sysconf("SC_CLK_TCK")
    (tmp_path / "stat").write_text("4242 (python3 -m) ) " + " ".join(
        ["S"] + ["0"] * 18 + [str(250 * tck)] + ["0"] * 30))
    (tmp_path / "uptime").write_text("262.5 9000.0\n")
    assert run.process_age_s(str(tmp_path / "stat"), str(tmp_path / "uptime")) == \
        pytest.approx(12.5)
    assert run.process_age_s(str(tmp_path / "none"), str(tmp_path / "uptime")) == 0.0


def _fake_main(monkeypatch, out):
    """``run.main`` with a card faked and ``cell.run`` giving ``out``; returns
    what ``cell.run`` was called with."""
    calls = []

    def fake_run(*args, **kwargs):
        calls.append((args, kwargs))
        return out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "device_line", lambda dev, peak: {"platform": "gpu", "kind": "k",
                                                               "count": 1,
                                                               "memory_peak_bytes": peak})
    monkeypatch.setattr(cell, "run", fake_run)
    return calls


def _fake_out(traced):
    reading = trace.Reading(kind="train", units=3, window_s=1.0, busy_s=0.9,
                            bucket_s={"k2_conv3d_persample": 0.1, "gemm": 0.05},
                            conv_buckets=("k2_conv3d_persample",), merge_buckets=("gemm",),
                            model_flops=9.89e13, conv_bound_s=0.05, peak_flops=989e12,
                            peak_bytes_per_s=3.35e12)
    return {"correct": True, "attempted": 3, "failed": 0, "memory_peak_bytes": 1,
            "numbers": {}, "checks": {}, "setup_s": 1.0, "setup_phases": {}, "window_s": 1.0,
            "units": 3, "check_s": 0.0, "reading": reading if traced else None,
            "trace": {"busy_s": 0.9, "window_s": 1.0,
                      "breakdown": {"device_ops": [], "idle_gaps": []}} if traced else None}


def test_setup_counts_from_the_process_start(monkeypatch, capsys):
    """The process's start is read once, at the top of run.py, with the clock
    beside it: main hands that moment on and never reads the age again (a
    later reading would place the start earlier by everything imported since)."""
    calls = _fake_main(monkeypatch, _fake_out(False))

    def late(*a, **k):
        raise AssertionError("the process's age is read again after the imports")

    monkeypatch.setattr(run, "process_age_s", late)
    before = time.perf_counter()
    assert run.main(["--workload", "repmode.train", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 0
    (args, kwargs), = calls
    assert args[5] == run.STARTED < before
    assert 0.0 <= kwargs["marks"]["python_and_torch_import"] <= time.perf_counter() - run.STARTED
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


def test_started_agrees_with_the_age_at_import():
    code = ("import time; from benchmark import run; t = time.perf_counter(); "
            "print(t - run.STARTED, run.process_age_s())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    since_start, age = map(float, out.stdout.split())
    assert since_start == pytest.approx(age, abs=0.05)


def test_a_reader_that_loads_jax_stops_the_result(monkeypatch, tmp_path, capsys):
    """The look for JAX comes after every reader has been loaded and run: a
    reader that imports ``jax`` (a stub here) leaves exit 4 and no result."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    had = sys.modules.pop("jax", None)

    def reader(name):
        def read(reading):
            import jax  # noqa: F401
            return 1.0
        return read

    _fake_main(monkeypatch, _fake_out(True))
    monkeypatch.setattr(spec, "reader", reader)
    try:
        rc = run.main(["--workload", "repmode.train", "--seed", "1", "--seconds", "1",
                       "--trace", "1"])
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had
    assert rc == 4
    assert not capsys.readouterr().out.strip()
