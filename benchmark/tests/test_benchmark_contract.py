"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece by name from its own file."""

import json
import re
import statistics

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    assert len(json.dumps(bench)) <= 64 * 1024


def test_full_check_fits(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        data = spec.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank", "_size"))
            assert key in data and key in data["source_values"]


@pytest.mark.parametrize("group", ["workloads", "end_to_end", "per_layer"])
def test_entry_keys(bench, group):
    allowed = {"workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for e in bench[group]:
        assert set(e) <= allowed[group], e
        for text in (e.get("why"), e.get("layer")):
            assert text is None or (1 <= len(text) <= 200 and "\n" not in text and "\t" not in text)


def test_workloads_find_their_files(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        assert mix["kind"] in ("serve", "train")
        limits = spec.limits(w["name"])
        assert limits and all(v > 0 for v in limits.values())


def test_end_to_end(bench):
    names = {m["name"]: m for m in bench["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in SOURCES_E2E
    for w in bench["workloads"]:
        reported = [m["name"] for m in spec.end_to_end(bench, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2


def test_per_layer_readers_and_moves(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        assert spec.per_layer(bench, w["name"])


def test_buckets_found_by_name():
    table = spec.buckets()
    names = [b.name for b in table]
    assert len(names) == len(set(names))
    assert [b.order for b in table] == sorted(b.order for b in table)
    assert spec.bucket_of("void conv3d_same_kernel<128>(...)", table) == "k1_conv3d_same"
    assert spec.bucket_of("conv3d_persample_kernel<64, false>", table) == "k2_conv3d_persample"
    assert spec.bucket_of("conv3d_persample_kernel<64, true>", table) == \
        "k3_conv3d_persample_transpose"
    assert spec.bucket_of("sm90_xmma_fprop_implicit_gemm_bf16", table) == "cudnn_conv"
    assert spec.bucket_of("nvjet_tst_128x64", table) == "gemm"
    assert spec.bucket_of("void at::native::vectorized_elementwise_kernel<4>", table) == \
        "elementwise"
    assert spec.bucket_of("Memcpy HtoD (Pageable -> Device)", table) == "copies"
    assert spec.bucket_of("something else", table) == "other"
    assert {b.name for b in table if b.conv} >= {"k1_conv3d_same", "cudnn_conv"}


def test_quartile_spread_rule():
    # the spread the bounds were set from: (Q3 - Q1) / median, Python's quantiles
    values = [300.0, 301.0, 299.0, 300.5, 302.0, 300.2]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert 0 < (q3 - q1) / statistics.median(values) < 0.01
