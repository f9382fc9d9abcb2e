"""The port's run scripts (``scripts_torch/``) against the JAX package's
(``scripts/``), on the CPU:

  * flags: with a stub ``python``/``python3`` first on PATH that prints its
    argv, each port script gives the argv of the JAX script it mirrors with
    the package renamed (``only_eval.sh`` takes the port's ``.p`` checkpoint
    through ``--torch_checkpoint`` where the JAX script passes an Orbax
    directory to ``--path_load_model``), from any working directory, with
    the repo root first on PYTHONPATH;
  * dataset files: the three dataset scripts, run for real on a copy of
    ``data/csvs/``, write files byte-equal to the JAX scripts'. The JAX
    scripts start one pandas process a task (23 in all), so their Python
    bodies are read out of the scripts and run in this process, in the
    scripts' order, with the argv each process would get;
  * the run chain: ``train_and_eval.sh`` then ``only_eval.sh`` on the
    checkpoint it leaves, at mult_chan 2 on synthetic data under
    ``--device cpu``: the same test metrics;
  * the card mode of ``tests.sh``: it collects the CUDA tests and skips them
    all here, with a ``jax`` that raises on import first on PYTHONPATH;
  * the scripts' common rules, and that none names the JAX package.
"""

import csv
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "scripts_torch")
JAX = os.path.join(REPO, "scripts")
SCRIPTS = ("run/train_and_eval.sh", "run/only_eval.sh", "run/tests.sh",
           "dataset/split_train_set.sh", "dataset/split_val_set.sh",
           "dataset/make_dna_dataset.sh", "dataset/integ_dataset.sh")

STUB = """#!{python}
import json, os, sys
print(json.dumps({{"argv": sys.argv[1:], "cwd": os.getcwd(),
                  "pythonpath": os.environ.get("PYTHONPATH", "").split(os.pathsep)[0]}}))
"""


def script_env(bin_dir, **extra):
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               OMP_NUM_THREADS="2", WANDB_MODE="disabled", **extra)
    env.pop("PYTHONPATH", None)
    return env


def interpreter_dir(tmp_path, stub):
    """A directory holding ``python`` and ``python3``: the stub that prints
    its argv, or this test's own interpreter."""
    d = tmp_path / ("stub_bin" if stub else "bin")
    d.mkdir()
    for name in ("python", "python3"):
        (d / name).write_text(STUB.format(python=sys.executable) if stub
                              else f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        (d / name).chmod(0o755)
    return d


def run_script(path, args, cwd, env, check=True):
    res = subprocess.run(["bash", path, *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    if check:
        assert res.returncode == 0, f"{path} {args}: rc {res.returncode}\n{res.stdout}\n{res.stderr}"
    return res


# ------------------------------------------------------------------ flags

RUN_CASES = {
    "train_and_eval_defaults": ("run/train_and_eval.sh", []),
    "train_and_eval_args": ("run/train_and_eval.sh",
                            ["UNet", "exps/u", "--num_epochs", "2", "--device", "cpu"]),
    "only_eval_defaults": ("run/only_eval.sh", []),
    "only_eval_args": ("run/only_eval.sh", ["UNet", "exps/e", "exps/u/checkpoints/model_best_u",
                                            "--device", "cpu", "--save_test_preds"]),
    "integ_dataset_defaults": ("dataset/integ_dataset.sh", []),
    "integ_dataset_args": ("dataset/integ_dataset.sh", ["--device", "cpu"]),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_script_flags_match_jax(case, tmp_path):
    """The port script's argv is the JAX script's with the package renamed;
    only_eval.sh's checkpoint is the port's .p file, named by
    --torch_checkpoint; integ_dataset.sh passes its arguments on, which the
    JAX script drops."""
    rel, args = RUN_CASES[case]
    env = script_env(interpreter_dir(tmp_path, stub=True))
    work = tmp_path / "work"
    work.mkdir()
    port = json.loads(run_script(os.path.join(PORT, rel), args, work, env).stdout)
    jax = json.loads(run_script(os.path.join(JAX, rel), args, work, env).stdout)
    want = [a.replace("repmode_tpu.", "repmode_tpu_torch.") for a in jax["argv"]]
    if rel == "run/only_eval.sh":
        i = want.index("--path_load_model")
        want[i] = "--torch_checkpoint"
        if not args:
            assert want[i + 1] == "exps/test/checkpoints/model_best_test"
            want[i + 1] += ".p"
    if rel == "dataset/integ_dataset.sh":
        want += args
    assert port["argv"] == want
    assert port["argv"][:2] in (["-m", "repmode_tpu_torch.cli.train"],
                                ["-m", "repmode_tpu_torch.cli.evaluate"])
    assert "--device" not in port["argv"][:-len(args) or None]
    assert port["cwd"] == str(work)  # data/ and exps/ stay relative to it
    assert port["pythonpath"] == REPO


@pytest.mark.parametrize("mode", ["cpu", "default", "cuda", "other"])
def test_tests_script_modes(mode, tmp_path):
    """tests.sh: cpu (the default) runs the port's CPU tests with the JAX
    script's xdist rule, cuda the kernel tests without tests/conftest.py,
    any other mode prints the usage and exits 2; it runs from the repo
    root wherever it is called from."""
    env = script_env(interpreter_dir(tmp_path, stub=True))
    args = {"cpu": ["cpu", "-k", "x"], "default": [], "cuda": ["cuda", "-x"],
            "other": ["quick"]}[mode]
    res = run_script(os.path.join(PORT, "run/tests.sh"), args, tmp_path, env,
                     check=mode != "other")
    if mode == "other":
        assert res.returncode == 2 and "usage:" in res.stderr and not res.stdout
        return
    got = json.loads(res.stdout)
    assert got["cwd"] == REPO and got["pythonpath"] == REPO
    if mode == "cuda":
        assert got["argv"] == ["-m", "pytest", "--noconftest", "-q", "-m", "cuda",
                               "tests/test_torch_port_cuda.py", "-x"]
        return
    files = sorted(f"tests/{f}" for f in os.listdir(os.path.join(REPO, "tests"))
                   if f.startswith("test_torch_port_") and f.endswith(".py"))
    nproc = len(os.sched_getaffinity(0))
    xdist = ["-n", str(nproc), "--dist", "loadfile"] if nproc > 1 else []
    argv = got["argv"]
    assert argv[:2] == ["-m", "pytest"] and sorted(argv[2:2 + len(files)]) == files
    assert argv[2 + len(files):] == ["-q", *xdist, *args[1:]]


# ---------------------------------------------------------- dataset files

def jax_script_processes(rel):
    """The Python body of a JAX dataset script and the argv of each process
    it starts, read out of the script."""
    with open(os.path.join(JAX, rel)) as f:
        text = f.read()
    body = re.search(r"<<'PY'\n(.*?)\nPY\n", text, re.S).group(1)
    loop = re.search(r"for name in (.*?); do", text, re.S)
    if loop is None:
        return body, [["-"]]
    return body, [["-", name] for name in loop.group(1).replace("\\", " ").split()]


def tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_dataset_scripts_write_the_jax_scripts_files(tmp_path, monkeypatch):
    """split_train_set.sh, split_val_set.sh and make_dna_dataset.sh on a copy
    of data/csvs: every file byte-equal to the JAX scripts' (their bodies run
    in this process, one call a task in the scripts' order)."""
    src = tree(os.path.join(REPO, "data", "csvs"))
    for side in ("port", "jax"):
        for rel, data in src.items():
            p = tmp_path / side / "data" / "csvs" / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
    env = script_env(interpreter_dir(tmp_path, stub=False))
    order = ("dataset/split_train_set.sh", "dataset/split_val_set.sh",
             "dataset/make_dna_dataset.sh")
    for rel in order:
        run_script(os.path.join(PORT, rel), [], tmp_path / "port", env)

    monkeypatch.chdir(tmp_path / "jax")
    for rel in order:
        body, argvs = jax_script_processes(rel)
        code = compile(body, rel, "exec")
        for argv in argvs:
            monkeypatch.setattr(sys, "argv", argv)
            exec(code, {"__name__": "__main__"})

    port, jax = tree(tmp_path / "port"), tree(tmp_path / "jax")
    tasks = [os.path.splitext(r)[0] for r in src]
    splits = {os.path.join("data", "csvs", t, f"{s}.csv")
              for t in tasks for s in ("train", "val", "test")}
    assert set(port) == set(jax) == splits | {os.path.join("data", "csvs", r) for r in src}
    for rel in sorted(port):
        assert port[rel] == jax[rel], rel
        assert port[rel].count(b"\n") > 1, f"{rel} has no rows"


# ---------------------------------------------------------- the run chain

def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_train_and_eval_then_only_eval(tmp_path):
    """train_and_eval.sh trains one epoch, validates, keeps the best .p and
    tests it; only_eval.sh on that .p gives the same per-task and final test
    metrics (within 1e-6 relative)."""
    env = script_env(interpreter_dir(tmp_path, stub=False))
    common = ["--device", "cpu", "--synthetic", "--mult_chan", "2", "--adopted_datasets", "dna"]
    run_script(os.path.join(PORT, "run/train_and_eval.sh"),
               ["RepMode", "exps/test", *common, "--num_epochs", "1", "--interval_val", "1"],
               tmp_path, env)
    ckpt = tmp_path / "exps" / "test" / "checkpoints" / "model_best_test.p"
    assert ckpt.is_file()
    run_script(os.path.join(PORT, "run/only_eval.sh"),
               ["RepMode", "exps/eval", "exps/test/checkpoints/model_best_test.p", *common],
               tmp_path, env)
    for kind in ("spec", "final"):
        trained = read_rows(tmp_path / "exps" / "test" / "metrics" / f"{kind}_test.csv")
        evaluated = read_rows(tmp_path / "exps" / "eval" / "metrics" / f"{kind}_eval.csv")
        assert trained and len(trained) == len(evaluated)
        for a, b in zip(trained, evaluated):
            assert a.keys() == b.keys()
            for k in a:
                if k == "dataset":
                    assert a[k] == b[k]
                else:
                    assert float(b[k]) == pytest.approx(float(a[k]), rel=1e-6, abs=0), (kind, k)


# ---------------------------------------------------------- the card mode

def test_tests_script_cuda_mode_needs_no_jax(tmp_path):
    """tests.sh cuda collects tests/test_torch_port_cuda.py and skips every
    test here (no card), with a jax package that raises on import first on
    PYTHONPATH: the card mode imports no JAX."""
    fake = tmp_path / "fake" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("raise ImportError('the card mode imports no jax')\n")
    env = script_env(interpreter_dir(tmp_path, stub=False), PYTHONPATH=str(fake.parent))
    res = run_script(os.path.join(PORT, "run/tests.sh"), ["cuda", "-p", "no:cacheprovider"],
                     tmp_path, env)
    summary = res.stdout.strip().splitlines()[-1]
    assert re.fullmatch(r"\d+ skipped in [\d.]+s( \(.*\))?", summary), res.stdout[-2000:]
    assert int(summary.split()[0]) > 0


# ---------------------------------------------------------- common rules

@pytest.mark.parametrize("rel", SCRIPTS)
def test_script_common_rules(rel):
    """Each script: executable, bash with set -euo pipefail, the repo root
    from its own path first on PYTHONPATH, python3, a header naming the JAX
    script it mirrors, and nothing of the JAX package."""
    path = os.path.join(PORT, rel)
    assert os.access(path, os.X_OK)
    with open(path) as f:
        text = f.read()
    lines = text.splitlines()
    assert lines[0] == "#!/usr/bin/env bash"
    assert "set -euo pipefail" in lines
    assert 'ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"' in lines
    assert 'export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"' in lines
    header = "\n".join(line for line in lines if line.startswith("#"))
    assert f"scripts/{rel}" in header and os.path.exists(os.path.join(JAX, rel))
    calls = re.findall(r"\bpython3?\b", "\n".join(line for line in lines
                                                  if not line.startswith("#")))
    assert calls and set(calls) == {"python3"}
    assert not re.search(r"repmode_tpu(?!_torch)", text)
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)


def test_scripts_torch_holds_the_scripts_and_no_jax_package():
    """Every file under scripts_torch/ is one of the scripts above, and none
    names the JAX package."""
    found = []
    for d, _, files in os.walk(PORT):
        for f in files:
            path = os.path.join(d, f)
            found.append(os.path.relpath(path, PORT))
            with open(path) as fh:
                assert not re.search(r"repmode_tpu(?!_torch)", fh.read()), path
    assert sorted(found) == sorted(SCRIPTS)


def test_chip_smoke_czi_with_one_lzw_channel_reads_back(tmp_path):
    """The scripts phase's CZI with its signal subblock LZW-compressed and
    the others raw reads back as written through the port's reader."""
    import chip_smoke
    from repmode_tpu_torch.data.czi import CziFile

    data = np.random.default_rng(0).integers(0, 4000, (3, 4, 24, 20), dtype=np.uint16)
    path = str(tmp_path / "mixed.czi")
    chip_smoke.write_czi(path, data, compression=(2, 0, 0))
    with CziFile(path) as czi:
        assert [e.compression for e in czi.entries] == [2, 0, 0]
        assert np.array_equal(czi.asarray()[..., 0], data)
