"""The control, kept as a test at a size the CPU holds: the reference in
float8 put in the program's place reads far above the bfloat16 program on
the number each cell relies on, and the committed limits fail it (on the card, at the cells' size, the
readings and limits are in ``PERF.md``). And a run of each cell on the card
through the benchmark's own command, skipped without one."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, spec

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"config": {"mult_chan": 4, "depth": 2, "train_records": 8, "distinct_volumes": 4},
         "traffic": {"volume_shape": [16, 40, 48], "patch_size": [16, 32, 32], "batch_size": 2,
                     "batch_size_eval": 2}}
RELIED_ON = {"repmode.train": "out1_vs_bf16", "repmode.serve": "max_err"}


@pytest.mark.parametrize("name", sorted(RELIED_ON))
def test_control_reads_above_the_program(name):
    torch.set_num_threads(2)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = calibrate.main(["--workload", name, "--seeds", "2147483650", "--control-seeds",
                             "2147483650", "--seconds", "0.2"], device=torch.device("cpu"),
                            small=SMALL)
    assert rc == 0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    number = RELIED_ON[name]
    assert summary["control_min"][number] > 3 * summary["sound_max"][number], summary
    # the committed limits pass the program and fail the control
    assert summary["sound_not_correct"] == [] and summary["control_correct"] == [], summary


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RELIED_ON))
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = spec.benchmark()
    out = subprocess.run([*bench["command"], "--workload", name, "--seed", "2147483777",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end(bench, name)}
