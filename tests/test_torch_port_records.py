"""The port's run records and its real-data entry points, against the JAX
package, on the CPU:

  * utils.tiff, utils.tracking.Tracker, utils.csv_logger.CsvLogger: the
    files each writes are byte-equal to the JAX package's (metrics.jsonl up
    to its timestamps);
  * metrics.metric_stats_device and train.step.make_eval_loss_step against
    the JAX functions, the net's weights carried by
    compat.weights.from_jax_variables (tolerances stated at each test);
  * ``cli.train --device cpu --mult_chan 2`` from CSVs and CZI files with no
    manifest present: the manifests it saves load in the JAX package, its
    test TIFFs carry the names the JAX package's ``_save_volume`` writes for
    the same records, its run record holds the JAX package's keys, and
    ``cli.evaluate`` on the saved dataset and the best checkpoint gives the
    same test MSE.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from repmode_tpu.config import Config as JaxConfig
from repmode_tpu.config import DataConfig as JaxDataConfig
from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.config import TrainConfig as JaxTrainConfig
from repmode_tpu.data.store import VolumeStore as JaxVolumeStore
from repmode_tpu.metrics.metrics import metric_stats_device as jax_metric_stats_device
from repmode_tpu.train.loop import _save_volume as jax_save_volume
from repmode_tpu.train.state import create_train_state as jax_create_train_state
from repmode_tpu.train.step import make_eval_loss_step as jax_make_eval_loss_step
from repmode_tpu.utils import tiff as jax_tiff
from repmode_tpu.utils.csv_logger import CsvLogger as JaxCsvLogger
from repmode_tpu.utils.tracking import Tracker as JaxTracker
import repmode_tpu_torch
from repmode_tpu_torch.cli import evaluate
from repmode_tpu_torch.cli import train as train_cli
from repmode_tpu_torch.compat.weights import from_jax_variables
from repmode_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.metrics.metrics import metric_stats_device
from repmode_tpu_torch.models.repmode import RepModeNet
from repmode_tpu_torch.train.state import TrainState, make_optimizer
from repmode_tpu_torch.train.step import make_eval_loss_step
from repmode_tpu_torch.utils import tiff
from repmode_tpu_torch.utils.csv_logger import CsvLogger
from repmode_tpu_torch.utils.tracking import Tracker
from repmode_tpu_torch.version import __version__
from tests.test_czi import write_czi

torch.set_num_threads(2)

TASKS = ("dna", "lamin_b1")


# ------------------------------------------------------------------ tiff


@pytest.mark.parametrize("shape", [(5, 7, 9), (6, 4), (1, 3, 2)])
def test_tiff_bytes_match_jax(tmp_path, shape):
    vol = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    tiff.imwrite(str(tmp_path / "p.tiff"), vol)
    jax_tiff.imwrite(str(tmp_path / "j.tiff"), vol)
    assert (tmp_path / "p.tiff").read_bytes() == (tmp_path / "j.tiff").read_bytes()
    back = tiff.imread(str(tmp_path / "j.tiff"))
    np.testing.assert_array_equal(back, vol.reshape((-1,) + shape[-2:]))
    np.testing.assert_array_equal(back, jax_tiff.imread(str(tmp_path / "p.tiff")))


# ------------------------------------------------------------------ tracker


def _track(cls, log_dir, code_files, entry_point="train"):
    tr = cls(str(log_dir), config={"lr": 1e-4, "tasks": list(TASKS), "nested": {"b": 1, "a": 2}},
             offline=True, entry_point=entry_point, code_files=code_files)
    tr.log({"X-axis/epoch": 1, "loss/epoch": 0.5, "note": "x", "skip_array": [1, 2],
            "np_scalar": np.float64(0.25)})
    tr.log({"metric_val/MSE": 0.75})
    tr.set_summary("metric_val/MSE_best", 0.75)
    tr.finish()
    return tr


@pytest.mark.parametrize("entry_point", ["train", "evaluate"])
def test_tracker_files_match_jax(tmp_path, entry_point):
    code = train_cli.snapshot_sources(Config()) + [str(tmp_path / "missing.py")]
    ours = _track(Tracker, tmp_path / "p", code, entry_point)
    ref = _track(JaxTracker, tmp_path / "j", code, entry_point)
    assert ours.summary == ref.summary
    name = "config.json" if entry_point == "train" else f"config_{entry_point}.json"
    assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    a = [json.loads(x) for x in (tmp_path / "p" / "metrics.jsonl").read_text().splitlines()]
    b = [json.loads(x) for x in (tmp_path / "j" / "metrics.jsonl").read_text().splitlines()]
    assert [{k: v for k, v in r.items() if k != "_ts"} for r in a] == \
           [{k: v for k, v in r.items() if k != "_ts"} for r in b]
    assert "skip_array" not in a[0] and a[0]["np_scalar"] == 0.25
    assert sorted(os.listdir(tmp_path / "p" / "code")) == sorted(os.listdir(tmp_path / "j" / "code"))


def test_snapshot_sources_name_the_ports_files():
    pkg = os.path.dirname(repmode_tpu_torch.__file__)
    files = train_cli.snapshot_sources(Config())
    assert [os.path.relpath(f, pkg) for f in files] == [
        os.path.join("data", "sampler.py"), os.path.join("train", "step.py"),
        os.path.join("models", "repmode.py"), "config.py"]
    assert all(os.path.isfile(f) for f in files)
    assert repmode_tpu_torch.__version__ == __version__ == "0.1.0"


# ------------------------------------------------------------------ csv logger


@pytest.mark.parametrize("entries", [
    [{"a": 1, "b": 0.5, "c": "x"}, {"a": 2, "b": float("nan"), "c": "y, z"}],
    [{"a": 1, "b": 2, "c": None}, {"a": 1.5, "b": 3, "c": None}],
    [{"e": np.float32(0.1), "f": True, "g": np.int64(3)}, {"e": np.float32(1e-7), "f": False,
                                                         "g": 4}],
    [{"x": "1", "y": None}, {"x": 2, "y": 1}],
    [{"x": 1e16, "y": 1e-5, "z": 123456789.25, "w": float("inf")}],
], ids=["mixed", "int_float_none", "numpy_bool", "str_int", "float_formats"])
def test_csv_logger_files_match_jax(tmp_path, entries):
    ours, ref = CsvLogger(), JaxCsvLogger()
    for e in entries:
        ours.add(e)
        ref.add(e)
    assert len(ours) == len(ref)
    ours.to_csv(str(tmp_path / "p.csv"))
    ref.to_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    CsvLogger(str(tmp_path / "j.csv")).to_csv(str(tmp_path / "p2.csv"))
    JaxCsvLogger(str(tmp_path / "j.csv")).to_csv(str(tmp_path / "j2.csv"))
    assert (tmp_path / "p2.csv").read_bytes() == (tmp_path / "j2.csv").read_bytes()


def test_csv_logger_refuses_ragged_columns_as_jax(tmp_path):
    for cls in (CsvLogger, JaxCsvLogger):
        lg = cls(columns=["a"])
        lg.add({"b": 1})
        with pytest.raises(ValueError, match="same length"):
            lg.to_csv(str(tmp_path / "x.csv"))


# ------------------------------------------------------------------ device metrics, eval loss


@pytest.mark.parametrize("case", ["random", "constant_target", "scaled"])
def test_metric_stats_device_matches_jax(case):
    """fp32 on both sides; rtol 1e-5 (reduction order differs)."""
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((2, 6, 8, 9)).astype(np.float32)
    target = {"random": rng.standard_normal(pred.shape),
              "constant_target": np.full(pred.shape, 0.5),  # its fp32 mean is exact
              "scaled": 3.0 * pred + 0.1}[case].astype(np.float32)
    ours = metric_stats_device(torch.from_numpy(pred), torch.from_numpy(target))
    ref = jax_metric_stats_device(jnp.asarray(pred), jnp.asarray(target))
    assert set(ours) == set(ref) == {"MSE", "MAE", "R2"}
    for k in ours:
        assert ours[k].dim() == 0 and ours[k].dtype == torch.float32
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if case == "constant_target":
        assert float(ours["R2"]) == 0.0


def test_eval_loss_step_matches_jax():
    """The eval-mode forward's MSE with non-trivial BN running stats, weights
    carried from the JAX state; fp32 on both sides, rtol 1e-4."""
    jcfg = JaxConfig(model=JaxModelConfig(mult_chan=2, depth=2, train_s2d=False),
                     data=JaxDataConfig(adopted_datasets=("a", "b", "c")),
                     train=JaxTrainConfig(compute_dtype="float32", patch_size=(16, 16, 16)))
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.1 * np.abs(rng.standard_normal(a.shape))
                         .astype(np.float32), jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats)
    sig = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    batch = {"signal": sig, "target": (0.5 * sig + 0.1).astype(np.float32),
             "task": np.array([2, 0], np.int32)}
    ref = float(jax_make_eval_loss_step(jcfg)(jstate, {k: jnp.asarray(v)
                                                      for k, v in batch.items()}))

    cfg = Config(model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
                 data=DataConfig(adopted_datasets=("a", "b", "c")),
                 train=TrainConfig(compute_dtype="float32"))
    net = RepModeNet(cfg.model, cfg.num_tasks, device="cpu")
    net.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jstate.variables)),
                        strict=True)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    loss = make_eval_loss_step(cfg)(TrainState(net=net, optimizer=make_optimizer(cfg, net)),
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss), ref, rtol=1e-4)
    for k, v in net.state_dict().items():  # no update, running stats untouched
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------------ cli.train from CZIs


@pytest.fixture(scope="module")
def czi_dataset(tmp_path_factory):
    """Two tasks, CSVs in the reference schema (pandas-written), three
    uncompressed 2-channel CZIs of 32x344x344 (32x128x128 after the XY
    resize), one unlabeled test row."""
    root = tmp_path_factory.mktemp("czi_ds")
    os.makedirs(root / "czi")
    rng = np.random.default_rng(11)
    zz, yy, xx = np.meshgrid(np.arange(32), np.arange(344), np.arange(344), indexing="ij")
    for k in range(3):
        blob = np.sin(xx / (9.0 + k)) * np.cos(yy / (7.0 + 2 * k)) + 0.1 * zz / 32
        sig = 1000 + 300 * blob + rng.normal(0, 30, blob.shape)
        tgt = 500 + 200 * np.maximum(blob, 0) ** 2 + rng.normal(0, 20, blob.shape)
        write_czi(str(root / "czi" / f"cell_{k}.czi"),
                  np.stack([sig, tgt]).clip(0, 65535).astype(np.uint16))
    layout = {
        "train": {"dna": [(0, 1)], "lamin_b1": [(1, 1)]},
        "val": {"dna": [(2, 1)], "lamin_b1": [(0, 1)]},
        "test": {"dna": [(1, 1), (2, None)], "lamin_b1": [(2, 1)]},
    }
    for split, tasks in layout.items():
        for ds, rows in tasks.items():
            os.makedirs(root / "csvs" / ds, exist_ok=True)
            pd.DataFrame([{"path_czi": f"data/cell_{k}.czi", "channel_signal": 0,
                           "channel_target": np.nan if t is None else t,
                           "structureProteinName": ds, "colony_position": ""}
                          for k, t in rows]).to_csv(root / "csvs" / ds / f"{split}.csv",
                                                    index=False)
    return root


@pytest.fixture(scope="module")
def czi_run(czi_dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("czi_run")
    argv = ["--device", "cpu", "--mult_chan", "2", "--adopted_datasets", *TASKS,
            "--path_dataset_csv", str(czi_dataset / "csvs"),
            "--path_dataset_czi", str(czi_dataset / "czi"),
            "--path_save_dataset", str(out / "saved"), "--num_epochs", "1", "--interval_val", "1",
            "--save_test_preds", "--save_test_signals_and_targets", "--debugging",
            "--on_device_pipeline", "off", "--path_exp_dir", str(out / "exp")]
    return out, train_cli.main(argv)


def test_cli_train_from_czis_saves_manifests_jax_loads(czi_run):
    out, res = czi_run
    for split, n in (("train", 2), ("val", 2), ("test", 3)):
        store = JaxVolumeStore.load(str(out / "saved"), split)
        assert len(store) == n and store.adopted_datasets == TASKS
        for rec in store.records:
            assert rec.signal.shape == (32, 128, 128) and rec.signal.dtype == np.float32
            assert rec.info["path_czi"].startswith("data/cell_")
    unlabeled = JaxVolumeStore.load(str(out / "saved"), "test").records[1]
    assert unlabeled.target is None and math.isnan(unlabeled.info["channel_target"])
    assert res["state"].step == 1 and math.isfinite(res["train_log"]["loss/epoch"])
    # the unlabeled volume is predicted but not scored
    assert math.isfinite(res["test_log"]["metric_test/MSE"])


def test_cli_train_tiffs_carry_jax_names(czi_run, tmp_path):
    """The port's test TIFFs are the ones JAX's _save_volume writes for the
    same records (its name quirks kept): names equal, signal and target files
    byte-equal, the prediction finite; no target file for the unlabeled row."""
    out, _ = czi_run
    ours = out / "exp" / "preds"
    store = JaxVolumeStore.load(str(out / "saved"), "test")
    for i, rec in enumerate(store.records):
        jax_save_volume(str(tmp_path), i, "pred", rec, np.zeros((1, 1, 1), np.float32))
        jax_save_volume(str(tmp_path), i, "signal", rec, rec.signal)
        if rec.target is not None:
            jax_save_volume(str(tmp_path), i, "target", rec, rec.target)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(tmp_path))
    assert "001_pred_dna_cell_2.tiff" in names and "001_target_dna_cell_2.tiff" not in names
    for name in names:
        if "_pred_" in name:
            pred = tiff.imread(str(ours / name))
            assert pred.shape == (32, 128, 128) and np.isfinite(pred).all()
        else:
            assert (ours / name).read_bytes() == (tmp_path / name).read_bytes(), name


def test_cli_train_run_record(czi_run):
    """metrics.jsonl holds the epoch line then the val line with the JAX
    package's keys; config.json and the code snapshot are written."""
    out, res = czi_run
    logs = out / "exp" / "logs"
    lines = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    assert {"X-axis/epoch", "loss/epoch", "loss_epoch/dna", "loss_epoch/lamin_b1",
            "time/train"} <= set(lines[0])
    assert {"X-axis/epoch", "metric_val/MSE", "metric_val/R2", "metric_val_MSE/dna",
            "time/val"} <= set(lines[1])
    assert lines[0]["X-axis/epoch"] == lines[1]["X-axis/epoch"] == 1
    cfg = json.loads((logs / "config.json").read_text())
    assert cfg["data"]["path_save_dataset"] == str(out / "saved")
    assert sorted(os.listdir(logs / "code")) == ["config.py", "repmode.py", "sampler.py",
                                                 "step.py"]


def test_cli_evaluate_on_saved_dataset_matches_train_test_pass(czi_run):
    out, res = czi_run
    log = evaluate.main(["--device", "cpu", "--mult_chan", "2", "--debugging",
                         "--torch_checkpoint", res["best_path"],
                         "--path_load_dataset", str(out / "saved"),
                         "--save_test_preds", "--path_exp_dir", str(out / "eval")])
    assert log["metric_test/MSE"] == res["test_log"]["metric_test/MSE"]
    for name in os.listdir(out / "eval" / "preds"):
        np.testing.assert_array_equal(tiff.imread(str(out / "eval" / "preds" / name)),
                                      tiff.imread(str(out / "exp" / "preds" / name)))
    assert (out / "eval" / "logs" / "config_evaluate.json").exists()
