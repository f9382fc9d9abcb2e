"""The port's serving path on the CPU: the tiled predictor against the JAX
package's, and the eval CLI end to end."""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repmode_tpu.config import Config as JaxConfig
from repmode_tpu.config import DataConfig as JaxDataConfig
from repmode_tpu.config import EvalConfig as JaxEvalConfig
from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.config import TrainConfig as JaxTrainConfig
from repmode_tpu.data.synthetic import synthetic_store as jax_synthetic_store
from repmode_tpu.infer.predict import TiledPredictor as JaxTiledPredictor
from repmode_tpu.models.repmode import RepModeNet as JaxRepModeNet
from repmode_tpu.models.reparam import reparameterize as jax_reparameterize
from repmode_tpu_torch.cli import evaluate
from repmode_tpu_torch.compat.weights import from_jax_variables
from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models.reparam import make_inference, plain_forward_s2d, reparameterize
from repmode_tpu_torch.models.repmode import RepModeNet

torch.set_num_threads(2)

TASKS = ("task_a", "task_b")


@pytest.fixture(scope="module")
def jax_variables():
    cfg = JaxModelConfig(mult_chan=2, depth=2, train_s2d=False)
    net = JaxRepModeNet(cfg, len(TASKS))
    variables = jax.jit(functools.partial(net.init, train=False))(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, 4, 4, 1)), jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(2)
    variables = jax.tree.map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(*((-0.02, 0.02) if "mean" in jax.tree_util.keystr(p)
                                   else (0.02, 0.1)), a.shape).astype(np.float32),
        variables["batch_stats"],
    )
    return cfg, variables


@pytest.mark.parametrize("batch", [2, 3])
def test_tiled_predictor_matches_jax(jax_variables, batch):
    """16x24x24 volume, 16^3 patches (4 of them): batch 3 leaves a ragged
    tail of two zero-weight patches. fp32 compute, within 1e-4."""
    jcfg_model, variables = jax_variables
    kw = dict(patch_size=(16, 16, 16))
    jcfg = JaxConfig(model=jcfg_model, data=JaxDataConfig(adopted_datasets=TASKS),
                     train=JaxTrainConfig(batch_size_eval=batch, compute_dtype="float32"),
                     eval=JaxEvalConfig(s2d=False, **kw))
    cfg = Config(model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
                 data=DataConfig(adopted_datasets=TASKS),
                 train=TrainConfig(batch_size_eval=batch, compute_dtype="float32"),
                 eval=EvalConfig(s2d=False, **kw))
    vol = np.random.default_rng(7).standard_normal((16, 24, 24)).astype(np.float32)

    ref = np.asarray(JaxTiledPredictor(jcfg)(
        jax_reparameterize(variables, jcfg_model, len(TASKS), 1), jnp.asarray(vol)))
    pred = TiledPredictor(cfg, device="cpu")
    starts, valid, p = pred.grid(vol.shape)
    assert p == 4 and starts.shape == (-(-4 // batch), batch, 3)
    assert valid.sum() == 4
    out = pred(reparameterize(from_jax_variables(variables), cfg.model, len(TASKS), 1), vol)
    assert out.dtype == torch.float32 and out.shape == vol.shape
    assert np.std(ref) > 1e-3
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_predictor_without_cuda_or_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TiledPredictor(Config(eval=EvalConfig(s2d=False)))


def test_make_inference_refuses_s2d():
    """make_inference no longer refuses s2d: the default Config (eval.s2d=True,
    the JAX package's default) takes the space-to-depth route, and prepare
    emits s2d-shaped params."""
    cfg = Config(model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
                 data=DataConfig(adopted_datasets=TASKS))
    assert cfg.eval.s2d
    prepare, forward = make_inference(cfg)
    assert forward.func is plain_forward_s2d and forward.keywords["s2d_levels"] == (1, 2)
    net = RepModeNet(cfg.model, len(TASKS), generator=torch.Generator().manual_seed(0),
                     device="cpu")
    plain = prepare(net.state_dict(), 0)
    assert plain["encoder_block1"]["conv1_w"].shape == (5, 3, 3, 4, 8)
    assert plain["conv_out_w"].shape == (5, 3, 3, 8, 4)


# ------------------------------------------------------- config and data


def test_config_json_round_trips_with_jax():
    """A config written by either package reads back equal in the other."""
    ours = Config(model=ModelConfig(mult_chan=8, depth=3),
                  train=TrainConfig(batch_size_eval=3, epoch_checkpoint=(5, 9)),
                  eval=EvalConfig(s2d=False, patch_size=(16, 32, 32)),
                  data=DataConfig(adopted_datasets=TASKS), exp_name="e", tags=("a",))
    theirs = JaxConfig.from_json(ours.to_json())
    assert theirs.to_json() == ours.to_json()
    assert Config.from_json(theirs.to_json()) == ours


def test_synthetic_store_equals_jax():
    ours = synthetic_store(TASKS, volumes_per_task=2, vol_shape=(8, 12, 10), seed=4)
    ref = jax_synthetic_store(TASKS, volumes_per_task=2, vol_shape=(8, 12, 10), seed=4)
    assert len(ours) == len(ref) == 4 and ours.adopted_datasets == ref.adopted_datasets
    for a, b in zip(ours.records, ref.records):
        assert (a.dataset, a.task, a.info) == (b.dataset, b.task, b.info)
        np.testing.assert_array_equal(a.signal, b.signal)
        np.testing.assert_array_equal(a.target, b.target)


def test_volume_store_loads_a_jax_manifest(tmp_path):
    """The port reads the manifest + npz shards the JAX package writes, with
    the reference's task ids and load-time task filtering."""
    ref = jax_synthetic_store(("c_task",) + TASKS, volumes_per_task=1, vol_shape=(4, 6, 5))
    ref.save(str(tmp_path), "test")
    full = VolumeStore.load(str(tmp_path), "test")
    assert full.adopted_datasets == ref.adopted_datasets and len(full) == 3
    for a, b in zip(full.records, ref.records):
        assert (a.dataset, a.task, a.info) == (b.dataset, b.task, b.info)
        np.testing.assert_array_equal(a.signal, b.signal)
        np.testing.assert_array_equal(a.target, b.target)
    two = VolumeStore.load(str(tmp_path), "test", TASKS)
    assert [(r.dataset, r.task) for r in two.records] == [("task_a", 0), ("task_b", 1)]


# ----------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference-layout .p of a seeded port net (mult_chan 2, depth 4)."""
    net = RepModeNet(ModelConfig(mult_chan=2, train_s2d=False), len(TASKS),
                     generator=torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "model_best.p")
    torch.save({"nn_module": "RepMode",
                "opts": types.SimpleNamespace(adopted_datasets=list(TASKS)),
                "nn_state": net.state_dict(), "count_iter": 0, "count_epoch": 0}, path)
    return path


def test_evaluate_cli_writes_metric_csvs(checkpoint, tmp_path):
    exp_dir = str(tmp_path / "eval_cpu")
    log = evaluate.main([
        "--torch_checkpoint", checkpoint, "--synthetic", "--device", "cpu",
        "--adopted_datasets", *TASKS, "--mult_chan", "2", "--batch_size_eval", "1",
        "--path_exp_dir", exp_dir,
    ])
    assert np.isfinite(log["metric_test/MSE"])
    for ds in TASKS:
        assert np.isfinite(log[f"metric_test_MSE/{ds}"])
    for prefix in ("comp", "spec", "final"):
        path = os.path.join(exp_dir, "metrics", f"{prefix}_eval_cpu.csv")
        assert os.path.exists(path)
    rows = open(os.path.join(exp_dir, "metrics", "comp_eval_cpu.csv")).read().splitlines()
    assert rows[0] == "dataset,path_czi,img_id,MSE,MAE,R2" and len(rows) == 1 + 2 * len(TASKS)


def test_evaluate_cli_requires_checkpoint(capsys):
    with pytest.raises(SystemExit):
        evaluate.main(["--synthetic", "--device", "cpu"])
    assert "no checkpoint source" in capsys.readouterr().err


def test_evaluate_cli_orbax_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="convert_orbax_checkpoint.py.*--torch_checkpoint"):
        evaluate.main(["--path_load_model", str(tmp_path), "--device", "cpu"])


def test_evaluate_cli_without_cuda_raises(checkpoint, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate.main(["--torch_checkpoint", checkpoint, "--synthetic",
                       "--path_exp_dir", str(tmp_path / "e")])
