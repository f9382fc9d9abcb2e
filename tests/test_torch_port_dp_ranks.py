"""The port's data parallelism on the CPU, torch only: the functions the
ranks of ``tests/test_torch_port_dp.py`` run (a spawned rank imports this
module, which imports no JAX), and the checks that need no JAX package:

  * a global batch that does not split over the ranks raises;
  * ``cli.train`` then ``cli.evaluate`` with ``--num_devices 2`` (gloo ranks
    on the CPU) against one rank's run;
  * ``make_mesh``'s fewer-cards guard and its refusal outside a launched
    group; ``launch``'s results, thread share and failure report.

mult_chan 2, depth 2, 8x16x16 patches, a global batch of 8, fp32.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from repmode_tpu_torch.cli import evaluate
from repmode_tpu_torch.cli import train as train_cli
from repmode_tpu_torch.compat.weights import load_reference_checkpoint
from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.data.device_sampler import DeviceVolumeBank, make_device_sampler
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models import build_model
from repmode_tpu_torch.models.reparam import make_inference
from repmode_tpu_torch.ops.norm import batch_norm_train
from repmode_tpu_torch.parallel import Mesh, launch, make_mesh, replicate, shard_batch
from repmode_tpu_torch.parallel import sync_batch_norm
from repmode_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

TASKS = ("task_a", "task_b")
PATCH = (8, 16, 16)
BATCH = 8
STEPS = 2
VOL = (16, 24, 40)  # 3 x 2 x 4 = 24 patches of PATCH at overlap 0.5
EVAL_BATCH = 5      # 5 batches, padded to 6 over two ranks


def port_config(name="RepMode", remat=False):
    return Config(model=ModelConfig(name=name, mult_chan=2, depth=2, train_s2d=False,
                                    remat=remat),
                  data=DataConfig(adopted_datasets=TASKS),
                  train=TrainConfig(batch_size=BATCH, patch_size=PATCH, compute_dtype="float32",
                                    batch_size_eval=EVAL_BATCH),
                  eval=EvalConfig(patch_size=PATCH, s2d=False))


def make_batch():
    rng = np.random.default_rng(42)
    sig = rng.standard_normal((BATCH, *PATCH, 1)).astype(np.float32)
    return {"signal": sig, "target": (0.5 * sig + 0.1 * rng.standard_normal(sig.shape))
            .astype(np.float32), "task": (np.arange(BATCH) % len(TASKS)).astype(np.int32)}


def numpy_state(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def train_steps(cfg, sd, batch, mesh=None, seed=None):
    """STEPS steps from a state_dict (or, for the UNet, from a seeded init);
    (per-step metrics, the final state_dict) as numpy."""
    if sd is None:
        state = create_train_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    else:
        net = build_model(cfg, device="cpu")
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        state = TrainState(net=net.train(), optimizer=make_optimizer(cfg, net))
    if mesh is not None:
        sync_batch_norm(replicate(mesh, state.net), mesh)
        batch = shard_batch(mesh, batch)
    else:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    step = make_train_step(cfg, state, mesh)
    metrics = [{k: v.numpy().copy() for k, v in step(batch).items()} for _ in range(STEPS)]
    return metrics, numpy_state(state.net)


def bn_case(x, cot, phases, group=None, rows=slice(None)):
    """batch_norm_train on x[rows] (with a group: this rank's slice) and the
    backward of sum(y * cot[rows]): y, the running stats, the gradients of
    x, scale and bias."""
    c = x.shape[-1] // phases
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    scale = torch.linspace(0.5, 1.5, c).requires_grad_(True)
    bias = torch.linspace(-0.2, 0.2, c).requires_grad_(True)
    rm, rv = torch.zeros(c), torch.ones(c)
    y = batch_norm_train(xt, rm, rv, scale, bias, phases=phases, group=group)
    (y * torch.from_numpy(cot[rows])).sum().backward()
    return {"y": y.detach().numpy(), "rm": rm.numpy(), "rv": rv.numpy(),
            "dx": xt.grad.numpy(), "dscale": scale.grad.numpy(), "dbias": bias.grad.numpy()}


def counting_forward(cfg, seen):
    forward = make_inference(cfg)[1]

    def fwd(plain, x):
        seen.append(int(x.shape[0]))
        return forward(plain, x)
    return fwd


def rank_checks(payload):
    """Every check that needs the group, on one rank."""
    mesh = make_mesh(2, "cpu")
    rows = slice(mesh.rank * BATCH // 2, (mesh.rank + 1) * BATCH // 2)
    out = {"rank": mesh.rank, "bn": {}}
    for phases, (x, cot) in payload["bn"].items():
        out["bn"][phases] = bn_case(x, cot, phases, mesh.group, rows)
    out["train"] = train_steps(port_config(), payload["sd"], payload["batch"], mesh)
    out["remat"] = train_steps(port_config(remat=True), payload["sd"], payload["batch"], mesh)
    out["unet"] = train_steps(port_config("UNet"), None, payload["batch"], mesh, seed=3)
    cfg = port_config()
    seen = []
    pred = TiledPredictor(cfg, mode="two_phase", mesh=mesh,
                          forward_fn=counting_forward(cfg, seen))
    plain = make_inference(cfg)[0](
        {k: torch.from_numpy(v) for k, v in payload["serve_sd"].items()}, 1)
    out["volume"] = pred(plain, payload["vol"]).numpy()
    out["batches_predicted"] = seen
    return out


# ----------------------------------------------------- without the JAX package


def test_batches_that_do_not_split_raise():
    """A global batch must split evenly over the ranks: the host batch and
    the bank sampler refuse an uneven one."""
    mesh = Mesh(0, 2, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="batch of 3 does not split over 2"):
        shard_batch(mesh, {"task": np.zeros(3, np.int32)})
    bank = DeviceVolumeBank.from_store(synthetic_store(TASKS, 1, vol_shape=(8, 16, 16)), "cpu")
    with pytest.raises(ValueError, match="batch of 3 does not split over 2"):
        make_device_sampler(bank, 3, PATCH, mesh=mesh)


def cli_args(exp_dir, *extra):
    return ["--synthetic", "--device", "cpu", "--mult_chan", "2", "--adopted_datasets", "dna",
            "--batch_size", "2", "--batch_size_eval", "2", "--num_epochs", "1",
            "--interval_val", "1", "--path_exp_dir", str(exp_dir), *extra]


def test_cli_train_then_evaluate_on_two_ranks(tmp_path):
    """cli.train --num_devices 2: rank 0 writes the one checkpoint and run
    record; loss and test MSE within 1e-5 of one rank's run; the .p loads
    strictly; cli.evaluate --num_devices 2 on it gives the same test MSE."""
    two = train_cli.main(cli_args(tmp_path / "two", "--num_devices", "2"))
    one = train_cli.main(cli_args(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "two" / "checkpoints")) == ["model_best_two.p"]
    assert two["best_path"] == str(tmp_path / "two" / "checkpoints" / "model_best_two.p")
    records = glob.glob(str(tmp_path / "two" / "**" / "metrics.jsonl"), recursive=True)
    assert len(records) == 1
    lines = [json.loads(x) for x in open(records[0])]
    assert sum("loss/epoch" in x for x in lines) == 1
    np.testing.assert_allclose(two["train_log"]["loss/epoch"], one["train_log"]["loss/epoch"],
                               rtol=1e-5)
    np.testing.assert_allclose(two["test_log"]["metric_test/MSE"],
                               one["test_log"]["metric_test/MSE"], rtol=1e-5)
    net = build_model(Config(model=ModelConfig(mult_chan=2, train_s2d=False),
                             data=DataConfig(adopted_datasets=("dna",))), device="cpu")
    net.load_state_dict(load_reference_checkpoint(two["best_path"])["state_dict"], strict=True)

    ev = evaluate.main(cli_args(tmp_path / "ev", "--num_devices", "2", "--torch_checkpoint",
                                two["best_path"]))
    np.testing.assert_allclose(ev["metric_test/MSE"], two["test_log"]["metric_test/MSE"],
                               rtol=1e-5)
    assert os.path.exists(tmp_path / "ev" / "metrics" / "final_ev.csv")


def test_make_mesh_refuses_more_cards_than_the_machine_has(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 3 devices, have 1"):
        make_mesh(3, "cuda")
    with pytest.raises(RuntimeError, match="parallel.launch"):
        make_mesh(2, "cpu")


def test_cpu_ranks_share_the_callers_threads(tmp_path):
    """launch returns the ranks' results in order, each rank on its own
    device with half the caller's threads; a failing rank raises with its
    traceback."""
    outs = launch(_rank_info, 2, "cpu", "gloo", init_method=f"file://{tmp_path / 'a'}",
                  timeout_s=120)
    share = max(1, torch.get_num_threads() // 2)
    assert outs == [(0, 2, "cpu", share), (1, 2, "cpu", share)]
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        launch(_rank_fails, 2, "cpu", "gloo", init_method=f"file://{tmp_path / 'b'}",
               timeout_s=120)


def _rank_info():
    mesh = make_mesh(2, "cpu")
    return mesh.rank, mesh.size, mesh.device.type, torch.get_num_threads()


def _rank_fails():
    mesh = make_mesh(2, "cpu")
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank

