"""The port's training path against the reference goldens and the JAX package,
on the CPU.

  * the train-mode net (both MoDE routes) against the reference's goldens
    (tests/goldens/repmode_small.npz): ``y_train``, BN running stats after
    one forward, the loss and every parameter's gradient;
  * one train step against JAX ``make_train_step`` from the same weights:
    loss, per-task sums, gradients, BN running stats; Adam against
    ``flat_adam`` on identical gradients;
  * the patch sampler against JAX's ``PatchSampler(use_native=False)``;
  * ``run_experiment`` end to end (train, val, best ``.p`` checkpoint,
    reload, test CSVs, resume) and the ``cli.train`` flag surface.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from repmode_tpu.config import Config as JaxConfig
from repmode_tpu.config import DataConfig as JaxDataConfig
from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.config import TrainConfig as JaxTrainConfig
from repmode_tpu.data.sampler import PatchSampler as JaxPatchSampler
from repmode_tpu.data.synthetic import synthetic_store as jax_synthetic_store
from repmode_tpu.train.state import create_train_state as jax_create_train_state
from repmode_tpu.train.state import flat_adam
from repmode_tpu.train.step import make_train_step as jax_make_train_step
from repmode_tpu_torch.cli import train as train_cli
from repmode_tpu_torch.compat.weights import from_jax_variables, load_reference_checkpoint
from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.data.sampler import PatchSampler
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.models.repmode import RepModeNet
from repmode_tpu_torch.train.loop import run_experiment
from repmode_tpu_torch.train.state import TrainState, make_optimizer
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "repmode_small.npz")
TASKS = ("task0", "task1", "task2")


def ndhwc(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 3, 4, 1))))


def assert_grads_close(ours, ref):
    """The golden gradient checks of tests/test_torch_parity.py: per tensor
    rel L2 < 0.15 and cosine > 0.995, global rel L2 < 0.05 (fp32 sums through
    19 convs are cancellation-heavy; a wrong or missing term moves specific
    tensors by O(1))."""
    assert ours.keys() == ref.keys() and len(ref) > 20
    all_a, all_b = [], []
    for name in ref:
        a = ours[name].detach().double().numpy().ravel()
        b = np.asarray(ref[name], np.float64).ravel()
        all_a.append(a)
        all_b.append(b)
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-20)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-20)
        assert rel < 0.15, f"{name}: rel L2 {rel:.3e}"
        assert cos > 0.995, f"{name}: cosine {cos:.5f}"
    ga, gb = np.concatenate(all_a), np.concatenate(all_b)
    assert np.linalg.norm(ga - gb) / np.linalg.norm(gb) < 0.05


# ------------------------------------------------------------------ goldens


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    return z, sd


def golden_net(sd, impl):
    net = RepModeNet(ModelConfig(mult_chan=2, depth=4, train_impl=impl, train_s2d=False),
                     len(TASKS), device="cpu")
    net.load_state_dict(sd, strict=True)
    return net.train()


@pytest.mark.parametrize("impl", ["auto", "expert_sum"])
def test_train_forward_and_running_stats_match_goldens(golden, impl):
    """Train-mode forward with mixed tasks from fresh (0, 1) running stats:
    the output and the updated running stats are the reference's."""
    z, sd = golden
    net = golden_net(sd, impl)
    for name, buf in net.named_buffers():
        if name.endswith("running_mean") or name.endswith("num_batches_tracked"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    with torch.no_grad():
        y = net(ndhwc(z["x"]), torch.from_numpy(z["tasks_mixed"]))
    np.testing.assert_allclose(np.transpose(y.numpy(), (0, 4, 1, 2, 3)), z["y_train"],
                               rtol=1e-3, atol=1e-4)
    stats = {k: v for k, v in net.state_dict().items() if "running" in k or "num_batches" in k}
    assert len(stats) > 20
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=2e-3, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("impl", ["auto", "expert_sum"])
def test_train_gradients_match_goldens(golden, impl):
    z, sd = golden
    net = golden_net(sd, impl)
    out = net(ndhwc(z["x"]), torch.from_numpy(z["tasks_mixed"]))
    loss = ((out - ndhwc(z["grad_target"])) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(z["grad_loss"]), rtol=1e-5)
    ref = {k[3:]: z[k] for k in z.files if k.startswith("gr.")}
    assert_grads_close({k: p.grad for k, p in net.named_parameters()}, ref)


# ------------------------------------------------------ one step against JAX


def _capture_grads():
    """An optax transform that applies no update and keeps the gradients as
    its state, so the JAX step hands them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def test_train_step_matches_jax():
    jcfg = JaxConfig(
        model=JaxModelConfig(mult_chan=2, depth=2, train_s2d=False),
        data=JaxDataConfig(adopted_datasets=TASKS),
        train=JaxTrainConfig(compute_dtype="float32", patch_size=(16, 16, 16), batch_size=2),
    )
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(5), tx=_capture_grads())
    rng = np.random.default_rng(6)
    sig = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    batch = {"signal": sig, "target": (0.5 * sig + 0.1).astype(np.float32),
             "task": np.array([2, 0], np.int32)}
    new_state, jm = jax_make_train_step(jcfg, donate=False, tx=_capture_grads())(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = Config(model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
                 data=DataConfig(adopted_datasets=TASKS),
                 train=TrainConfig(compute_dtype="float32"))
    net = RepModeNet(cfg.model, len(TASKS), device="cpu")
    net.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jstate.variables)),
                        strict=True)
    state = TrainState(net=net.train(), optimizer=make_optimizer(cfg, net))
    m = make_train_step(cfg, state)({k: torch.from_numpy(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["per_task_loss_sum"].numpy(), np.asarray(jm["per_task_loss_sum"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(m["per_task_count"].numpy(), np.asarray(jm["per_task_count"]))
    assert state.step == 1
    # JAX gradients are a params-only tree: they map to the parameter names
    ref_grads = from_jax_variables(jax.tree.map(np.asarray, new_state.opt_state))
    assert_grads_close({k: p.grad for k, p in net.named_parameters()}, ref_grads)
    ref_sd = from_jax_variables(jax.tree.map(np.asarray, new_state.variables))
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), rtol=2e-3, atol=1e-4,
                                       err_msg=k)


def test_adam_matches_flat_adam():
    """torch.optim.Adam (the port's optimizer) against the JAX package's
    flat_adam on identical gradients, two steps, elementwise."""
    rng = np.random.default_rng(8)
    shapes = [(3, 4, 5), (7,), (2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0**-k for s, k in
              zip(shapes, (1, 3, 5))] for _ in range(2)]
    tx = flat_adam(1e-4)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = torch.optim.Adam(tp, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(a) for a in g], jstate)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for p, ref in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-7)


# ------------------------------------------------------------------ sampler


def test_sampler_matches_jax_numpy_path():
    """Same seed, same batches as JAX's PatchSampler(use_native=False) over
    two epochs, ragged tail (3 volumes, batch 2) included."""
    tasks = ("a", "b", "c")
    kw = dict(volumes_per_task=1, vol_shape=(12, 20, 24), seed=4)
    ours = PatchSampler(synthetic_store(tasks, **kw), 2, (8, 16, 16), seed=9)
    ref = JaxPatchSampler(jax_synthetic_store(tasks, **kw), 2, (8, 16, 16), seed=9,
                          use_native=False)
    for _ in range(2):
        a, b = list(ours.epoch()), list(ref.epoch())
        assert [len(x["task"]) for x in a] == [2, 1]
        assert len(a) == len(b) == ours.batches_per_epoch()
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


# ------------------------------------------------------- experiment and CLI


def tiny_config(tmp_path, **train):
    return Config(
        model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
        data=DataConfig(adopted_datasets=("dna", "lamin_b1")),
        train=TrainConfig(num_epochs=2, batch_size=2, patch_size=(16, 16, 16), interval_val=1,
                          **train),
        eval=EvalConfig(patch_size=(16, 16, 16), s2d=False),
        path_exp_dir=str(tmp_path / "exp"), exp_name="tiny",
    )


def tiny_stores(tasks):
    return {split: synthetic_store(tasks, 2, vol_shape=(16, 32, 32), seed=i)
            for i, split in enumerate(["train", "val", "test"])}


def test_run_experiment_checkpoints_and_resumes(tmp_path):
    cfg = tiny_config(tmp_path)
    stores = tiny_stores(cfg.data.adopted_datasets)
    res = run_experiment(cfg, stores, device="cpu")
    best = res["best_path"]
    assert best.endswith("model_best_tiny.p") and os.path.exists(best)
    assert np.isfinite(res["train_log"]["loss/epoch"]) and res["train_log"]["X-axis/epoch"] == 2
    assert np.isfinite(res["test_log"]["metric_test/MSE"])
    for prefix in ("comp", "spec", "final"):
        assert os.path.exists(os.path.join(cfg.path_exp_dir, "metrics", f"{prefix}_tiny.csv"))

    loaded = load_reference_checkpoint(best)
    assert loaded["adopted_datasets"] == ["dna", "lamin_b1"]
    assert loaded["optimizer_state"]["state"] and loaded["count_epoch"] in (1, 2)
    fresh = RepModeNet(cfg.model, 2, device="cpu")
    fresh.load_state_dict(loaded["state_dict"], strict=True)

    # resume from the best checkpoint: the epoch count continues from it
    start, steps = loaded["count_epoch"], loaded["count_iter"]
    assert steps == 2 * start  # 4 train volumes in batches of 2
    cfg2 = dataclasses.replace(
        cfg, path_load_model=best, path_exp_dir=str(tmp_path / "resumed"),
        train=dataclasses.replace(cfg.train, num_epochs=start + 1))
    res2 = run_experiment(cfg2, stores, device="cpu")
    assert res2["train_log"]["X-axis/epoch"] == start + 1
    again = load_reference_checkpoint(res2["best_path"])
    assert (again["count_epoch"], again["count_iter"]) == (start + 1, steps + 2)


def test_run_experiment_refuses_unported_options(tmp_path):
    """num_devices 2 outside a launched group (which names parallel.launch)
    and an Orbax directory (which names the converter) raise; the on-device
    pipeline, forced, trains."""
    cfg = tiny_config(tmp_path)
    res = run_experiment(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, on_device_pipeline=True, num_epochs=1)),
        tiny_stores(("dna",)), device="cpu")
    assert res["state"].step == 1 and np.isfinite(res["train_log"]["loss/epoch"])
    with pytest.raises(RuntimeError, match="launch the run through.*parallel.launch"):
        run_experiment(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, num_devices=2)), {}, device="cpu")
    orbax_dir = tmp_path / "orbax_ckpt"
    orbax_dir.mkdir()
    with pytest.raises(NotImplementedError, match="Orbax.*convert_orbax_checkpoint.py"):
        run_experiment(cfg.replace(path_load_model=str(orbax_dir)), tiny_stores(("dna",)),
                       device="cpu")


def test_train_cli_parses_the_ports_flags():
    ns = train_cli.build_parser().parse_args(
        ["--synthetic", "--train_impl", "expert_sum", "--num_epochs", "3", "--interval_val", "3",
         "--adopted_datasets", "zo1", "dna", "--device", "cpu", "--mult_chan", "4"])
    cfg = train_cli.to_config(ns)
    assert cfg.model.train_impl == "expert_sum" and cfg.model.mult_chan == 4
    assert cfg.train.num_epochs == 3 and cfg.train.interval_val == 3
    assert cfg.data.adopted_datasets == ("dna", "zo1") and not cfg.eval.s2d
    with pytest.raises(SystemExit):  # a route neither package has
        train_cli.build_parser().parse_args(["--train_impl", "pallas"])


def test_train_cli_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--synthetic", "--path_exp_dir", str(tmp_path / "e")])


@pytest.mark.parametrize("argv,error,match", [
    (["--device", "cuda", "--num_devices", "2"], ValueError, "requested 2 devices, have 1"),
    (["--path_load_model", "{orbax_dir}", "--mult_chan", "2"], NotImplementedError,
     "Orbax.*convert_orbax_checkpoint"),
])
def test_train_cli_refuses_unported_flags(argv, error, match, tmp_path, monkeypatch):
    """Two ranks on a machine with one card raise JAX's make_mesh error
    before any rank starts; an Orbax directory names the converter."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    orbax_dir = tmp_path / "orbax_ckpt"
    orbax_dir.mkdir()
    argv = [a.format(orbax_dir=orbax_dir) for a in argv]
    with pytest.raises(error, match=match):
        train_cli.main(["--synthetic", "--device", "cpu", "--path_exp_dir", str(tmp_path / "e"),
                        *argv])



@pytest.mark.parametrize("flag,pipeline", [
    ("on", "On-device pipeline: bank of 2 volumes"), ("off", "Host pipeline: PatchSampler"),
    ("auto", "On-device pipeline: bank of 2 volumes"),
])
def test_train_cli_on_device_pipeline(flag, pipeline, tmp_path):
    """--on_device_pipeline on / off / auto: the sampler the run log names
    (auto takes the bank: 2 synthetic volumes fit the 4 GiB budget), one
    step of 2, a finite loss."""
    res = train_cli.main(["--synthetic", "--device", "cpu", "--mult_chan", "2",
                          "--adopted_datasets", "dna", "--num_epochs", "1", "--interval_val", "2",
                          "--batch_size", "2", "--batch_size_eval", "1", "--debugging",
                          "--on_device_pipeline", flag, "--path_exp_dir", str(tmp_path / "e")])
    log = (tmp_path / "e" / "logs" / "run_e.log").read_text()
    assert f"[DATA]    {pipeline}" in log
    assert ("On-device" in log) == (flag != "off") and ("Host pipeline" in log) == (flag == "off")
    assert res["state"].step == 1 and np.isfinite(res["train_log"]["loss/epoch"])
