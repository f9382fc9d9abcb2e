"""The port's model registry and UNet baseline against the JAX package, on
the CPU (mult_chan 2, depth 2, 16^3 patches).

  * the registry: names, and the KeyError JAX raises for an unknown model;
  * ``UNet3D`` in training and eval mode against JAX's ``UNet3D.apply`` from
    the same weights, fp32 and bf16, and the route of its convs;
  * one train step against JAX's ``make_train_step``: loss, gradients, the
    Adam update, BN running stats;
  * ``make_inference`` against JAX's non-RepMode branch;
  * ``cli.train --nn_module UNet`` then ``cli.evaluate``: the same test MSE.
"""

import functools
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
from repmode_tpu.models import available_models as jax_available_models
from repmode_tpu.models import build_model as jax_build_model
from repmode_tpu.models.reparam import make_inference as jax_make_inference
from repmode_tpu.train.state import create_train_state as jax_create_train_state
from repmode_tpu.train.step import make_train_step as jax_make_train_step
from repmode_tpu_torch.cli import evaluate
from repmode_tpu_torch.cli import train as train_cli
from repmode_tpu_torch.compat.weights import from_jax_variables
from repmode_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.models import UNet3D, available_models, build_model
from repmode_tpu_torch.models import unet as unet_mod
from repmode_tpu_torch.models.reparam import make_inference
from repmode_tpu_torch.train.state import TrainState, make_optimizer
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

TASKS = ("a", "b")
LR = 1e-4


def configs(compute_dtype="float32"):
    jcfg = JaxConfig(model=JaxModelConfig(name="UNet", mult_chan=2, depth=2),
                     data=JaxDataConfig(adopted_datasets=TASKS),
                     train=JaxTrainConfig(compute_dtype=compute_dtype, patch_size=(16, 16, 16),
                                          batch_size=2, lr=LR))
    cfg = Config(model=ModelConfig(name="UNet", mult_chan=2, depth=2),
                 data=DataConfig(adopted_datasets=TASKS),
                 train=TrainConfig(compute_dtype=compute_dtype, patch_size=(16, 16, 16),
                                   batch_size=2, lr=LR))
    return jcfg, cfg


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_grads_close(ours, ref):
    """test_train_step_matches_jax's gradient checks: per tensor rel L2 <
    0.15 and cosine > 0.995, global rel L2 < 0.05."""
    assert ours.keys() == ref.keys() and len(ref) > 20
    a_all, b_all = [], []
    for name in ref:
        a = ours[name].detach().double().numpy().ravel()
        b = np.asarray(ref[name], np.float64).ravel()
        a_all.append(a)
        b_all.append(b)
        assert np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-20) < 0.15, name
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-20) > 0.995, name
    ga, gb = np.concatenate(a_all), np.concatenate(b_all)
    assert np.linalg.norm(ga - gb) / np.linalg.norm(gb) < 0.05


def batch_np(seed=6):
    sig = np.random.default_rng(seed).standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    return {"signal": sig, "target": (0.5 * sig + 0.1).astype(np.float32),
            "task": np.array([1, 0], np.int32)}


@pytest.fixture(scope="module")
def jax_variables():
    """JAX UNet variables (numpy) with non-trivial running statistics: the
    init's, then one train-mode forward's update."""
    jcfg, _ = configs()
    net = jax_build_model(jcfg)
    x = jnp.asarray(batch_np(1)["signal"])
    v = jax.jit(functools.partial(net.init, train=True))({"params": jax.random.PRNGKey(3)}, x)
    _, upd = jax.jit(functools.partial(net.apply, train=True, mutable=["batch_stats"]))(v, x)
    return jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": upd["batch_stats"]})


def port_net(variables, compute_dtype="float32"):
    _, cfg = configs(compute_dtype)
    net = build_model(cfg, device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return net


# ------------------------------------------------------------------ registry


def test_registry_names_and_unknown_model():
    assert available_models() == jax_available_models() == ["RepMode", "UNet"]
    _, cfg = configs()
    assert isinstance(build_model(cfg, device="cpu"), UNet3D)
    bad = Config(model=ModelConfig(name="NoSuchNet"))
    with pytest.raises(KeyError) as ours:
        build_model(bad, device="cpu")
    with pytest.raises(KeyError) as ref:
        jax_build_model(JaxConfig(model=JaxModelConfig(name="NoSuchNet")))
    assert str(ours.value) == str(ref.value)


def test_unet_weights_map_one_to_one(jax_variables):
    """Every JAX leaf has one port entry (43 parameters and 28 statistics at
    depth 2, plus a num_batches_tracked per BN) in the torch layouts; a
    fresh net draws each weight from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as
    JAX's init does."""
    sd = from_jax_variables(jax_variables)
    n_params = len(jax.tree.leaves(jax_variables["params"]))
    n_stats = len(jax.tree.leaves(jax_variables["batch_stats"]))
    assert (n_params, n_stats) == (43, 28)
    assert len(sd) == n_params + n_stats + n_stats // 2
    net = port_net(jax_variables)
    assert {k.split(".")[0] for k, _ in net.named_parameters()} == set(jax_variables["params"])
    assert tuple(net.up1_w.shape) == (4, 2, 2, 2, 2)  # a transposed conv's (Ci, Co, k, k, k)
    fresh = build_model(configs()[1], torch.Generator().manual_seed(0), device="cpu")
    for name, p in fresh.named_parameters():
        if name.endswith("w"):
            # fan_in = p[0].numel(): Ci * k^3 of a conv (Co, Ci, k, k, k), Co * 8
            # of a transposed conv (Ci, Co, 2, 2, 2), as torch computes it
            bound = p[0].numel() ** -0.5
            assert bound * 0.5 < float(p.abs().max()) <= bound, name


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unet_fp32_forward_matches_jax(jax_variables, train):
    """fp32, training and eval mode: output rel L2 <= 1e-5; in training the
    updated running statistics rel <= 1e-5 too."""
    jcfg, _ = configs()
    x = batch_np(2)["signal"]
    jnet = jax_build_model(jcfg)
    ref, upd = jnet.apply(jax_variables, jnp.asarray(x), None, train=train,
                          mutable=["batch_stats"])
    net = port_net(jax_variables).train(train)
    with torch.no_grad():
        y = net(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (2, 16, 16, 16, 1)
    assert rel_l2(y.numpy(), ref) <= 1e-5
    if train:
        want = from_jax_variables(jax.tree.map(np.asarray, {
            "params": jax_variables["params"], "batch_stats": upd["batch_stats"]}))
        for k, v in net.state_dict().items():
            if "running" in k:
                assert rel_l2(v.numpy(), want[k].numpy()) <= 1e-5, k


def test_unet_bf16_eval_forward_matches_jax(jax_variables):
    """bf16 eval: both round each conv's inputs to bf16 and return its sums
    in fp32, so only the summation order differs: rel L2 <= 1e-3."""
    jcfg, _ = configs("bfloat16")
    x = batch_np(2)["signal"]
    ref = jax_build_model(jcfg).apply(jax_variables, jnp.asarray(x), None, train=False)
    net = port_net(jax_variables, "bfloat16").eval()
    with torch.no_grad():
        y = net(torch.from_numpy(x))
    assert rel_l2(y.numpy(), ref) <= 1e-3


def test_unet_bf16_train_forward_within_bf16_rounding(jax_variables):
    """bf16 training: the port's conv output is bf16 (F.conv3d) and is widened
    before BN, one bf16 rounding JAX's fp32-output conv does not make. The
    batch-statistics BN amplifies any rounding where a channel's mean is
    large against its spread (post-ReLU inputs), so JAX's own bf16 forward
    is ~1e-2 from its fp32 one here. Held: the port's rel L2 to the fp32 JAX
    forward <= 2x JAX bf16's, and to JAX bf16 <= 3e-2."""
    x = jnp.asarray(batch_np(2)["signal"])
    refs = {}
    for cdt in ("float32", "bfloat16"):
        jcfg, _ = configs(cdt)
        refs[cdt], _ = jax_build_model(jcfg).apply(jax_variables, x, None, train=True,
                                                   mutable=["batch_stats"])
    net = port_net(jax_variables, "bfloat16").train()
    with torch.no_grad():
        y = net(torch.from_numpy(np.array(x))).numpy()
    jax_err = rel_l2(refs["bfloat16"], refs["float32"])
    assert 0 < rel_l2(y, refs["float32"]) <= 2 * jax_err
    assert rel_l2(y, refs["bfloat16"]) <= 3e-2


def test_unet_conv_routes(jax_variables, monkeypatch):
    """Eval mode without grad: every 'same' conv (4 * depth + 3 = 11) through
    conv3d_same, K1's wrapper; training: every one through
    conv3d_same_autograd, none through conv3d_same."""
    calls = {"conv3d_same": 0, "conv3d_same_autograd": 0}

    def counting(name):
        fn = getattr(unet_mod, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in calls:
        monkeypatch.setattr(unet_mod, name, counting(name))
    net = port_net(jax_variables)
    x = torch.from_numpy(batch_np(2)["signal"])
    with torch.no_grad():
        net.eval()(x)
    assert calls == {"conv3d_same": 11, "conv3d_same_autograd": 0}
    net.train()(x).sum().backward()
    assert calls == {"conv3d_same": 11, "conv3d_same_autograd": 11}
    assert all(p.grad is not None for p in net.parameters())


# ------------------------------------------------------- one step against JAX


def _capture_grads():
    """An optax transform that applies no update and keeps the gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def test_unet_train_step_matches_jax():
    """One fp32 step from the same weights: loss and per-task sums rtol
    1e-5; gradients at test_train_step_matches_jax's tolerances; running
    stats rtol 2e-3; parameters after the Adam step (torch.optim.Adam against
    JAX's flat_adam): a first Adam step moves each element by lr * g /
    (|g| + eps), ~lr * sign(g), so they agree within 1e-7 except where a
    gradient element is too small for its sign to be resolved (<= 2 lr, on
    under 1% of the elements)."""
    jcfg, cfg = configs()
    batch = batch_np()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(5))
    captured, jm = jax_make_train_step(jcfg, donate=False, tx=_capture_grads())(
        jstate.replace(opt_state=_capture_grads().init(jstate.params)), jb)
    stepped, _ = jax_make_train_step(jcfg, donate=False)(jstate, jb)

    net = port_net(jax.tree.map(np.asarray, jstate.variables)).train()
    state = TrainState(net=net, optimizer=make_optimizer(cfg, net))
    m = make_train_step(cfg, state)({k: torch.from_numpy(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["per_task_loss_sum"].numpy(),
                               np.asarray(jm["per_task_loss_sum"]), rtol=1e-5)
    np.testing.assert_array_equal(m["per_task_count"].numpy(), np.asarray(jm["per_task_count"]))
    ref_grads = from_jax_variables(jax.tree.map(np.asarray, captured.opt_state))
    assert_grads_close({k: p.grad for k, p in net.named_parameters()}, ref_grads)
    ref_sd = from_jax_variables(jax.tree.map(np.asarray, stepped.variables))
    diffs = []
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), rtol=2e-3, atol=1e-4,
                                       err_msg=k)
        elif k in dict(net.named_parameters()):
            diffs.append(np.abs(v.detach().numpy() - ref_sd[k].numpy()).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR + 1e-7
    assert (diffs > 1e-7).mean() < 1e-2


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_make_inference_matches_jax(jax_variables, compute_dtype, tol):
    """The non-RepMode branch: prepare ignores the task and merges nothing;
    forward is the eval-mode net (rel L2 <= 1e-5 fp32, 1e-3 bf16)."""
    jcfg, cfg = configs(compute_dtype)
    x = batch_np(4)["signal"]
    jprep, jfwd = jax_make_inference(jcfg)
    ref = jfwd(jprep(jax_variables, 1), jnp.asarray(x))
    prepare, forward = make_inference(cfg)
    sd = from_jax_variables(jax_variables)
    net = prepare(sd, 1)
    assert prepare(sd, 0) is net and not net.training
    y = forward(net, torch.from_numpy(x))
    assert not y.requires_grad
    assert rel_l2(y.numpy(), ref) <= tol


def test_cli_train_then_evaluate_unet(tmp_path):
    """cli.train --nn_module UNet on the CPU (synthetic data, the device bank
    under auto) writes a .p whose cli.evaluate test MSE equals the train
    run's test pass; the run record snapshots unet.py."""
    common = ["--device", "cpu", "--synthetic", "--nn_module", "UNet", "--mult_chan", "2",
              "--adopted_datasets", "dna", "--batch_size", "2", "--batch_size_eval", "1",
              "--debugging"]
    res = train_cli.main([*common, "--num_epochs", "1", "--interval_val", "1",
                          "--path_exp_dir", str(tmp_path / "train")])
    assert isinstance(res["state"].net, UNet3D) and res["state"].step == 1
    assert sorted(os.listdir(tmp_path / "train" / "logs" / "code")) == [
        "config.py", "sampler.py", "step.py", "unet.py"]
    log = evaluate.main([*common, "--torch_checkpoint", res["best_path"],
                         "--path_exp_dir", str(tmp_path / "eval")])
    assert np.isfinite(log["metric_test/MSE"])
    assert log["metric_test/MSE"] == res["test_log"]["metric_test/MSE"]
