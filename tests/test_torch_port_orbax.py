"""``convert_orbax_checkpoint.py``: a JAX Orbax checkpoint becomes a ``.p``
that the port resumes from, on the CPU.

For both models (RepMode at depth 1, UNet at depth 2; mult_chan 2, fp32,
16^3 patches) and both Adam layouts of the JAX package (``flat``, one
moment vector in ``ravel_pytree`` order; ``per_tensor``, optax trees): JAX
``create_train_state`` and one JAX step (non-zero moments), Orbax
``save_checkpoint``, the converter, then the port's ``load_train_state``
(strict names) and

  * the eval-mode forward equal to JAX's (rel L2 <= 1e-5);
  * every Adam moment equal to JAX's, bit for bit (a relayout), its step the
    Adam count, the counters JAX's;
  * one further step in each package: loss rtol 1e-5 and running stats rtol
    2e-3 (test_train_step_matches_jax's tolerances), the
    parameters after the Adam step within 2 lr of JAX's and within 1e-7 on
    all but 1% of the elements (a second Adam step from carried moments
    moves an element by ~lr; only gradient elements too small to resolve
    their sign differ).

A moment leaf with no parameter to map to is named, and the ``.p`` then
carries no Adam state: a resume restarts Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import convert_orbax_checkpoint as converter
from repmode_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from repmode_tpu.config import Config as JaxConfig
from repmode_tpu.config import DataConfig as JaxDataConfig
from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.config import TrainConfig as JaxTrainConfig
from repmode_tpu.models import build_model as jax_build_model
from repmode_tpu.train.state import create_train_state as jax_create_train_state
from repmode_tpu.train.state import flat_adam
from repmode_tpu.train.step import make_train_step as jax_make_train_step
from repmode_tpu_torch.ckpt.checkpoint import load_train_state
from repmode_tpu_torch.compat.weights import from_jax_variables, load_reference_checkpoint
from repmode_tpu_torch.config import Config
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

LR = 1e-4
MODELS = {"RepMode": 1, "UNet": 2}  # model -> depth


def jax_config(model):
    return JaxConfig(
        model=JaxModelConfig(name=model, mult_chan=2, depth=MODELS[model], train_s2d=False,
                             train_impl="merged"),
        data=JaxDataConfig(adopted_datasets=("dna", "lamin_b1")),
        train=JaxTrainConfig(compute_dtype="float32", patch_size=(16, 16, 16), batch_size=2,
                             lr=LR),
        exp_name="orbax")


def batch_np(seed):
    sig = np.random.default_rng(seed).standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    return {"signal": sig, "target": (0.5 * sig + 0.1).astype(np.float32),
            "task": np.array([1, 0], np.int32)}


def tx_of(schema):
    return flat_adam(LR) if schema == "flat" else optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)


@pytest.fixture(scope="module")
def jax_states():
    """model -> the JAX state after create_train_state (the flat layout)."""
    return {m: jax_create_train_state(jax_config(m), jax.random.PRNGKey(9)) for m in MODELS}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("schema", ["flat", "per_tensor"])
@pytest.mark.parametrize("model", list(MODELS))
def test_converted_checkpoint_resumes_in_the_port(jax_states, model, schema, tmp_path,
                                                  monkeypatch):
    # the JAX package restores into the optimizer layout REPMODE_FLAT_ADAM names:
    # per_tensor keeps the checkpoint's optax trees, so the converter reads them
    monkeypatch.setenv("REPMODE_FLAT_ADAM", "0" if schema == "per_tensor" else "1")
    jcfg = jax_config(model)
    tx = tx_of(schema)
    jstate = jax_states[model]
    jstate = jstate.replace(opt_state=tx.init(jstate.params))
    step = jax_make_train_step(jcfg, donate=False, tx=tx)
    jb1 = {k: jnp.asarray(v) for k, v in batch_np(1).items()}
    jstate, _ = step(jstate, jb1)
    jstate = jstate.replace(epoch=jnp.asarray(3, jnp.int32))
    src, dst = str(tmp_path / "orbax"), str(tmp_path / "converted.p")
    jax_save_checkpoint(src, jstate, jcfg)

    lines = []
    assert converter.convert(src, dst, log=lines.append) == []
    assert lines == [f"convert_orbax_checkpoint: {model} at step 1, epoch 3 -> {dst}"]
    loaded = load_reference_checkpoint(dst)
    assert loaded["adopted_datasets"] == ["dna", "lamin_b1"]
    cfg = Config.from_json(torch.load(dst, weights_only=False)["opts"].config_json)
    assert cfg.model.name == model and cfg.train.lr == LR
    state = create_train_state(cfg, device="cpu")
    load_train_state(dst, state)
    assert (state.step, state.epoch) == (1, 3)

    # the forward
    x = batch_np(2)["signal"]
    ref = jax_build_model(jcfg).apply(jstate.variables, jnp.asarray(x),
                                      jnp.asarray([0, 1], jnp.int32), train=False)
    with torch.no_grad():
        y = state.net.eval()(torch.from_numpy(x), torch.tensor([0, 1]))
    assert rel_l2(y.numpy(), ref) <= 1e-5

    # the moments, a relayout of JAX's
    adam = jstate.opt_state if schema == "flat" else jstate.opt_state[0]
    if schema == "flat":
        _, unravel = ravel_pytree(jstate.params)
        mu, nu = unravel(adam.mu), unravel(adam.nu)
    else:
        mu, nu = adam.mu, adam.nu
    want = {"exp_avg": from_jax_variables(jax.tree.map(np.asarray, mu)),
            "exp_avg_sq": from_jax_variables(jax.tree.map(np.asarray, nu))}
    named = dict(state.net.named_parameters())
    assert len(state.optimizer.state) == len(named)
    for name, p in named.items():
        st = state.optimizer.state[p]
        assert float(st["step"]) == int(adam.count) == 1
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], want[k][name]), (name, k)
            assert float(st[k].abs().max()) > 0, (name, k)

    # one further step in each package
    batch = batch_np(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    stepped, jm = step(jstate, jb)
    m = make_train_step(cfg, state)({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    ref_sd = from_jax_variables(jax.tree.map(np.asarray, stepped.variables))
    diffs = []
    for k, v in state.net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), rtol=2e-3, atol=1e-4,
                                       err_msg=k)
        elif k in named:
            diffs.append(np.abs(v.detach().numpy() - ref_sd[k].numpy()).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR and (diffs > 1e-7).mean() < 1e-2
    assert float(state.optimizer.state[next(iter(named.values()))]["step"]) == 2


def test_unmapped_moment_leaves_are_named(jax_states, tmp_path, monkeypatch, capsys):
    """A moment tree with a leaf no parameter has is named, and the .p
    carries no Adam state: the port's resume restarts Adam with the
    converted weights and counters."""
    monkeypatch.setenv("REPMODE_FLAT_ADAM", "1")
    jcfg = jax_config("UNet")
    jstate = jax_states["UNet"]
    src, dst = str(tmp_path / "orbax"), str(tmp_path / "converted.p")
    jax_save_checkpoint(src, jstate, jcfg)
    moments = converter.jax_adam_moments

    def renamed(js):
        mu, nu, count = moments(js)
        mu = dict(mu)
        mu["out_v"] = mu.pop("out_w")
        return mu, nu, count

    monkeypatch.setattr(converter, "jax_adam_moments", renamed)
    assert converter.main([src, dst]) == 0
    out = capsys.readouterr().out
    assert "out_v" in out and "a resume restarts Adam" in out
    state = create_train_state(Config.from_json(jcfg.to_json()), device="cpu")
    load_train_state(dst, state)
    assert not state.optimizer.state and (state.step, state.epoch) == (0, 0)
    sd = from_jax_variables(jax.tree.map(np.asarray, jstate.variables))
    for k, v in state.net.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_adam_state_names_each_unmapped_leaf():
    """adam_state refuses per leaf: an extra leaf, a leaf of another shape
    and a parameter without a moment."""
    net = torch.nn.Linear(3, 2)
    mu = {"weight": torch.zeros(2, 3), "bias": torch.zeros(2)}
    assert converter.adam_state(net, mu, dict(mu), 4)[1] == []
    state, _ = converter.adam_state(net, mu, dict(mu), 4)
    assert float(state[net.weight]["step"]) == 4.0
    bad = {"weight": torch.zeros(3, 2), "extra": torch.zeros(1)}
    assert converter.adam_state(net, bad, dict(bad), 4) == (
        {}, ["bias (no moment)", "extra", "weight"])
