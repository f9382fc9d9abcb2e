"""The port's model, weights and re-parameterization against the reference
goldens and the JAX package, on the CPU.

  * the reference state_dict (tests/goldens/repmode_small.npz, ``sd.*``)
    loads into ``RepModeNet`` with strict=True, and the fp64 eval forward and
    the re-parameterized plain net both reproduce the reference's ``y_eval``;
  * ``from_jax_variables`` is the inverse of the JAX package's
    ``convert_state_dict``, and the port then computes what the JAX net
    computes in eval mode;
  * ``reparameterize`` leaf by leaf and ``plain_forward`` in fp32 and bf16
    against the JAX functions.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repmode_tpu.compat.torch_import import convert_state_dict
from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.models.repmode import RepModeNet as JaxRepModeNet
from repmode_tpu.models.reparam import plain_forward as jax_plain_forward
from repmode_tpu.models.reparam import reparameterize as jax_reparameterize
from repmode_tpu_torch.compat.weights import from_jax_variables, load_reference_checkpoint
from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models.reparam import (
    plain_forward,
    reparameterize,
    reparameterize_all_tasks,
)
from repmode_tpu_torch.models.repmode import RepModeNet

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "repmode_small.npz")
NUM_TASKS = 3


def ndhwc(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 3, 4, 1))))


def to_ncdhw(y):
    return np.transpose(y.detach().numpy(), (0, 4, 1, 2, 3))


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    net = RepModeNet(ModelConfig(mult_chan=2, depth=4, train_s2d=False), NUM_TASKS,
                     device="cpu").double()
    net.load_state_dict(sd, strict=True)
    return z, sd, net.eval()


def test_golden_state_dict_names_and_shapes(golden):
    _, sd, net = golden
    ours = net.state_dict()
    assert list(ours) == list(sd)  # the reference's registration order too
    for k, v in sd.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k


def test_golden_eval_forward_fp64(golden):
    z, _, net = golden
    with torch.no_grad():
        y = net(ndhwc(z["x"]), torch.from_numpy(z["tasks_uniform"]))
    np.testing.assert_allclose(to_ncdhw(y), z["y_eval"], rtol=1e-4, atol=1e-4)


def test_golden_plain_forward_fp64(golden):
    z, sd, net = golden
    plain = reparameterize(sd, net.cfg, NUM_TASKS, int(z["tasks_uniform"][0]))
    y = plain_forward(plain, ndhwc(z["x"]), net.cfg)
    np.testing.assert_allclose(to_ncdhw(y), z["y_eval"], rtol=1e-4, atol=1e-4)


def test_train_mode_forward_raises(golden):
    """The train-mode forward runs the MoDE route ``train_impl`` names and
    raises for a name it does not know (eval mode does not read it)."""
    z, sd, _ = golden
    net = RepModeNet(ModelConfig(mult_chan=2, depth=4, train_impl="vmapped", train_s2d=False),
                     NUM_TASKS, device="cpu").double()
    net.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="train_impl"):
        net.train()(ndhwc(z["x"]), torch.from_numpy(z["tasks_uniform"]))
    with torch.no_grad():
        y = net.eval()(ndhwc(z["x"]), torch.from_numpy(z["tasks_uniform"]))
    np.testing.assert_allclose(to_ncdhw(y), z["y_eval"], rtol=1e-4, atol=1e-4)


def test_model_without_cuda_or_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RepModeNet(ModelConfig(mult_chan=2, depth=1), NUM_TASKS)


def test_load_reference_checkpoint(tmp_path, golden):
    _, sd, _ = golden
    path = str(tmp_path / "model_best.p")
    torch.save({
        "nn_module": "RepMode",
        "opts": types.SimpleNamespace(adopted_datasets=["task2", "task0", "task1"]),
        "nn_state": {k: v.half() if v.is_floating_point() else v for k, v in sd.items()},
        "optimizer_state": {}, "count_iter": 123, "count_epoch": 7,
    }, path)
    out = load_reference_checkpoint(path)
    assert out["count_epoch"] == 7 and out["count_iter"] == 123
    assert out["adopted_datasets"] == ["task0", "task1", "task2"]
    assert out["state_dict"]["conv_out.gate.weight"].dtype == torch.float32
    net = RepModeNet(ModelConfig(mult_chan=2, depth=4, train_s2d=False), NUM_TASKS, device="cpu")
    net.load_state_dict(out["state_dict"], strict=True)


# ------------------------------------------------------ against the JAX net


@pytest.fixture(scope="module")
def jax_net():
    """A JAX RepModeNet (mult_chan 2, depth 2, 16^3) with BN running stats
    that keep the random net's activations alive through the ReLUs."""
    cfg = JaxModelConfig(mult_chan=2, depth=2, train_s2d=False)
    net = JaxRepModeNet(cfg, NUM_TASKS)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    # params do not depend on the spatial size: init on a tiny input
    variables = jax.jit(functools.partial(net.init, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 4, 4, 1)), jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(1)
    variables = jax.tree.map(np.asarray, variables)
    stats = variables["batch_stats"]
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(*((-0.02, 0.02) if "mean" in jax.tree_util.keystr(p)
                                   else (0.02, 0.1)), a.shape).astype(np.float32),
        stats,
    )
    return cfg, net, variables, x


def test_from_jax_variables_round_trips(jax_net):
    _, _, variables, _ = jax_net
    back = convert_state_dict(from_jax_variables(variables))
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == [
        jax.tree_util.keystr(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eval_forward_matches_jax_fp32(jax_net):
    cfg, net, variables, x = jax_net
    tasks = np.array([2, 2], np.int32)
    ref = jax.jit(functools.partial(net.apply, train=False))(
        variables, jnp.asarray(x), jnp.asarray(tasks))
    assert np.std(np.asarray(ref)) > 1e-3  # the test net is not degenerate
    port = RepModeNet(ModelConfig(mult_chan=2, depth=2, train_s2d=False), NUM_TASKS, device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        y = port.eval()(torch.from_numpy(x), torch.from_numpy(tasks))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("task", range(NUM_TASKS))
def test_reparameterize_matches_jax(jax_net, task):
    cfg, _, variables, _ = jax_net
    ref = jax_reparameterize(variables, cfg, NUM_TASKS, task)
    ours = reparameterize(from_jax_variables(variables), ModelConfig(mult_chan=2, depth=2),
                          NUM_TASKS, task)
    flat_ref = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert flat.keys() == flat_ref.keys()
    for k in flat:
        np.testing.assert_allclose(flat[k].numpy(), np.asarray(flat_ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_reparameterize_all_tasks_stacks(jax_net):
    _, _, variables, _ = jax_net
    sd, cfg = from_jax_variables(variables), ModelConfig(mult_chan=2, depth=2)
    stacked = reparameterize_all_tasks(sd, cfg, NUM_TASKS)
    single = reparameterize(sd, cfg, NUM_TASKS, 1)
    for blk in ("encoder_block1", "bottle_block", "decoder_block2"):
        for k, v in single[blk].items():
            assert stacked[blk][k].shape[0] == NUM_TASKS
            torch.testing.assert_close(stacked[blk][k][1], v)
    torch.testing.assert_close(stacked["conv_out_w"][1], single["conv_out_w"])


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_plain_forward_matches_jax(jax_net, cdt):
    """fp32 within 1e-4. bf16: inputs of each conv are rounded at the same
    sites as in the JAX net; sums run in another order, which can flip a
    bf16 rounding, so the bound is relative L2 <= 1e-2."""
    cfg, _, variables, x = jax_net
    ref_plain = jax_reparameterize(variables, cfg, NUM_TASKS, 1)
    jcd = None if cdt == "float32" else jnp.bfloat16
    ref = np.asarray(jax.jit(functools.partial(jax_plain_forward, cfg=cfg, compute_dtype=jcd))(
        ref_plain, jnp.asarray(x)))
    plain = reparameterize(from_jax_variables(variables), ModelConfig(mult_chan=2, depth=2),
                           NUM_TASKS, 1)
    y = plain_forward(plain, torch.from_numpy(x), ModelConfig(mult_chan=2, depth=2),
                      compute_dtype=None if cdt == "float32" else torch.bfloat16).numpy()
    assert y.dtype == np.float32 and y.shape == ref.shape
    if cdt == "float32":
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)
    else:
        assert np.linalg.norm(y - ref) / np.linalg.norm(ref) <= 1e-2
