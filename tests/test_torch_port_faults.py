"""Training options of the port that must mean what they mean in JAX, on the CPU.

  * ``ModelConfig.remat``: the train-mode MoDE conv runs under
    ``torch.utils.checkpoint`` (JAX ``jax.checkpoint``), which recomputes the
    forward conv in the backward and changes no gradient;
  * ``--train_impl``: the JAX package's four choices parse and reach the
    config unchanged;
  * ``conv3d_same_autograd``, the shared-kernel conv of a differentiated
    expert sum, against JAX ``repmode_tpu.ops.conv3d.conv3d_same`` (value and
    gradients); both expert sums take it under autograd and ``conv3d_same``
    (K1 on the card) without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repmode_tpu.cli import args as jargs
from repmode_tpu.ops.conv3d import conv3d_same as jax_conv3d_same
from repmode_tpu_torch.cli.args import build_parser, to_config
from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models.repmode import RepModeNet
from repmode_tpu_torch.ops import mode as tmode
from repmode_tpu_torch.ops.conv3d import conv3d_same_autograd

torch.set_num_threads(2)


# ------------------------------------------------------------------- remat


@pytest.mark.parametrize("s2d", [False, True])
def test_remat_recomputes_the_conv_and_changes_no_gradient(s2d, monkeypatch):
    """One fp32 training forward and backward with remat False and True from
    the same weights and batch: equal loss and gradients (max rel 1e-6), and
    under remat the per-sample forward conv runs twice as often (its
    recomputation in the backward)."""
    forwards = []
    conv = tmode.conv3d_same_persample

    def counting(*args, **kwargs):
        forwards.append(not kwargs.get("transpose_taps", False))
        return conv(*args, **kwargs)

    monkeypatch.setattr(tmode, "conv3d_same_persample", counting)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32))
    target = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32))
    task = torch.tensor([0, 1])
    runs = {}
    for remat in (False, True):
        cfg = ModelConfig(mult_chan=4, depth=2, remat=remat, train_s2d=s2d)
        net = RepModeNet(cfg, 2, generator=torch.Generator().manual_seed(1), device="cpu").train()
        forwards.clear()
        loss = ((net(x, task) - target) ** 2).mean()
        loss.backward()
        grads = {k: p.grad.clone() for k, p in net.named_parameters()}
        runs[remat] = (loss.item(), grads, sum(forwards))
    (loss0, g0, n0), (loss1, g1, n1) = runs[False], runs[True]
    assert n0 > 0 and n1 == 2 * n0
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    for k in g0:
        top = float(g0[k].abs().max())
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-6 * top, k


# ----------------------------------------------------------- --train_impl


@pytest.mark.parametrize("impl", ["auto", "expert_sum", "merged_pallas", "merged"])
def test_train_impl_takes_the_jax_choices(impl):
    argv = ["--synthetic", "--train_impl", impl]
    assert to_config(build_parser().parse_args(argv)).model.train_impl == impl
    assert jargs.to_config(jargs.build_parser().parse_args(argv)).model.train_impl == impl


# ------------------------------------------------- the train-mode shared conv


def _conv_case(k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 16, 3))
    w = rng.standard_normal((k, k, k, 3, 4)) / np.sqrt(k**3 * 3)
    cot = rng.standard_normal((2, 16, 16, 16, 4))
    return x, w, cot


def _jax_conv_and_grads(x, w, cot, compute_dtype):
    def f(xx, ww):
        return jax_conv3d_same(xx, ww, compute_dtype=compute_dtype, accum_dtype=None)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(cot, dtype=y.dtype))
    return [np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a).astype(np.float64)
            for a in (y, dx, dw)]


def _port_conv_and_grads(x, w, cot, compute_dtype):
    xx = torch.from_numpy(x).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    y = conv3d_same_autograd(xx, ww, compute_dtype=compute_dtype)
    y.backward(torch.from_numpy(cot).to(y.dtype))
    return y, [a.detach().double().numpy() for a in (y, xx.grad, ww.grad)]


@pytest.mark.parametrize("k", [5, 3, 1])
def test_conv3d_same_autograd_matches_jax_fp64(k):
    """fp64 in and out: value and both gradients within atol 1e-9."""
    x, w, cot = _conv_case(k, seed=10 + k)
    with jax.enable_x64(True):
        ref = _jax_conv_and_grads(x, w, cot, None)
    y, ours = _port_conv_and_grads(x, w, cot, None)
    assert y.dtype == torch.float64 and y.shape == (2, 16, 16, 16, 4)
    for name, a, b in zip(("y", "dx", "dw"), ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("k", [5, 3, 1])
def test_conv3d_same_autograd_matches_jax_bf16(k):
    """compute_dtype bf16: the output is bf16, as JAX's AD-safe conv's;
    value and both gradients within rel L2 1e-2 (bf16 rounding of inputs,
    outputs and the cotangent, in different sum orders)."""
    x, w, cot = _conv_case(k, seed=20 + k)
    x, w, cot = (a.astype(np.float32) for a in (x, w, cot))
    ref = _jax_conv_and_grads(x, w, cot, jnp.bfloat16)
    y, ours = _port_conv_and_grads(x, w, cot, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    for name, a, b in zip(("y", "dx", "dw"), ours, ref):
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= 1e-2, (name, rel)


def _counted(monkeypatch):
    """Counting wrappers on the two convs an expert sum may call."""
    calls = {"conv3d_same": 0, "conv3d_same_autograd": 0}
    for name in calls:
        fn = getattr(tmode, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tmode, name, wrapper)
    return calls


@pytest.mark.parametrize("route", ["native", "s2d"])
def test_expert_sum_trains_through_the_autograd_conv(route, monkeypatch):
    """Under grad every expert conv of both expert sums goes through
    conv3d_same_autograd, and the gradients reach x and the experts; under
    no_grad every one goes through conv3d_same."""
    calls = _counted(monkeypatch)
    rng = np.random.default_rng(30)
    ci, co = 4, 4
    c = 4 * ci if route == "s2d" else ci
    x = torch.from_numpy(rng.standard_normal((2, 4, 6, 6, c)).astype(np.float32))
    shapes = [(5, 5, 5, ci, co), (3, 3, 3, ci, co)] + [(1, 1, 1, ci, co)] * 3
    ek = tmode.ExpertKernels(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.1) for s in shapes))
    g = torch.softmax(torch.from_numpy(rng.standard_normal((2, 5, co)).astype(np.float32)), 1)
    op = tmode.mode_conv_expert_sum_s2d_domain if route == "s2d" else tmode.mode_conv_expert_sum

    with torch.no_grad():
        ref = op(x, ek, g)
    assert calls == {"conv3d_same": 5, "conv3d_same_autograd": 0}

    xg = x.clone().requires_grad_()
    ekg = tmode.ExpertKernels(*(w.clone().requires_grad_() for w in ek))
    y = op(xg, ekg, g)
    assert calls == {"conv3d_same": 5, "conv3d_same_autograd": 5}
    assert y.dtype == torch.float32
    torch.testing.assert_close(y.detach(), ref, rtol=1e-5, atol=1e-5)
    y.square().sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    for w in ekg:
        assert w.grad is not None and float(w.grad.abs().sum()) > 0
