"""The port's space-to-depth (s2d) training configuration against the JAX
package's, on the CPU, on the same seeded numpy inputs:

  * autograd through the ``ops/s2d.py`` functions that training uses, against
    ``jax.vjp`` (rtol 1e-5);
  * ``s2d_expert_bank`` (rtol 1e-5) and the s2d MoDE convs:
    ``mode_conv_expert_sum_s2d_domain`` in both pool forms, the merged route
    ``mode_conv_merged_s2d`` against JAX ``mode_conv_merged_s2d_domain`` and
    the expert sum, ``mode_conv_tapmajor_merged_s2d``; values rtol 1e-5,
    gradients of x, the experts and the gate logits rtol 1e-4 (fp32);
  * phase BN (``phases=4``) against JAX ``BatchNorm3d(phases=4)``;
  * ``conv3d_tapconcat_persample_plain``, the plain version of K6, against
    the Pallas tap-concat kernel of ``tools/bench_enc1c1_kernel.py`` in
    interpret mode, and the K6 autograd Function's dW against ``jax.vjp`` of
    JAX's expert sum at the 4-lane entry conv;
  * one fp32 train step of the s2d net against JAX ``make_train_step`` with
    ``ModelConfig(train_s2d=True)``, the s2d net against the native one on the
    same weights, and the dispatch (K6 only at the 4-lane entry conv,
    tap-major only at Co <= 4, the CLI trains native, ``Config()`` s2d).
"""

import importlib.util
import os
import zlib

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
from repmode_tpu.models.repmode import BatchNorm3d as JaxBatchNorm3d
from repmode_tpu.ops import mode as jmode
from repmode_tpu.ops import s2d as js2d
from repmode_tpu.train.state import create_train_state as jax_create_train_state
from repmode_tpu.train.step import make_train_step as jax_make_train_step
from repmode_tpu_torch.cli import train as train_cli
from repmode_tpu_torch.compat.weights import from_jax_variables
from repmode_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.models import repmode as tmodel
from repmode_tpu_torch.models.repmode import RepModeNet
from repmode_tpu_torch.ops import conv3d as tconv
from repmode_tpu_torch.ops import mode as tmode
from repmode_tpu_torch.ops import s2d
from repmode_tpu_torch.ops.norm import batch_norm_apply, batch_norm_train
from repmode_tpu_torch.train.state import TrainState, make_optimizer
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

TASKS = ("task0", "task1", "task2")
E = 5
K6_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                       "bench_enc1c1_kernel.py")


def rng_for(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def npr(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, rtol, atol_scale=None):
    """Elementwise rtol, with an absolute floor of ``rtol`` times the largest
    reference magnitude (sums of mixed signs carry that much rounding)."""
    ref = np.asarray(ref, np.float64)
    atol = rtol * np.abs(ref).max() if atol_scale is None else atol_scale
    np.testing.assert_allclose(np.asarray(ours, np.float64), ref, rtol=rtol, atol=atol)


def experts_np(rng, ci, co):
    return [npr(rng, (k, k, k, ci, co)) for k in (5, 3, 1, 1, 1)]


def mode_operands(key, ci_sizes, co, spatial=(2, 3, 4, 4)):
    """x2 (N,D,h',w',4*sum(ci_sizes)), the five experts, gate logits (N,E*Co)
    and a cotangent (N,D,h',w',4Co), as numpy."""
    rng = rng_for(*key)
    ci = sum(ci_sizes)
    n = spatial[0]
    return (npr(rng, spatial + (4 * ci,)), experts_np(rng, ci, co),
            npr(rng, (n, E * co), 2.0), npr(rng, spatial + (4 * co,)))


def jax_mode(fn, x, ws, logits, dy, co, **kw):
    """Value and the VJPs (x, the five experts, the gate logits) of a JAX
    MoDE conv at the cotangent dy."""
    def f(xx, w5, w3, w1, wa3, wa5, lg):
        g = jmode.gate_logits_to_weights(lg, E, co)
        return fn(xx, jmode.ExpertKernels(w5, w3, w1, wa3, wa5), g, **kw)

    y, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, *ws, logits)))
    return [y, *vjp(jnp.asarray(dy))]


def port_mode(fn, x, ws, logits, dy, co, **kw):
    xx = t(x).requires_grad_()
    ek = tmode.ExpertKernels(*(t(w).requires_grad_() for w in ws))
    lg = t(logits).requires_grad_()
    y = fn(xx, ek, tmode.gate_logits_to_weights(lg, E, co), **kw)
    y.backward(t(dy))
    return [y.detach(), xx.grad, *(w.grad for w in ek), lg.grad]


def assert_mode_close(ours, ref):
    """Values rtol 1e-5; gradients rtol 1e-4 (fp32, different sum orders)."""
    names = ["y", "dx", "dw5", "dw3", "dw1", "dwa3", "dwa5", "dlogits"]
    for name, a, b in zip(names, ours, ref):
        rtol = 1e-5 if name == "y" else 1e-4
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=rtol * float(np.abs(np.asarray(b)).max()), err_msg=name)


# ------------------------------------------------------- ops/s2d.py autograd


def _s2d_grad_cases():
    return {
        "space_to_depth_hw": (s2d.space_to_depth_hw, js2d.space_to_depth_hw, [(2, 3, 4, 6, 5)]),
        "depth_to_space_hw": (s2d.depth_to_space_hw, js2d.depth_to_space_hw, [(2, 3, 2, 3, 12)]),
        "s2d_conv_kernel": (s2d.s2d_conv_kernel, js2d.s2d_conv_kernel, [(5, 5, 5, 3, 2)]),
        "s2d_conv1_kernel": (s2d.s2d_conv1_kernel, js2d.s2d_conv1_kernel, [(1, 1, 1, 3, 2)]),
        "s2d_down_kernel": (s2d.s2d_down_kernel, js2d.s2d_down_kernel, [(2, 2, 2, 3, 4)]),
        "box_pool_s2d": (lambda x: s2d.box_pool_s2d(x, 5), lambda x: js2d.box_pool_s2d(x, 5),
                         [(2, 4, 3, 4, 8)]),
        "downsample_s2d_domain": (s2d.downsample_s2d_domain, js2d.downsample_s2d_domain,
                                  [(2, 4, 3, 2, 8), (2, 1, 1, 8, 5)]),
        "upsample_to_s2d": (s2d.upsample_to_s2d, js2d.upsample_to_s2d,
                            [(2, 2, 3, 2, 5), (2, 2, 2, 5, 3)]),
    }


@pytest.mark.parametrize("name", sorted(_s2d_grad_cases()))
def test_s2d_op_gradients_match_jax(name):
    """Training differentiates through the s2d relayouts, kernel transforms,
    box pool and resamples: the port's autograd equals jax.vjp (fp32)."""
    port_fn, jax_fn, shapes = _s2d_grad_cases()[name]
    rng = rng_for("grad", name)
    args = [npr(rng, s) for s in shapes]
    y_ref, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in args))
    dy = npr(rng, y_ref.shape)
    refs = vjp(jnp.asarray(dy))
    ours = [t(a).requires_grad_() for a in args]
    y = port_fn(*ours)
    y.backward(t(dy))
    close(y.detach(), y_ref, 1e-5)
    for a, r in zip(ours, refs):
        close(a.grad, r, 1e-5)


# ----------------------------------------------------------- the MoDE convs


@pytest.mark.parametrize("sizes", [(3,), (2, 3)])
def test_s2d_expert_bank_matches_jax(sizes):
    rng = rng_for("bank", sizes)
    ws = experts_np(rng, sum(sizes), 2)
    cs = sizes if len(sizes) > 1 else None
    ref = jmode.s2d_expert_bank(jmode.ExpertKernels(*map(jnp.asarray, ws)), cs)
    ours = tmode.s2d_expert_bank(tmode.ExpertKernels(*map(t, ws)), cs)
    assert tuple(ours.shape) == ref.shape == (E, 5, 3, 3, 4 * sum(sizes), 8)
    close(ours, ref, 1e-5)


# dense pool form below 64 native channels per segment, box + pointwise at 64
@pytest.mark.parametrize("sizes", [(3,), (2, 3), (64,), (64, 64)])
def test_expert_sum_s2d_matches_jax_with_grads(sizes):
    co = 2
    x, ws, logits, dy = mode_operands(("es", sizes), sizes, co, spatial=(2, 2, 3, 3))
    kw = dict(channel_sizes=sizes if len(sizes) > 1 else None)
    ref = jax_mode(jmode.mode_conv_expert_sum_s2d_domain, x, ws, logits, dy, co, **kw)
    ours = port_mode(tmode.mode_conv_expert_sum_s2d_domain, x, ws, logits, dy, co, **kw)
    assert_mode_close(ours, ref)


@pytest.mark.parametrize("reference", ["merged_s2d_domain", "expert_sum_s2d_domain"])
@pytest.mark.parametrize("sizes", [(3,), (2, 3)])
def test_merged_s2d_route_matches_jax(reference, sizes):
    """The port's merged route (``MergedConvPerSample``, plain versions of
    K2-K4 on the CPU) against JAX's XLA merged conv and its expert sum:
    one function by linearity, with gradients."""
    co = 3
    x, ws, logits, dy = mode_operands(("merged", sizes), sizes, co)
    kw = dict(channel_sizes=sizes if len(sizes) > 1 else None)
    ref = jax_mode(getattr(jmode, f"mode_conv_{reference}"), x, ws, logits, dy, co, **kw)
    ours = port_mode(tmode.mode_conv_merged_s2d, x, ws, logits, dy, co, **kw)
    assert ours[0].dtype == torch.float32
    assert_mode_close(ours, ref)


@pytest.mark.parametrize("ci,co", [(2, 1), (3, 4)])
def test_tapmajor_merged_s2d_matches_jax(ci, co):
    x, ws, logits, dy = mode_operands(("tapmajor", ci, co), (ci,), co)
    ref = jax_mode(jmode.mode_conv_tapmajor_merged_s2d, x, ws, logits, dy, co)
    ours = port_mode(tmode.mode_conv_tapmajor_merged_s2d, x, ws, logits, dy, co)
    assert_mode_close(ours, ref)


def test_phase_batch_norm_matches_jax():
    """phases=4: statistics per native channel over the four H,W phases;
    output, running mean and running variance as JAX's BatchNorm3d."""
    rng = rng_for("bn4")
    c = 3
    x = npr(rng, (2, 3, 2, 4, 4 * c), 2.0) + 0.4
    scale, bias = npr(rng, (c,)), npr(rng, (c,))
    rm, rv = npr(rng, (c,)), np.abs(npr(rng, (c,))) + 0.5
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}}
    bn = JaxBatchNorm3d(c, phases=4)
    y_ref, upd = bn.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    rm_t, rv_t = t(rm), t(rv)
    y = batch_norm_train(t(x), rm_t, rv_t, t(scale), t(bias), phases=4)
    close(y, y_ref, 1e-5)
    close(rm_t, upd["batch_stats"]["mean"], 1e-5)
    close(rv_t, upd["batch_stats"]["var"], 1e-5)
    y_eval = bn.apply({**variables, "batch_stats": upd["batch_stats"]}, jnp.asarray(x),
                      train=False)
    close(batch_norm_apply(t(x), rm_t, rv_t, t(scale), t(bias), phases=4), y_eval, 1e-5)


# ---------------------------------------------------------------------- K6


def _pallas_tapconcat():
    spec = importlib.util.spec_from_file_location("bench_enc1c1_kernel", K6_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.make_kernel()


def test_tapconcat_plain_matches_pallas_interpret():
    """K6's plain version against the Pallas tap-concat kernel it replaces,
    in interpret mode, bf16 on both sides (inputs rounded, fp32 sums, the
    Pallas kernel writes bf16): within one bf16 ulp of max|r|."""
    rng = rng_for("k6")
    x = npr(rng, (2, 4, 8, 8, 4))
    wn = npr(rng, (2, 180, 8), 0.2)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(_pallas_tapconcat()(xb, jnp.asarray(wn, jnp.bfloat16), h_tile=8,
                                         interpret=True), np.float32)
    ours = tconv.conv3d_tapconcat_persample_plain(t(x), t(wn), compute_dtype=torch.bfloat16,
                                                  out_dtype=torch.float32)
    assert ours.shape == ref.shape == (2, 4, 8, 8, 8)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2.0**-7 * np.abs(ref).max())


def test_tapconcat_plain_is_the_merged_conv_fp32():
    """The tap-concat conv with wn = the (N,5,3,3,4,Co) kernels reshaped to
    (N,180,Co) is the per-sample 'same' conv at taps (5,3,3) (fp64)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, 4, 5, 4), generator=g, dtype=torch.float64)
    w = torch.randn((2, 5, 3, 3, 4, 6), generator=g, dtype=torch.float64)
    before = tconv.conv3d_tapconcat_persample.launches
    y = tconv.conv3d_tapconcat_persample(x, w.reshape(2, 180, 6))
    assert tconv.conv3d_tapconcat_persample.launches == before  # CPU: the plain version
    torch.testing.assert_close(y, tconv.conv3d_same_persample_plain(x, w))
    with pytest.raises(ValueError, match=r"\(N,180,Co\)"):
        tconv.conv3d_tapconcat_persample_plain(x[..., :3], w.reshape(2, 180, 6))


def _spy_apply(monkeypatch, cls, calls):
    """Record the input shape of each ``cls.apply`` call."""
    orig = cls.apply
    monkeypatch.setattr(cls, "apply", staticmethod(
        lambda x, w: calls.append(tuple(x.shape)) or orig(x, w)))


def test_tapconcat_function_grads_match_jax_expert_sum(monkeypatch):
    """At the 4-lane entry conv the merged route runs
    ``TapConcatConvPerSample`` (K6 forward, K4 dW): its gradients to the
    experts and the gate logits against jax.vjp of JAX's s2d expert sum, the
    route JAX takes there (fp32)."""
    co = 4
    x, ws, logits, dy = mode_operands(("k6grad",), (1,), co)
    calls = []
    _spy_apply(monkeypatch, tmode.TapConcatConvPerSample, calls)
    ref = jax_mode(jmode.mode_conv_expert_sum_s2d_domain, x, ws, logits, dy, co)
    ours = port_mode(tmode.mode_conv_merged_s2d, x, ws, logits, dy, co)
    assert calls == [x.shape]
    assert_mode_close(ours, ref)


def test_tapconcat_dw_operands_at_entry_taps():
    """K4 takes the entry conv's dW with its kW taps packed into channels
    (Ci = 4 -> 12, padded to 16): unpacked, the same dW at taps (5,3,3)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, 4, 6, 4), generator=g, dtype=torch.float64)
    dy = torch.randn((2, 3, 4, 6, 8), generator=g, dtype=torch.float64)
    xb, dyb, kw = tconv._dw_operands(x, dy, 3)
    assert xb.shape[-1] == 16 and kw == 1
    plain = tconv.conv3d_dw_persample_plain
    torch.testing.assert_close(tconv._dw_unpack(plain(xb, dyb, 5, 3, kw), 4, 8, 3),
                               plain(x, dy, 5, 3, 3))


# ------------------------------------------------------------- the s2d net


def _capture_grads():
    """An optax transform that applies no update and keeps the gradients as
    its state, so the JAX step hands them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _port_step(cfg, sd, batch, dtype):
    net = RepModeNet(cfg.model, len(TASKS), device="cpu")
    net.load_state_dict(sd, strict=True)
    net = net.to(dtype).train()
    state = TrainState(net=net, optimizer=make_optimizer(cfg, net))
    m = make_train_step(cfg, state)(
        {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
         for k, v in batch.items()})
    return net, m


def test_s2d_train_step_matches_jax():
    """One fp32 step of the s2d net (levels 1 and 2 at mult_chan 8, depth 2;
    at mult_chan <= 4 no level-1 conv would reach K6's route) from the same
    weights on the same batch as JAX ``make_train_step`` with
    ``train_s2d=True``: JAX runs the s2d expert sum on the CPU, the port its
    merged route (K6 at the entry conv).

    Loss and per-task sums rtol 1e-5; BN running stats rtol 1e-4. JAX's fp32
    gradients on the CPU are themselves 0.8-4 % (rel L2 per tensor) from an
    fp64 evaluation of the same step, in either layout, where the port's fp32
    ones are within 4e-6: so each gradient tensor is held to the port's fp64
    step (the native layout) at rel L2 1e-4, and to JAX at the golden bounds
    of the native step test (per tensor rel L2 < 0.15 and cosine > 0.995,
    global rel L2 < 0.05)."""
    jcfg = JaxConfig(
        model=JaxModelConfig(mult_chan=8, depth=2, train_s2d=True),
        data=JaxDataConfig(adopted_datasets=TASKS),
        train=JaxTrainConfig(compute_dtype="float32", patch_size=(8, 16, 16), batch_size=2),
    )
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(5), tx=_capture_grads())
    rng = rng_for("step")
    sig = npr(rng, (2, 8, 16, 16, 1), 1.0)
    batch = {"signal": sig, "target": (0.5 * sig + 0.1).astype(np.float32),
             "task": np.array([2, 0], np.int32)}
    new_state, jm = jax_make_train_step(jcfg, donate=False, tx=_capture_grads())(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = Config(model=ModelConfig(mult_chan=8, depth=2), data=DataConfig(adopted_datasets=TASKS),
                 train=TrainConfig(compute_dtype="float32"))
    assert cfg.model.train_s2d
    sd = from_jax_variables(jax.tree.map(np.asarray, jstate.variables))
    net, m = _port_step(cfg, sd, batch, torch.float32)
    assert net.s2d_levels == (1, 2)
    net64, _ = _port_step(cfg.replace(model=ModelConfig(mult_chan=8, depth=2, train_s2d=False)),
                          sd, batch, torch.float64)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["per_task_loss_sum"].numpy(), np.asarray(jm["per_task_loss_sum"]),
                               rtol=1e-5)
    ref_grads = from_jax_variables(jax.tree.map(np.asarray, new_state.opt_state))
    grads = {k: p.grad.double().numpy() for k, p in net.named_parameters()}
    grads64 = {k: p.grad.numpy() for k, p in net64.named_parameters()}
    assert grads.keys() == ref_grads.keys() == grads64.keys() and len(grads) > 20
    ga, gb = [], []
    for k, g in grads.items():
        assert np.linalg.norm(g - grads64[k]) <= 1e-4 * np.linalg.norm(grads64[k]), k
        r = ref_grads[k].double().numpy()
        assert np.linalg.norm(g - r) < 0.15 * np.linalg.norm(r), k
        assert g.ravel() @ r.ravel() > 0.995 * np.linalg.norm(g) * np.linalg.norm(r), k
        ga.append(g.ravel())
        gb.append(r.ravel())
    ga, gb = np.concatenate(ga), np.concatenate(gb)
    assert np.linalg.norm(ga - gb) < 0.05 * np.linalg.norm(gb)
    ref_sd = from_jax_variables(jax.tree.map(np.asarray, new_state.variables))
    stats = [k for k in net.state_dict() if "running" in k]
    assert len(stats) > 20
    for k in stats:
        close(net.state_dict()[k], ref_sd[k].numpy(), 1e-4)


@pytest.mark.parametrize("impl", ["auto", "expert_sum"])
def test_s2d_net_equals_native_net(impl):
    """The s2d layout changes the execution, not the function: from the same
    weights, train-mode output, loss gradients and running stats, and the
    eval-mode output, equal the native net's (fp64)."""
    nets = {}
    for s2d_on in (False, True):
        nets[s2d_on] = RepModeNet(
            ModelConfig(mult_chan=8, depth=2, train_s2d=s2d_on, train_impl=impl), len(TASKS),
            generator=torch.Generator().manual_seed(1), device="cpu").double().train()
    x = torch.from_numpy(npr(rng_for("native"), (2, 8, 16, 16, 1), 1.0)).double()
    task = torch.tensor([0, 2])
    outs, grads, evals = {}, {}, {}
    for s2d_on, net in nets.items():
        y = net(x, task)
        (y ** 2).mean().backward()
        outs[s2d_on] = y.detach()
        grads[s2d_on] = {k: p.grad for k, p in net.named_parameters()}
        with torch.no_grad():
            evals[s2d_on] = net.eval()(x, task)
    assert nets[True].s2d_levels == (1, 2) and nets[False].s2d_levels == ()
    torch.testing.assert_close(outs[True], outs[False], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(evals[True], evals[False], rtol=1e-10, atol=1e-12)
    for k, g in grads[False].items():
        torch.testing.assert_close(grads[True][k], g, rtol=1e-9, atol=1e-12)
    sd0, sd1 = nets[False].state_dict(), nets[True].state_dict()
    for k in sd0:
        torch.testing.assert_close(sd1[k], sd0[k], rtol=1e-10, atol=1e-12)


# mult_chan 2 puts Co <= 4 at every s2d conv (2 at level 1, 4 at level 2):
# all nine take the tap-major route, as in JAX, and K6 runs nowhere
@pytest.mark.parametrize("mult_chan", [2, 8])
def test_s2d_dispatch(monkeypatch, mult_chan):
    """K6 (``TapConcatConvPerSample``) only at the 4-lane entry conv, the
    tap-major conv only at Co <= 4, ``MergedConvPerSample`` for the other s2d
    convs and the native ones; the CLI trains native, ``Config()`` in the s2d
    layout."""
    seen = {"tapconcat": [], "merged": [], "tapmajor": []}
    _spy_apply(monkeypatch, tmode.TapConcatConvPerSample, seen["tapconcat"])
    _spy_apply(monkeypatch, tmode.MergedConvPerSample, seen["merged"])
    tapmajor = tmodel.mode_conv_tapmajor_merged_s2d

    def spy_tapmajor(x2, ek, g, **kw):
        seen["tapmajor"].append(tuple(x2.shape))
        return tapmajor(x2, ek, g, **kw)

    monkeypatch.setattr(tmodel, "mode_conv_tapmajor_merged_s2d", spy_tapmajor)
    net = RepModeNet(ModelConfig(mult_chan=mult_chan, depth=2), len(TASKS), device="cpu").train()
    y = net(torch.randn((2, 8, 16, 16, 1)), torch.tensor([0, 1]))
    assert y.shape == (2, 8, 16, 16, 1)
    y.mean().backward()
    lanes = 4 * mult_chan
    if mult_chan == 8:
        assert seen["tapconcat"] == [(2, 8, 8, 8, 4)]
        assert seen["tapmajor"] == [(2, 8, 8, 8, lanes)]  # conv_out
        # 3 at level 1 (s2d), 4 at level 2 (s2d), 2 in the bottleneck (native)
        assert len(seen["merged"]) == 9
    else:
        assert seen["tapconcat"] == [] and len(seen["tapmajor"]) == 9
        assert seen["tapmajor"][0] == (2, 8, 8, 8, 4)  # the entry conv
        assert len(seen["merged"]) == 2  # the bottleneck

    assert Config().model.train_s2d
    ns = train_cli.build_parser().parse_args(["--synthetic", "--device", "cpu"])
    assert not train_cli.to_config(ns).model.train_s2d
