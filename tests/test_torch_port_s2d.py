"""The port's space-to-depth (s2d) serving routes against the JAX package's,
on the CPU, on the same numpy inputs:

  * every function of ``ops/s2d.py`` and ``conv3d_same_tapmajor`` (fp32,
    rtol 1e-5);
  * ``conv3d_dpad_plain``, the plain version of K5, against
    ``pallas_conv3d_dpad`` in interpret mode (fp32, rtol 1e-5, zero halos);
  * ``to_s2d_plain`` and ``plain_forward_s2d`` (fp32, rtol 1e-4), and
    ``plain_forward_s2d_pallas`` (bf16 on both sides, rel L2 <= 1e-2);
  * ``make_inference``'s three routes, the tiled predictor's two_phase mode
    and ``run_eval_pass`` on an s2d config.

Plain params come from the port's seeded ``RepModeNet`` (re-parameterized
once); the JAX functions get the same numbers.
"""

import functools
import logging
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repmode_tpu.config import Config as JaxConfig
from repmode_tpu.config import DataConfig as JaxDataConfig
from repmode_tpu.config import EvalConfig as JaxEvalConfig
from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.config import TrainConfig as JaxTrainConfig
from repmode_tpu.infer.predict import TiledPredictor as JaxTiledPredictor
from repmode_tpu.models import reparam as jreparam
from repmode_tpu.ops import conv3d as jconv
from repmode_tpu.ops import s2d as js2d
from repmode_tpu.ops.pallas import conv3d as jpallas
from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models import reparam
from repmode_tpu_torch.models.repmode import RepModeNet
from repmode_tpu_torch.ops import s2d
from repmode_tpu_torch.ops.conv3d import conv3d_dpad, conv3d_dpad_plain, conv3d_same_tapmajor
from repmode_tpu_torch.parallel import Mesh
from repmode_tpu_torch.train.loop import run_eval_pass

torch.set_num_threads(2)

TASKS = ("task_a", "task_b")


def npr(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def rng_for(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def t(a):
    return torch.from_numpy(np.array(a))


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def seeded_state(cfg: ModelConfig, seed: int):
    """A port net's state_dict with BN running stats that keep a random
    net's activations alive through the ReLUs."""
    net = RepModeNet(cfg, len(TASKS), generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(t(rng.uniform(-0.02, 0.02, buf.shape)))
            elif name.endswith("running_var"):
                buf.copy_(t(rng.uniform(0.02, 0.1, buf.shape)))
    return net.state_dict()


# ------------------------------------------------------------- ops/s2d.py


def _s2d_cases():
    """name -> (port function, JAX function, input shapes); inputs are
    drawn with the name as the seed and handed to both."""
    return {
        "space_to_depth_hw": (s2d.space_to_depth_hw, js2d.space_to_depth_hw, [(2, 3, 4, 6, 5)]),
        "depth_to_space_hw": (s2d.depth_to_space_hw, js2d.depth_to_space_hw, [(2, 3, 2, 3, 12)]),
        "s2d_conv_kernel_k5": (s2d.s2d_conv_kernel, js2d.s2d_conv_kernel, [(5, 5, 5, 3, 2)]),
        "s2d_conv_kernel_k3": (s2d.s2d_conv_kernel, js2d.s2d_conv_kernel, [(3, 3, 3, 2, 3)]),
        "s2d_down_kernel": (s2d.s2d_down_kernel, js2d.s2d_down_kernel, [(2, 2, 2, 3, 4)]),
        "s2d_bias": (s2d.s2d_bias, js2d.s2d_bias, [(5,)]),
        "s2d_conv1_kernel": (s2d.s2d_conv1_kernel, js2d.s2d_conv1_kernel, [(1, 1, 1, 3, 2)]),
        "box_pool_s2d_k5": (lambda x: s2d.box_pool_s2d(x, 5), lambda x: js2d.box_pool_s2d(x, 5),
                            [(2, 4, 3, 4, 8)]),
        "box_pool_s2d_k3": (lambda x: s2d.box_pool_s2d(x, 3), lambda x: js2d.box_pool_s2d(x, 3),
                            [(1, 3, 4, 2, 12)]),
        "downsample_s2d_domain": (s2d.downsample_s2d_domain, js2d.downsample_s2d_domain,
                                  [(2, 4, 3, 2, 8), (2, 1, 1, 8, 5)]),
        "downsample_s2d_domain_trim": (
            functools.partial(s2d.downsample_s2d_domain, trim_d_halo=2),
            functools.partial(js2d.downsample_s2d_domain, trim_d_halo=2),
            [(2, 8, 3, 2, 8), (2, 1, 1, 8, 5)]),
        "downsample_s2d_to_s2d": (s2d.downsample_s2d_to_s2d, js2d.downsample_s2d_to_s2d,
                                  [(2, 4, 4, 6, 8), (2, 1, 1, 8, 3)]),
        "downsample_s2d_to_s2d_trim": (
            functools.partial(s2d.downsample_s2d_to_s2d, trim_d_halo=1),
            functools.partial(js2d.downsample_s2d_to_s2d, trim_d_halo=1),
            [(1, 6, 2, 4, 4), (2, 1, 1, 4, 3)]),
        "upsample_to_s2d": (s2d.upsample_to_s2d, js2d.upsample_to_s2d,
                            [(2, 2, 3, 2, 5), (2, 2, 2, 5, 3)]),
        "upsample_s2d_to_s2d": (s2d.upsample_s2d_to_s2d, js2d.upsample_s2d_to_s2d,
                                [(2, 2, 3, 2, 12), (2, 2, 2, 3, 4)]),
    }


@pytest.mark.parametrize("name", sorted(_s2d_cases()))
def test_s2d_op_matches_jax(name):
    ours, theirs, shapes = _s2d_cases()[name]
    rng = rng_for(name)
    args = [npr(rng, s) for s in shapes]
    ref = np.asarray(theirs(*map(jnp.asarray, args)))
    out = ours(*map(t, args))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_space_to_depth_round_trips():
    x = t(npr(np.random.default_rng(0), (2, 3, 4, 6, 5)))
    torch.testing.assert_close(s2d.depth_to_space_hw(s2d.space_to_depth_hw(x)), x, rtol=0, atol=0)


@pytest.mark.parametrize("k", [3, 5])
def test_s2d_conv_equals_native_conv(k):
    """The s2d transform is exact: the s2d conv of the s2d input is the s2d
    of the native conv."""
    rng = rng_for("s2d_conv", k)
    x, w = npr(rng, (1, 3, 6, 8, 2)), npr(rng, (k, k, k, 2, 3))
    native = reparam.conv3d_same(t(x), t(w))
    y2 = reparam.conv3d_same(s2d.space_to_depth_hw(t(x)), s2d.s2d_conv_kernel(t(w)))
    np.testing.assert_allclose(s2d.depth_to_space_hw(y2).numpy(), native.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_conv3d_same_tapmajor_matches_jax(cdt):
    """fp32 within 1e-5. bf16: z is rounded to bf16 once on both sides,
    after sums taken in another order, so rel L2 <= 1e-2."""
    rng = rng_for("tapmajor", cdt)
    x, w = npr(rng, (2, 3, 4, 6, 8)), npr(rng, (5, 3, 3, 8, 4))
    jcd, tcd = (None, None) if cdt == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jconv.conv3d_same_tapmajor(jnp.asarray(x), jnp.asarray(w), compute_dtype=jcd))
    out = conv3d_same_tapmajor(t(x), t(w), compute_dtype=tcd)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    if cdt == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        assert rel_l2(out.numpy(), ref) <= 1e-2


# ---------------------------------------------------- K5's plain version


def _dpad_ref(xp, w, b, relu=True):
    return np.asarray(jpallas.pallas_conv3d_dpad(
        jnp.asarray(xp), jnp.asarray(w), None if b is None else jnp.asarray(b), relu=relu,
        compute_dtype=jnp.float32, out_dtype=jnp.float32, interpret=True))


def _assert_zero_halo(y, pd):
    assert np.all(y[:, :pd] == 0.0) and np.all(y[:, -pd:] == 0.0)


@pytest.mark.parametrize("case", [
    (3, 2, 4, 8, 8, 8, 16, True),
    (5, 2, 4, 8, 8, 8, 16, True),
    (5, 1, 3, 4, 6, 8, 8, False),
    (3, 1, 2, 4, 4, 128, 128, True),
])
def test_conv3d_dpad_plain_matches_pallas(case):
    """(kd, N, D, H, W, Ci, Co, bias+ReLU): the plain version equals the
    Pallas kernel in interpret mode (fp32) within 1e-5, halo rows exactly 0."""
    kd, n, d, h, w, ci, co, act = case
    pd = (kd - 1) // 2
    rng = rng_for("dpad", case)
    x = npr(rng, (n, d, h, w, ci))
    wk = npr(rng, (kd, 3, 3, ci, co), 1.0 / np.sqrt(kd * 9 * ci))
    b = npr(rng, (co,)) if act else None
    xp = np.pad(x, ((0, 0), (pd, pd), (0, 0), (0, 0), (0, 0)))
    ref = _dpad_ref(xp, wk, b, relu=act)
    out = conv3d_dpad_plain(t(xp), t(wk), None if b is None else t(b), relu=act)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    _assert_zero_halo(out.numpy(), pd)


def test_conv3d_dpad_chain_matches_pallas():
    """Two chained convs, the second reading the first's padded output."""
    rng = rng_for("dpad_chain")
    x = npr(rng, (1, 4, 8, 8, 8))
    w1, b1 = npr(rng, (5, 3, 3, 8, 16), 0.1), npr(rng, (16,))
    w2, b2 = npr(rng, (5, 3, 3, 16, 8), 0.1), npr(rng, (8,))
    xp = np.pad(x, ((0, 0), (2, 2), (0, 0), (0, 0), (0, 0)))
    ref = _dpad_ref(_dpad_ref(xp, w1, b1), w2, b2)
    y1 = conv3d_dpad(t(xp), t(w1), t(b1), relu=True)
    out = conv3d_dpad(y1, t(w2), t(b2), relu=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    _assert_zero_halo(out.numpy(), 2)
    # the chain's interior is the 'same' conv chain
    same = reparam.conv3d_same(reparam.conv3d_same(t(x), t(w1), t(b1), relu=True), t(w2), t(b2),
                               relu=True)
    np.testing.assert_allclose(out[:, 2:-2].numpy(), same.numpy(), rtol=1e-5, atol=1e-5)


def test_conv3d_dpad_on_cpu_runs_the_plain_version_in_the_compute_dtype():
    rng = rng_for("dpad_cpu")
    xp = np.pad(npr(rng, (1, 2, 4, 4, 8)), ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
    wk, b = npr(rng, (3, 3, 3, 8, 8)), npr(rng, (8,))
    before = conv3d_dpad.launches
    y = conv3d_dpad(t(xp), t(wk), t(b), relu=True, compute_dtype=torch.bfloat16)
    ref = conv3d_dpad_plain(t(xp), t(wk), t(b), relu=True, compute_dtype=torch.bfloat16,
                            out_dtype=torch.bfloat16)
    assert conv3d_dpad.launches == before  # no kernel on the CPU
    assert y.dtype == torch.bfloat16 and torch.equal(y, ref)


# ------------------------------------------------- the XLA s2d route (K1)


@pytest.fixture(scope="module")
def small_plain():
    """Plain native params of a mult_chan 2, depth 3 net (task 1) and an input."""
    cfg = ModelConfig(mult_chan=2, depth=3)
    plain = reparam.reparameterize(seeded_state(cfg, 11), cfg, len(TASKS), 1)
    x = npr(np.random.default_rng(12), (2, 8, 16, 16, 1), 1.0)
    return cfg, plain, x


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("levels", [(1,), (1, 2), (1, 2, 3)])
def test_plain_forward_s2d_matches_jax(small_plain, levels):
    """to_s2d_plain leaf by leaf, and the XLA s2d route in fp32 within 1e-4,
    against the JAX functions and against the port's native route."""
    cfg, plain, x = small_plain
    jcfg = JaxModelConfig(mult_chan=2, depth=3)
    jplain2 = jreparam.to_s2d_plain(to_jax(plain), jcfg, levels)
    plain2 = reparam.to_s2d_plain(plain, cfg, levels)
    ours, theirs = _flat(plain2), _flat(jplain2)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=1e-6, err_msg=k)

    ref = np.asarray(jreparam.plain_forward_s2d(jplain2, jnp.asarray(x), jcfg, levels))
    y = reparam.plain_forward_s2d(plain2, t(x), cfg, levels)
    assert y.dtype == torch.float32 and tuple(y.shape) == ref.shape
    assert np.std(ref) > 1e-3
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-5)
    native = reparam.plain_forward(plain, t(x), cfg)
    np.testing.assert_allclose(y.numpy(), native.numpy(), rtol=1e-4, atol=1e-5)


def test_default_s2d_levels_match_jax():
    for mc, depth in ((32, 4), (2, 4), (64, 3), (16, 2)):
        assert reparam.default_s2d_levels(ModelConfig(mult_chan=mc, depth=depth)) == \
            jreparam.default_s2d_levels(JaxModelConfig(mult_chan=mc, depth=depth))


# ------------------------------------------------- the K5 route (mult_chan 32)

WIDE = ModelConfig(mult_chan=32, depth=2)
WIDE_PATCH = (8, 16, 16)


@pytest.fixture(scope="module")
def wide_routes():
    """mult_chan 32, depth 2, s2d levels (1, 2) at 128 and 256 channels:
    the K5 route of both packages in bf16 (JAX's Pallas kernel in interpret
    mode), the port's XLA s2d and native routes, and the port's calls of
    conv3d_dpad and conv3d_same on its K5 route."""
    state = seeded_state(WIDE, 21)
    plain = reparam.reparameterize(state, WIDE, len(TASKS), 1)
    levels = reparam.default_s2d_levels(WIDE)
    plain2 = reparam.to_s2d_plain(plain, WIDE, levels)
    x = npr(np.random.default_rng(22), (2, *WIDE_PATCH, 1), 1.0)
    jcfg = JaxModelConfig(mult_chan=32, depth=2)
    interp = functools.partial(jpallas.pallas_conv3d_dpad, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpallas, "pallas_conv3d_dpad", interp)
        ref = np.asarray(jreparam.plain_forward_s2d_pallas(
            to_jax(plain2), jnp.asarray(x), jcfg, levels, compute_dtype=jnp.bfloat16))
    calls = {"conv3d_dpad": 0, "conv3d_same": 0}

    def counted(name):
        fn = getattr(reparam, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(reparam, name, counted(name))
        y = reparam.plain_forward_s2d_pallas(plain2, t(x), WIDE, levels,
                                             compute_dtype=torch.bfloat16)
    y_xla = reparam.plain_forward_s2d(plain2, t(x), WIDE, levels, compute_dtype=torch.bfloat16)
    y_native = reparam.plain_forward(plain, t(x), WIDE, compute_dtype=torch.bfloat16)
    return dict(levels=levels, ref=ref, y=y, y_xla=y_xla, y_native=y_native, calls=calls,
                state=state)


def test_plain_forward_s2d_pallas_matches_jax(wide_routes):
    r = wide_routes
    assert r["levels"] == (1, 2)
    assert r["y"].dtype == torch.float32 and tuple(r["y"].shape) == r["ref"].shape
    assert np.std(r["ref"]) > 1e-3
    assert rel_l2(r["y"].numpy(), r["ref"]) <= 1e-2


def test_plain_forward_s2d_pallas_routes_convs_to_k5(wide_routes):
    """Every chained s2d conv is one conv3d_dpad call (enc1.conv2, enc2 x2,
    dec2 x2, dec1 x2); encoder_block1.conv1, the bottleneck and conv_out
    are conv3d_same calls."""
    assert wide_routes["calls"] == {"conv3d_dpad": 7, "conv3d_same": 4}


@pytest.mark.parametrize("other", ["y_xla", "y_native"])
def test_s2d_routes_agree_in_bf16(wide_routes, other):
    bound = 1e-2 if other == "y_xla" else 2e-2
    assert rel_l2(wide_routes["y"].numpy(), wide_routes[other].numpy()) <= bound


# ------------------------------------------------------------ make_inference


def _cfg(model, **eval_kw):
    return Config(model=model, data=DataConfig(adopted_datasets=TASKS),
                  train=TrainConfig(batch_size_eval=2, compute_dtype="float32"),
                  eval=EvalConfig(**eval_kw))


@pytest.mark.parametrize("route", [
    (dict(s2d=False), "plain_forward"),
    (dict(s2d=True), "plain_forward_s2d"),
    (dict(s2d=True, pallas_conv=True), "plain_forward_s2d_pallas"),
    (dict(s2d=False, pallas_conv=True), "plain_forward"),
])
def test_make_inference_routes(route):
    eval_kw, name = route
    prepare, forward = reparam.make_inference(_cfg(WIDE, **eval_kw))
    assert forward.func is getattr(reparam, name)
    plain = prepare(seeded_state(WIDE, 3), 0)
    s2d_on = name != "plain_forward"
    assert plain["encoder_block1"]["conv2_w"].shape == ((5, 3, 3, 128, 128) if s2d_on
                                                         else (5, 5, 5, 32, 32))


def test_make_inference_geometry_takes_the_xla_s2d_route(small_plain, caplog):
    """pallas_conv=True with a geometry K5 does not take (mult_chan % 32)
    logs a warning and takes the XLA s2d route, as in the JAX package."""
    cfg, _, x = small_plain
    assert not reparam.pallas_geometry_ok(cfg)
    assert reparam.pallas_geometry_ok(WIDE)
    assert not reparam.pallas_geometry_ok(ModelConfig(mult_chan=32, kernel_size=3))
    with caplog.at_level(logging.WARNING, logger="repmode_tpu_torch"):
        prepare, forward = reparam.make_inference(_cfg(cfg, s2d=True, pallas_conv=True))
    assert forward.func is reparam.plain_forward_s2d
    assert any("taking the XLA s2d route" in r.message for r in caplog.records)
    # the pair runs: s2d params in, the native route's function out
    state = seeded_state(cfg, 11)
    y = forward(prepare(state, 1), t(x))
    ref = reparam.plain_forward(reparam.reparameterize(state, cfg, len(TASKS), 1), t(x), cfg)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- the tiled predictor


@pytest.fixture(scope="module")
def predictor_case():
    cfg = ModelConfig(mult_chan=2, depth=2)
    state = seeded_state(cfg, 31)
    vol = np.random.default_rng(32).standard_normal((16, 24, 24)).astype(np.float32)
    return cfg, state, vol


@pytest.mark.parametrize("s2d_on", [False, True])
def test_two_phase_equals_fused(predictor_case, s2d_on):
    cfg, state, vol = predictor_case
    c = _cfg(cfg, s2d=s2d_on, patch_size=(16, 16, 16))
    prepare, _ = reparam.make_inference(c)
    plain = prepare(state, 0)
    fused = TiledPredictor(c, device="cpu")(plain, vol)
    two = TiledPredictor(c, device="cpu", mode="two_phase")(plain, vol)
    assert torch.equal(fused, two)


def test_two_phase_matches_jax(predictor_case):
    """The port's two_phase predictor on the XLA s2d route against JAX's
    TiledPredictor(mode='two_phase') with s2d=True, fp32, within 1e-4."""
    cfg, state, vol = predictor_case
    kw = dict(s2d=True, predictor="two_phase", patch_size=(16, 16, 16))
    c = _cfg(cfg, **kw)
    jc = JaxConfig(model=JaxModelConfig(mult_chan=2, depth=2, train_s2d=False),
                   data=JaxDataConfig(adopted_datasets=TASKS),
                   train=JaxTrainConfig(batch_size_eval=2, compute_dtype="float32"),
                   eval=JaxEvalConfig(**kw))
    plain = reparam.reparameterize(state, cfg, len(TASKS), 1)
    levels = jreparam.default_s2d_levels(jc.model)
    ref = np.asarray(JaxTiledPredictor(jc)(jreparam.to_s2d_plain(to_jax(plain), jc.model, levels),
                                           jnp.asarray(vol)))
    pred = TiledPredictor(c, device="cpu")
    assert pred.mode == "two_phase"
    out = pred(reparam.make_inference(c)[0](state, 1), vol)
    assert np.std(ref) > 1e-3
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_predictor_refuses_unknown_mode_and_mesh():
    c = _cfg(ModelConfig(mult_chan=2, depth=2), s2d=False)
    with pytest.raises(ValueError, match="mode"):
        TiledPredictor(c, device="cpu", mode="scan")
    # two_phase takes a mesh (and pads the batch count to its size); fused does not
    mesh = Mesh(1, 2, torch.device("cpu"), None)
    pred = TiledPredictor(c, device="cpu", mode="two_phase", mesh=mesh)
    starts, valid, n = pred.grid((32, 192, 128))  # 2 patches: 1 batch, padded to 2
    assert pred.mesh is mesh and n == 2 and starts.shape[0] == 2 and valid[1].sum() == 0
    with pytest.raises(ValueError, match="two_phase predictor only"):
        TiledPredictor(c, device="cpu", mode="fused", mesh=mesh)


def test_predictor_takes_a_forward_fn(predictor_case):
    cfg, state, vol = predictor_case
    c = _cfg(cfg, s2d=False, patch_size=(16, 16, 16))
    seen = []

    def forward(plain, x):
        seen.append(tuple(x.shape))
        return reparam.plain_forward(plain, x, cfg)

    plain = reparam.reparameterize(state, cfg, len(TASKS), 0)
    y = TiledPredictor(c, device="cpu", forward_fn=forward)(plain, vol)
    assert seen == [(2, 16, 16, 16, 1)] * 2
    torch.testing.assert_close(y, TiledPredictor(c, device="cpu")(plain, vol), rtol=0, atol=0)


# ---------------------------------------------------------- run_eval_pass


@pytest.mark.parametrize("route", ["xla_s2d", "k5"])
def test_run_eval_pass_on_s2d_routes(wide_routes, route):
    """The eval entry point on an s2d config (fp32 XLA s2d route; the K5
    route, bf16 by construction) gives the native route's metrics: MSE
    within 1e-4 (fp32) or 2e-2 relative (bf16)."""
    store = synthetic_store(TASKS, volumes_per_task=1, vol_shape=(8, 16, 24), seed=5)
    state = wide_routes["state"]

    def run(**eval_kw):
        c = Config(model=WIDE, data=DataConfig(adopted_datasets=TASKS),
                   train=TrainConfig(batch_size_eval=2, compute_dtype="float32"),
                   eval=EvalConfig(patch_size=WIDE_PATCH, **eval_kw))
        return run_eval_pass(c, state, store, TiledPredictor(c, device="cpu"), "test")[0]

    native = run(s2d=False)
    log = run(s2d=True, pallas_conv=route == "k5")
    for ds in TASKS:
        a, b = log[f"metric_test_MSE/{ds}"], native[f"metric_test_MSE/{ds}"]
        assert np.isfinite(a)
        if route == "xla_s2d":
            np.testing.assert_allclose(a, b, rtol=1e-4)
        else:
            assert abs(a - b) <= 2e-2 * abs(b)
