"""The port's measurement entry points (``bench_torch.serve``,
``bench_torch.train``, ``bench_torch.profile``) on the CPU, against the JAX
package's benchmarks (``bench.py``, ``tools/bench_train.py``).

Tiny size: mult_chan 2, depth 2, a 16x64x96 volume, 16x32x32 patches, batch
2. The records hold every key of the JAX records (device figures None on the
CPU); the FLOP integers and the seeded inputs equal the JAX benches'; the
serving prediction of the native and XLA s2d routes equals JAX's
``TiledPredictor`` (fp32, rel L2 <= 1e-4) and the first-step loss of both
layouts JAX's ``make_train_step`` (fp32, rtol 1e-5), from the same weights
carried across with ``from_jax_variables``; the timed calls chain and
alternate as the protocols say; without a card the entry points raise.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from bench_torch import common, profile, serve, train
from repmode_tpu.compat.torch_import import convert_state_dict
from repmode_tpu.config import Config as JaxConfig
from repmode_tpu.config import EvalConfig as JaxEvalConfig
from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.config import TrainConfig as JaxTrainConfig
from repmode_tpu.infer.predict import TiledPredictor as JaxTiledPredictor
from repmode_tpu.models.reparam import make_inference as jax_make_inference
from repmode_tpu.train.state import TrainState as JaxTrainState
from repmode_tpu.train.state import make_optimizer as jax_make_optimizer
from repmode_tpu.train.step import make_train_step as jax_make_train_step
from repmode_tpu.utils import flops as jax_flops
from repmode_tpu_torch.compat.weights import from_jax_variables
from repmode_tpu_torch.config import ModelConfig

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--mult_chan", "2", "--depth", "2", "--patch", "16,32,32",
        "--batch", "2"]
VOL = (16, 64, 96)
PATCH = (16, 32, 32)
CPU = common.device_record("cpu")

SERVE_KEYS = {
    # bench.py's
    "metric", "value", "unit", "vs_baseline", "volume_shape", "seconds_per_volume",
    "model_flops_per_volume", "flops_per_voxel_effective", "tiling_redundancy",
    "tflops_effective", "device_kind", "device_peak_bf16_tflops", "mfu", "baseline_v100_voxps",
    "baseline_method",
    # the port's
    "route", "predictor", "power_limit_w", "times_s", "n_timed", "p25_s", "p75_s",
    "prepare_seconds", "first_call_seconds", "rel_l2_vs_native", "peak_memory_gb",
}
TRAIN_KEYS = {
    # BENCH_TRAIN.json's, less its TPU artefacts (env, ab_chain)
    "batch", "patch", "remat", "train_impl", "device", "ms_per_step", "train_voxels_per_s",
    "ms_per_step_pipelined", "train_voxels_per_s_pipelined", "model_flops_per_step",
    "tflops_effective", "device_peak_bf16_tflops", "mfu", "baseline_v100_train_voxps",
    "baseline_v100_train_range", "vs_baseline_train", "baseline_method",
    # the port's
    "layout", "power_limit_w", "times_ms", "n_timed", "peak_memory_gb", "switches",
}


def records(capsys, main, argv):
    assert main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def tiny_model(**kw):
    return ModelConfig(mult_chan=2, depth=2, **kw)


# ------------------------------------------------------------------ records


def test_serve_records_hold_bench_pys_keys(capsys):
    recs = records(capsys, serve.main, TINY + ["--volume", "16,64,96", "--reps", "1",
                                              "--rounds", "1"])
    assert [r["route_requested"] for r in recs] == ["native", "s2d", "k5"]
    # at mult_chan 2 K5's geometry guard sends the k5 route down the XLA s2d route
    assert [r["route"] for r in recs] == ["native", "s2d", "s2d"]
    for r in recs:
        assert SERVE_KEYS <= set(r), SERVE_KEYS - set(r)
        assert r["device_kind"] == "cpu"
        assert r["mfu"] is None and r["device_peak_bf16_tflops"] is None
        assert r["power_limit_w"] is None and r["peak_memory_gb"] is None
        assert r["volume_shape"] == list(VOL) and r["n_timed"] == 1
        assert r["value"] == pytest.approx(np.prod(VOL) / r["seconds_per_volume"])
        assert r["rel_l2_vs_native"] <= 1e-2
    assert recs[0]["rel_l2_vs_native"] == 0.0


def test_train_records_hold_bench_trains_keys(capsys, tmp_path):
    out = tmp_path / "train.jsonl"
    recs = records(capsys, train.main, TINY + ["--steps", "1", "--rounds", "1", "--decomp",
                                              "--out", str(out)])
    assert [(r["layout"], r["train_impl"]) for r in recs] == [("native", "auto"), ("s2d", "auto")]
    for r in recs:
        assert TRAIN_KEYS <= set(r), TRAIN_KEYS - set(r)
        assert r["device"] == "cpu"
        assert r["mfu"] is None and r["device_peak_bf16_tflops"] is None
        assert r["power_limit_w"] is None and r["peak_memory_gb"] is None
        assert r["batch"] == 2 and r["patch"] == list(PATCH) and r["n_timed"] == 1
        assert r["switches"]["train_s2d"] == (r["layout"] == "s2d")
        assert {"fwd_only_ms", "fwd_bwd_ms"} <= set(r)
        assert r["loss_rel_vs_expert_sum"] <= 1e-2
    assert [json.loads(line) for line in out.read_text().splitlines()] == recs


# ------------------------------------------------------- FLOPs and inputs


def test_flops_equal_jax_at_the_tiny_size(capsys):
    sr = records(capsys, serve.main, TINY + ["--volume", "16,64,96", "--reps", "1",
                                            "--rounds", "1", "--routes", "native"])[0]
    tr = records(capsys, train.main, TINY + ["--steps", "1", "--rounds", "1",
                                            "--layouts", "native"])[0]
    jm = JaxModelConfig(mult_chan=2, depth=2)
    want = jax_flops.tiled_inference_flops(jm, VOL, PATCH)
    assert sr["model_flops_per_volume"] == want["total_flops"]
    assert sr["tiling_redundancy"] == want["redundancy"]
    assert tr["model_flops_per_step"] == 3 * 2 * jax_flops.inference_flops_per_patch(jm, PATCH)


def test_full_width_flops_are_the_benches():
    """BENCH_r05.json's model_flops_per_volume, BENCH_TRAIN.json's
    model_flops_per_step."""
    assert serve.volume_flops(serve.bench_config(), serve.VOL_SHAPE)["total_flops"] \
        == 137637931253760
    assert train.step_flops(train.bench_config(), 8, train.PATCH) == 26216748810240
    assert serve.VOL_SHAPE == jax_bench.VOL_SHAPE


def test_seeded_volume_is_bench_pys():
    ours = serve.seeded_volume()
    rng = np.random.default_rng(0)  # bench.py:83-84
    ref = rng.standard_normal(jax_bench.VOL_SHAPE).astype(np.float32)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_seeded_batch_is_bench_trains():
    ours = train.seeded_batch()
    rng = np.random.default_rng(0)  # tools/bench_train.py:74-84
    n, patch = 8, (32, 128, 128)
    ref = {
        "signal": jnp.asarray(rng.standard_normal((n,) + patch + (1,)), jnp.float32),
        "target": jnp.asarray(rng.standard_normal((n,) + patch + (1,)), jnp.float32),
        "task": jnp.asarray(rng.integers(0, 12, n), jnp.int32),
    }
    for k, v in ref.items():
        v = np.asarray(v)
        assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k


# ------------------------------------------------------- the slice vs JAX


@pytest.fixture(scope="module")
def jax_variables():
    """JAX variables of a seeded tiny net, BN running stats drawn so the
    prediction is not flat; the port gets them through from_jax_variables."""
    gen = torch.Generator().manual_seed(3)
    sd = serve.seeded_state_dict(serve.bench_config(model=tiny_model()), 3, "cpu")
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_((torch.rand(v.shape, generator=gen) - 0.5) * 0.04)
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) * 0.08 + 0.02)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()})


@pytest.mark.parametrize("route", ["native", "s2d"])
def test_serve_prediction_matches_jax(jax_variables, route):
    cfg = serve.bench_config(batch=2, model=tiny_model(), patch=PATCH, compute_dtype="float32")
    volume = serve.seeded_volume(VOL, 1)
    runs, recs, failures = serve.measure(cfg, from_jax_variables(jax_variables), volume,
                                         [route], 1, 1, CPU)
    assert not failures and recs[0]["route"] == route
    jcfg = JaxConfig(model=JaxModelConfig(mult_chan=2, depth=2),
                     train=JaxTrainConfig(batch_size_eval=2, compute_dtype="float32"),
                     eval=JaxEvalConfig(s2d=route == "s2d", patch_size=PATCH))
    prepare, forward = jax_make_inference(jcfg)
    ref = np.asarray(JaxTiledPredictor(jcfg, forward_fn=forward)(
        prepare(jax_variables, serve.TASK_ID), jnp.asarray(volume)), np.float64)
    ours = runs[route].first.double().numpy()
    assert ours.shape == VOL and np.std(ref) > 1e-3
    assert np.linalg.norm(ours - ref) <= 1e-4 * np.linalg.norm(ref)


@pytest.mark.parametrize("layout", ["native", "s2d"])
def test_train_first_loss_matches_jax(jax_variables, layout):
    cfg = train.bench_config(batch=2, patch=PATCH, model=tiny_model(), compute_dtype="float32")
    batch = train.seeded_batch(2, PATCH, 0)
    runs, recs, failures = train.measure(cfg, from_jax_variables(jax_variables), batch,
                                         [(layout, "auto")], 1, 1, CPU)
    assert not failures and recs[0]["layout"] == layout
    jcfg = JaxConfig(model=JaxModelConfig(mult_chan=2, depth=2, train_s2d=layout == "s2d"),
                     train=JaxTrainConfig(batch_size=2, patch_size=PATCH,
                                          compute_dtype="float32"))
    tx = jax_make_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, jax_variables["params"])
    state = JaxTrainState(params=params,
                          batch_stats=jax.tree.map(jnp.asarray, jax_variables["batch_stats"]),
                          opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                          epoch=jnp.zeros((), jnp.int32))
    _, jm = jax_make_train_step(jcfg, donate=False, tx=tx)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(runs[(layout, "auto")].first_loss, float(jm["loss"]), rtol=1e-5)


# ------------------------------------------------------------------ protocols


def test_serve_feeds_each_call_the_previous_output(monkeypatch, capsys):
    calls = []

    class Spy(serve.TiledPredictor):
        def __call__(self, params, volume):
            out = super().__call__(params, volume)
            # the fed-back tensor is already where the predictor puts it
            assert volume.to(self.device, torch.float32) is volume
            calls.append((self.cfg.eval.pallas_conv, self.cfg.eval.s2d, volume, out))
            return out

    monkeypatch.setattr(serve, "TiledPredictor", Spy)
    reps, rounds = 2, 3
    recs = records(capsys, serve.main, TINY + ["--volume", "16,64,96", "--reps", str(reps),
                                              "--rounds", str(rounds)])
    assert [r["n_timed"] for r in recs] == [reps * rounds] * 3
    assert all(len(r["times_s"]) == reps * rounds for r in recs)
    names = {(False, False): "native", (False, True): "s2d", (True, True): "k5"}
    order = [names[c[:2]] for c in calls]
    # round 0: each route's warm-up then its timed calls; then reversed turns
    fwd, back = ["native", "s2d", "k5"], ["k5", "s2d", "native"]
    want = [r for r in fwd for _ in range(reps + 1)]
    for i in range(1, rounds):
        want += [r for r in (back if i % 2 else fwd) for _ in range(reps)]
    assert order == want
    seeded = calls[0][2]
    for route in fwd:
        mine = [c for c, name in zip(calls, order) if name == route]
        assert torch.equal(mine[0][2], seeded)  # the warm-up: the seeded volume
        for prev, cur in zip(mine, mine[1:]):
            assert cur[2] is prev[3]  # each later call: the previous output


def test_train_pairs_run_in_turns(monkeypatch, capsys):
    seen = []
    make = train.make_train_step

    def spy_make(cfg, state, mesh=None):
        step = make(cfg, state, mesh)
        name = ("s2d" if cfg.model.train_s2d else "native", cfg.model.train_impl)

        def spy(batch):
            seen.append(name)
            return step(batch)

        return spy

    monkeypatch.setattr(train, "make_train_step", spy_make)
    steps, rounds = 1, 3
    recs = records(capsys, train.main, TINY + ["--steps", str(steps), "--rounds", str(rounds),
                                              "--train_impl", "expert_sum,auto",
                                              "--layouts", "native"])
    pairs = [("native", "expert_sum"), ("native", "auto")]
    assert [(r["layout"], r["train_impl"]) for r in recs] == pairs
    assert all(r["n_timed"] == steps * rounds and len(r["times_ms_pipelined"]) == rounds
               for r in recs)
    want = []  # a turn: one untimed step, then both protocols' steps
    for i in range(rounds):
        want += [p for p in (pairs[::-1] if i % 2 else pairs) for _ in range(1 + 2 * steps)]
    assert seen == want


@pytest.mark.parametrize("entry,limits", [(serve, "LIMITS"), (train, "LOSS_RTOL")])
def test_a_missed_check_prints_no_record_and_fails(monkeypatch, capsys, entry, limits):
    if entry is serve:
        monkeypatch.setitem(serve.LIMITS, "s2d", 0.0)
        argv = TINY + ["--volume", "16,64,96", "--reps", "1", "--rounds", "1",
                       "--routes", "native,s2d"]
    else:
        monkeypatch.setattr(train, "LOSS_RTOL", 0.0)
        argv = TINY + ["--steps", "1", "--rounds", "1", "--layouts", "native",
                       "--train_impl", "expert_sum,auto"]
    assert entry.main(argv) == 1
    out = capsys.readouterr()
    recs = [json.loads(line) for line in out.out.splitlines()]
    # the reference (native; native expert_sum) passes its own check, the other not
    assert len(recs) == 1 and "limit" in out.err
    assert recs[0].get("route", recs[0].get("train_impl")) in ("native", "expert_sum")


@pytest.mark.parametrize("entry", [serve, train])
def test_without_a_card_the_entry_points_raise(monkeypatch, capsys, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main([])
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------ profile


@pytest.mark.parametrize("entry", [serve, train])
def test_profile_on_the_cpu(capsys, tmp_path, entry):
    argv = TINY + ["--rounds", "1", "--profile", str(tmp_path)]
    argv += (["--volume", "16,64,96", "--reps", "1", "--routes", "native"] if entry is serve
             else ["--steps", "1", "--layouts", "native", "--train_impl", "expert_sum"])
    recs = records(capsys, entry.main, argv)
    assert len(recs) == 2 and "profile" in recs[1]
    prof = recs[1]
    traces = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert traces == [prof["trace"]]
    assert json.load(open(traces[0]))["traceEvents"]
    assert prof["device_busy_share"] == prof["top_kernels"] == profile.NOT_MEASURED
    assert all(b == {"ms": profile.NOT_MEASURED, "launches": profile.NOT_MEASURED}
               for b in prof["buckets"].values())
    assert prof["top_host_ops"] and prof["wall_ms"] > 0


def test_busy_time_is_the_union_of_kernel_intervals():
    assert profile.busy_ms([(0, 1000), (500, 1500), (2000, 2500), (2100, 2200)]) == 2.0
    assert profile.busy_ms([]) == 0.0


@pytest.mark.parametrize("name,want", [
    ("void conv3d_same_kernel_wgmma<2, 1, 32, 128>(ConvParams, CUtensorMap, CUtensorMap)", "K1"),
    ("void conv3d_same_kernel<64, 32>(ConvParams)", "K1"),
    ("void conv3d_persample_kernel_wgmma<1, 2, 32, 64, false>(PsParams, CUtensorMap)", "K2"),
    ("void conv3d_persample_kernel_wgmma<1, 2, 32, 64, true>(PsParams, CUtensorMap)", "K3"),
    ("void conv3d_dw_kernel_wgmma<3, 2, 64>(DwParams, CUtensorMap, CUtensorMap)", "K4"),
    ("sum_partials_kernel(float const*, float*, long long, int)", "K4"),
    ("void conv3d_dpad_kernel_wgmma<2>(DpadParams, CUtensorMap, CUtensorMap)", "K5"),
    ("void conv3d_tapconcat_kernel_wgmma<128>(TcwParams, CUtensorMap)", "K6"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc_kcsrt_ndhwc", "cuDNN"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc", "cuDNN"),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NTT", "GEMMs"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMMs"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
     "(anonymous namespace)::TensorListMetadata<2>, BinaryOpListAlphaFunctor<float> >", "optimizer"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda(float)#1}>", "copies"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MeanOps<float> > >",
     "BN"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::clamp_min_scalar_kernel>",
     "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("some_other_kernel", "other"),
])
def test_profile_buckets_by_kernel_name(name, want):
    assert profile.bucket(name).startswith(want)
