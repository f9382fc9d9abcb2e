"""The port's data parallelism on the CPU against the JAX package: two gloo
ranks (``parallel.launch``, a ``file://`` rendezvous) against one rank and
against JAX's 2-device mesh (the conftest's virtual CPU devices). mult_chan
2, depth 2, 8x16x16 patches, a global batch of 8, fp32.

  * sync-BN over a split batch against ``batch_norm_train`` on the whole
    batch: output, running stats, input and affine gradients (native and
    ``phases=4``);
  * two train steps against the port's one-rank steps and JAX's
    ``make_train_step`` on ``make_mesh(2)``; both ranks' parameters
    bit-equal; ``remat``; the UNet;
  * ``PatchSampler.epoch(pad_tail_to_batch=True)`` against JAX's, and the
    ranks' slices of a host batch;
  * the sharded ``two_phase`` predictor: its grid against JAX's mesh grid,
    its volume against the one-rank ``fused`` one and JAX's mesh predictor,
    each rank predicting its own block of batches.

The ranks run ``test_torch_port_dp_ranks.rank_checks`` (that module imports
no JAX, so a rank starts quickly), all checks in one launch: a module
fixture, read by the tests below.
"""

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
from repmode_tpu.data.sampler import PatchSampler as JaxPatchSampler
from repmode_tpu.data.synthetic import synthetic_store as jax_synthetic_store
from repmode_tpu.infer.predict import TiledPredictor as JaxTiledPredictor
from repmode_tpu.models.reparam import reparameterize as jax_reparameterize
from repmode_tpu.parallel import make_mesh as jax_make_mesh
from repmode_tpu.parallel import replicate as jax_replicate
from repmode_tpu.parallel import shard_batch as jax_shard_batch
from repmode_tpu.train.state import create_train_state as jax_create_train_state
from repmode_tpu.train.step import make_train_step as jax_make_train_step
from repmode_tpu_torch.compat.weights import from_jax_variables
from repmode_tpu_torch.data.sampler import PatchSampler
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models.reparam import make_inference
from repmode_tpu_torch.parallel import Mesh, launch, shard_batch
from test_torch_port_dp_ranks import (
    BATCH, EVAL_BATCH, PATCH, STEPS, TASKS, VOL, bn_case, make_batch, port_config, rank_checks,
    train_steps)

torch.set_num_threads(2)


def jax_config():
    return JaxConfig(model=JaxModelConfig(mult_chan=2, depth=2, train_s2d=False),
                     data=JaxDataConfig(adopted_datasets=TASKS),
                     train=JaxTrainConfig(batch_size=BATCH, patch_size=PATCH,
                                          compute_dtype="float32", batch_size_eval=EVAL_BATCH),
                     eval=JaxEvalConfig(patch_size=PATCH, s2d=False))


def serving_variables(jax_state):
    """The initial weights with random BN statistics (running var 0.02-0.1),
    so the eval-mode net's output is not near zero (test_torch_port_serve's
    rule)."""
    variables = jax.tree.map(np.asarray, jax_state.variables)
    rng = np.random.default_rng(2)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(*((-0.02, 0.02) if "mean" in jax.tree_util.keystr(p)
                                   else (0.02, 0.1)), a.shape).astype(np.float32),
        variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def jax_state():
    return jax_create_train_state(jax_config(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def dp(tmp_path_factory, jax_state):
    """The inputs and both ranks' results of ``rank_checks``."""
    rng = np.random.default_rng(0)
    bn = {}
    for phases in (1, 4):
        x = (rng.standard_normal((BATCH, 4, 6, 6, 3 * phases)) * 2 + 0.7).astype(np.float32)
        bn[phases] = (x, rng.standard_normal(x.shape).astype(np.float32))
    payload = {"bn": bn, "batch": make_batch(),
               "sd": {k: v.numpy() for k, v in
                      from_jax_variables(jax.tree.map(np.asarray, jax_state.variables)).items()},
               "serve_sd": {k: v.numpy() for k, v in
                            from_jax_variables(serving_variables(jax_state)).items()},
               "vol": np.random.default_rng(7).standard_normal(VOL).astype(np.float32)}
    rdv = tmp_path_factory.mktemp("dp") / "rendezvous"
    ranks = launch(rank_checks, 2, "cpu", "gloo", args=(payload,),
                   init_method=f"file://{rdv}", timeout_s=600)
    assert [r["rank"] for r in ranks] == [0, 1]
    return payload, ranks


# ------------------------------------------------------------------ sync-BN


@pytest.mark.parametrize("phases", [1, 4])
def test_sync_bn_equals_whole_batch(dp, phases):
    """Two ranks' halves against the whole batch, rtol 1e-5: y and dx
    concatenate, the running stats are equal on both, the affine gradients
    sum (each rank holds its batch's share)."""
    payload, ranks = dp
    x, cot = payload["bn"][phases]
    ref = bn_case(x, cot, phases)
    got = [r["bn"][phases] for r in ranks]
    for k in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]), ref[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("rm", "rv"):
        np.testing.assert_array_equal(got[0][k], got[1][k])
        np.testing.assert_allclose(got[0][k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("dscale", "dbias"):
        np.testing.assert_allclose(got[0][k] + got[1][k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------- train steps


def assert_two_ranks_match(ranks, key, ref_metrics, ref_sd):
    (m0, sd0), (m1, sd1) = ranks[0][key], ranks[1][key]
    for k in sd0:  # every rank holds the same parameters, BN stats and counters
        np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)
    for s in range(STEPS):  # the global loss: the mean of the ranks' equal slices
        np.testing.assert_allclose((m0[s]["loss"] + m1[s]["loss"]) / 2, ref_metrics[s]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m0[s]["per_task_loss_sum"] + m1[s]["per_task_loss_sum"],
                                   ref_metrics[s]["per_task_loss_sum"], rtol=1e-5)
    for k, v in ref_sd.items():
        np.testing.assert_allclose(sd0[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_two_rank_steps_equal_one_rank(dp):
    payload, ranks = dp
    ref = train_steps(port_config(), payload["sd"], payload["batch"])
    assert_two_ranks_match(ranks, "train", *ref)


def test_two_rank_steps_under_remat(dp):
    payload, ranks = dp
    ref = train_steps(port_config(), payload["sd"], payload["batch"])
    assert_two_ranks_match(ranks, "remat", *ref)


def test_two_rank_unet_steps_equal_one_rank(dp):
    payload, ranks = dp
    assert_two_ranks_match(ranks, "unet",
                           *train_steps(port_config("UNet"), None, payload["batch"], seed=3))


def test_two_rank_steps_match_jax_mesh(dp, jax_state):
    """JAX's step on a 2-device mesh, the same weights and batch: loss rtol
    1e-5; parameters and BN stats rtol 2e-3, atol 1e-4."""
    payload, ranks = dp
    mesh = jax_make_mesh(2)
    state = jax_replicate(mesh, jax_state)
    batch = jax_shard_batch(mesh, payload["batch"])
    step = jax_make_train_step(jax_config(), donate=False)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    (m0, sd0), (m1, _) = ranks[0]["train"], ranks[1]["train"]
    np.testing.assert_allclose([(m0[s]["loss"] + m1[s]["loss"]) / 2 for s in range(STEPS)],
                               losses, rtol=1e-5)
    ref = from_jax_variables(jax.tree.map(np.asarray, state.variables))
    for k, v in ref.items():
        if "num_batches" not in k:
            np.testing.assert_allclose(sd0[k], v.numpy(), rtol=2e-3, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------- sampling


def test_padded_tail_matches_jax_and_shards():
    """3 volumes in batches of 2: the tail padded by the same draw as JAX's,
    bit for bit over two epochs; each rank's slice of a batch is its half."""
    kw = dict(volumes_per_task=1, vol_shape=(12, 20, 24), seed=4)
    tasks = ("a", "b", "c")
    ours = PatchSampler(synthetic_store(tasks, **kw), 2, PATCH, seed=9)
    ref = JaxPatchSampler(jax_synthetic_store(tasks, **kw), 2, PATCH, seed=9, use_native=False)
    for _ in range(2):
        a = list(ours.epoch(pad_tail_to_batch=True))
        b = list(ref.epoch(pad_tail_to_batch=True))
        assert [len(x["task"]) for x in a] == [2, 2]
        for x, y in zip(a, b):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    halves = [shard_batch(Mesh(r, 2, torch.device("cpu"), None), a[-1]) for r in range(2)]
    for k in a[-1]:
        np.testing.assert_array_equal(np.concatenate([h[k].numpy() for h in halves]), a[-1][k])


# ------------------------------------------------------------------ serving


def test_sharded_grid_equals_jax_mesh_grid():
    cfg, jcfg = port_config(), jax_config()
    ours = TiledPredictor(cfg, mode="two_phase", mesh=Mesh(1, 2, torch.device("cpu"), None))
    ref = JaxTiledPredictor(jcfg, mode="two_phase", mesh=jax_make_mesh(2),
                            forward_fn=lambda p, x: x)
    (s, v, p), (js, jv, jp) = ours.grid(VOL), ref.grid(VOL)
    assert p == jp == 24 and s.shape == (6, EVAL_BATCH, 3)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(v, jv)


def test_sharded_two_phase_matches_fused_and_jax(dp, jax_state):
    """Each rank predicts 3 of the 6 batches; the all-reduced volume is the
    one-rank fused volume within rel L2 1e-6 and JAX's mesh two_phase
    within the serving tests' rtol 1e-4, atol 1e-5."""
    payload, ranks = dp
    cfg = port_config()
    for r in ranks:
        assert r["batches_predicted"] == [EVAL_BATCH] * 3
    np.testing.assert_array_equal(ranks[0]["volume"], ranks[1]["volume"])
    sd = {k: torch.from_numpy(v) for k, v in payload["serve_sd"].items()}
    fused = TiledPredictor(cfg, device="cpu")(make_inference(cfg)[0](sd, 1), payload["vol"])
    fused = fused.numpy()
    got = ranks[0]["volume"]
    assert np.linalg.norm(got - fused) <= 1e-6 * np.linalg.norm(fused)
    jcfg = jax_config()
    plain = jax_reparameterize(serving_variables(jax_state), jcfg.model, len(TASKS), 1)
    ref = np.asarray(JaxTiledPredictor(jcfg, mode="two_phase", mesh=jax_make_mesh(2))(
        plain, jnp.asarray(payload["vol"])))
    assert np.std(ref) > 1e-3
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
