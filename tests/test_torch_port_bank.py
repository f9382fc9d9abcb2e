"""The port's device bank and sampler (``data/device_sampler``) and the
``on_device_pipeline`` choice, on the CPU.

JAX's ``tests/test_device_sampler.py`` cases but the mesh one (the mesh is
not ported): shapes and determinism, patches are sub-blocks of their
volumes, the flip law, once-per-volume epochs, ragged banks whose padding
is never read, a volume smaller than the patch rejected, the train step fed
by the sampler. Then ``padded_nbytes`` and the auto choice against the JAX
package's for the same stores and budgets, resume reproduction, and
``run_experiment`` under on_device_pipeline None / True / False. The
streams are torch's, so the tests hold the law, not JAX's bits.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from repmode_tpu.data.device_sampler import DeviceVolumeBank as JaxDeviceVolumeBank
from repmode_tpu.data.store import VolumeRecord as JaxVolumeRecord
from repmode_tpu.data.store import VolumeStore as JaxVolumeStore
from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.data.device_sampler import DeviceVolumeBank, make_device_sampler
from repmode_tpu_torch.data.store import VolumeRecord, VolumeStore
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.train.loop import run_experiment, use_device_bank
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bank():
    store = synthetic_store(("a", "b"), volumes_per_task=3, vol_shape=(12, 24, 24))
    return DeviceVolumeBank.from_store(store, "cpu"), store


def identity_store(shapes):
    """Volume i is constant i + 1 with task i: a sample names its volume."""
    recs = []
    for i, shp in enumerate(shapes):
        v = np.full(shp, float(i + 1), np.float32)
        recs.append(VolumeRecord(v, v.copy(), f"t{i}", i, {}))
    return VolumeStore(recs, tuple(f"t{i}" for i in range(len(shapes))))


def test_bank_shapes(bank):
    b, _ = bank
    assert b.num_volumes == 6 and b.vol_shape == (12, 24, 24)
    np.testing.assert_array_equal(b.extents.numpy(), np.tile([12, 24, 24], (6, 1)))
    assert b.signals.dtype == torch.float32 and b.tasks.tolist() == [0, 0, 0, 1, 1, 1]


def test_sample_shapes_and_determinism(bank):
    b, _ = bank
    sample, steps = make_device_sampler(b, batch_size=4, patch_size=(8, 16, 16), seed=7)
    assert steps == 2  # ceil(6 / 4)
    out1, out2 = sample(0, 0), sample(0, 0)
    assert out1["signal"].shape == (4, 8, 16, 16, 1) and out1["target"].shape == (4, 8, 16, 16, 1)
    assert out1["task"].shape == (4,) and out1["task"].dtype == torch.int32
    for k in out1:
        assert torch.equal(out1[k], out2[k])
    assert not torch.allclose(out1["signal"], sample(1, 0)["signal"])  # a new permutation


def test_patches_come_from_volumes(bank):
    """Every patch is a sub-block of a volume of its task, and its target the
    same sub-block of that volume's target."""
    b, store = bank
    sample, _ = make_device_sampler(b, batch_size=6, patch_size=(8, 16, 16), flip_prob=0.0,
                                    seed=3)
    out = sample(0, 0)
    sigs, tgts = out["signal"][..., 0].numpy(), out["target"][..., 0].numpy()
    for i, task in enumerate(out["task"].tolist()):
        found = False
        for r in (r for r in store.records if r.task == task):
            for d0 in range(r.signal.shape[0] - 8 + 1):
                for h0 in range(r.signal.shape[1] - 16 + 1):
                    for w0 in range(r.signal.shape[2] - 16 + 1):
                        sl = np.s_[d0:d0 + 8, h0:h0 + 16, w0:w0 + 16]
                        if np.array_equal(r.signal[sl], sigs[i]):
                            assert np.array_equal(r.target[sl], tgts[i])
                            found = True
        assert found, f"patch {i} is in no task-{task} volume"


def test_flip_probability_law(bank):
    """flip_prob 1 flips every axis of every patch, 0 none: the same seed
    draws the same volumes and crops, so one is the other flipped."""
    b, _ = bank
    s0, _ = make_device_sampler(b, 4, (8, 16, 16), flip_prob=0.0)
    s1, _ = make_device_sampler(b, 4, (8, 16, 16), flip_prob=1.0)
    o0, o1 = s0(0, 0), s1(0, 0)
    for k in ("signal", "target"):
        assert torch.equal(o1[k], o0[k].flip((1, 2, 3)))
    # at 0.5 the three flips are drawn apart: over 96 whole-volume crops
    # every one of the 8 patterns occurs
    s, _ = make_device_sampler(b, 6, (12, 24, 24), flip_prob=0.5)
    vols = [torch.from_numpy(r.signal) for r in bank[1].records]
    patterns = set()
    for e in range(16):
        for t in s(e, 0)["signal"][..., 0]:
            patterns |= {f for f in range(8) for v in vols
                         if torch.equal(v.flip([a for a in range(3) if f >> a & 1]), t)}
    assert patterns == set(range(8))


def test_once_per_volume_epoch_law():
    """Each epoch visits every volume once, plus at most B-1 random tail pads."""
    n, b = 7, 3  # 3 steps, padded to 9: 2 tail pads
    bk = DeviceVolumeBank.from_store(identity_store([(8, 16, 16)] * n), "cpu")
    sample, steps = make_device_sampler(bk, b, (8, 16, 16), seed=5)
    assert steps == 3
    orders = []
    for epoch in range(3):
        seen = [t for s in range(steps) for t in sample(epoch, s)["task"].tolist()]
        counts = np.bincount(seen, minlength=n)
        assert counts.min() >= 1 and counts.sum() == steps * b
        assert (counts - 1).sum() == steps * b - n  # only tail pads repeat
        assert len(set(seen[:n])) == n  # the permutation comes first, the pads after
        orders.append(seen)
    assert orders[0] != orders[1]


@pytest.mark.parametrize("pad_value", [0.0, float("nan")], ids=["zero", "nan"])
def test_ragged_bank_padding_never_read(pad_value):
    """Crops stay inside each volume's true extents: padding (the bank's
    zeros, or NaN written over them, which would show any read) never
    reaches a patch."""
    shapes = [(8, 16, 16), (10, 20, 18), (12, 24, 24)]
    bk = DeviceVolumeBank.from_store(identity_store(shapes), "cpu")
    assert bk.vol_shape == (12, 24, 24)
    np.testing.assert_array_equal(bk.extents.numpy(), shapes)
    assert float(bk.signals[0, 8:].abs().sum()) == 0  # zero-padded
    for i, (d, h, w) in enumerate(shapes):
        for t in (bk.signals[i], bk.targets[i]):
            pad = torch.ones_like(t, dtype=torch.bool)
            pad[:d, :h, :w] = False
            t[pad] = pad_value
    sample, steps = make_device_sampler(bk, 3, (8, 16, 16), seed=1)
    for epoch in range(6):
        for s in range(steps):
            out = sample(epoch, s)
            for k in ("signal", "target"):
                for i, task in enumerate(out["task"].tolist()):
                    assert torch.all(out[k][i] == task + 1), f"padding read: volume {task}"


def test_volume_smaller_than_patch_rejected():
    bk = DeviceVolumeBank.from_store(identity_store([(8, 16, 16), (4, 16, 16)]), "cpu")
    with pytest.raises(ValueError, match="smaller than the patch"):
        make_device_sampler(bk, 2, (8, 16, 16))
    with pytest.raises(NotImplementedError, match="A10"):
        make_device_sampler(bk, 2, (4, 16, 16), mesh=object())


def test_unlabeled_volume_refused():
    store = identity_store([(8, 16, 16)] * 2)
    store.records[1].target = None
    with pytest.raises(ValueError, match="no target"):
        DeviceVolumeBank.from_store(store, "cpu")


def test_train_step_integration(bank):
    """The sampler feeds the train step: a finite loss, parameters updated."""
    b, _ = bank
    cfg = Config(model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
                 train=TrainConfig(batch_size=2, patch_size=(8, 16, 16), compute_dtype="float32"),
                 data=DataConfig(adopted_datasets=("a", "b")))
    state = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    before = [p.detach().clone() for p in state.net.parameters()]
    step = make_train_step(cfg, state)
    sample, steps = make_device_sampler(b, 2, (8, 16, 16))
    losses = [float(step(sample(0, s))["loss"]) for s in range(steps)]
    assert steps == 3 and all(np.isfinite(losses)) and state.step == 3
    assert all(not torch.equal(a, p) for a, p in zip(before, state.net.parameters()))


def test_resume_reproduces_any_step():
    """sample(epoch, step) depends on (seed, epoch, step) alone: a fresh
    sampler, in another order, gives the same batches bit for bit; another
    seed gives others."""
    bk = DeviceVolumeBank.from_store(synthetic_store(("a", "b"), 3, vol_shape=(12, 24, 24)),
                                     "cpu")
    first, steps = make_device_sampler(bk, 4, (8, 16, 16), seed=11)
    run = {(e, s): first(e, s) for e in range(3) for s in range(steps)}
    again, _ = make_device_sampler(bk, 4, (8, 16, 16), seed=11)
    for (e, s) in sorted(run, reverse=True):
        out = again(e, s)
        for k in out:
            assert torch.equal(out[k], run[e, s][k])
    other, _ = make_device_sampler(bk, 4, (8, 16, 16), seed=12)
    assert not torch.equal(other(0, 0)["signal"], run[0, 0]["signal"])


@pytest.mark.parametrize("shapes", [
    [(12, 24, 24)] * 3,
    [(8, 16, 16), (10, 20, 18), (12, 24, 24)],
    [(32, 128, 128)] * 2 + [(20, 100, 130)],
    [],
], ids=["uniform", "ragged", "wide", "empty"])
def test_padded_nbytes_and_auto_choice_match_jax(shapes):
    """padded_nbytes equals JAX's for the same store, and the auto choice is
    JAX's (0 < bytes <= budget) at budgets below, at and above the bank;
    on_device_pipeline True / False force it."""
    ours = identity_store(shapes)
    jax_store = JaxVolumeStore([JaxVolumeRecord(r.signal, r.target, r.dataset, r.task, r.info)
                                for r in ours.records], ours.adopted_datasets)
    nbytes = DeviceVolumeBank.padded_nbytes(ours)
    assert nbytes == JaxDeviceVolumeBank.padded_nbytes(jax_store)
    for budget in (nbytes - 1, nbytes, nbytes + 1, 4 * 1024**3):
        cfg = Config(train=TrainConfig(device_bank_budget_bytes=budget))
        assert use_device_bank(cfg, ours) == (0 < nbytes <= budget, nbytes)
    for forced in (True, False):
        cfg = Config(train=TrainConfig(on_device_pipeline=forced, device_bank_budget_bytes=0))
        assert use_device_bank(cfg, ours) == (forced, nbytes)


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("pipeline,budget,want", [
    (None, 4 * 1024**3, "bank"), (None, 1, "host_over_budget"), (True, 1, "bank"),
    (False, 4 * 1024**3, "host"),
], ids=["auto", "auto_over_budget", "on", "off"])
def test_run_experiment_pipelines(tmp_path, monkeypatch, pipeline, budget, want):
    """run_experiment on the CPU takes and logs the pipeline the choice
    names, trains 2 epochs of 2 steps from it, validates and tests."""
    import repmode_tpu_torch.train.loop as loop

    ran = []
    for name in ("run_train_epoch", "run_train_epoch_device"):
        fn = getattr(loop, name)
        monkeypatch.setattr(loop, name, lambda *a, _fn=fn, _n=name: ran.append(_n) or _fn(*a))
    cfg = Config(
        model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
        data=DataConfig(adopted_datasets=("dna", "lamin_b1")),
        train=TrainConfig(num_epochs=2, batch_size=2, patch_size=(16, 16, 16), interval_val=2,
                          on_device_pipeline=pipeline, device_bank_budget_bytes=budget),
        eval=EvalConfig(patch_size=(16, 16, 16), s2d=False),
        path_exp_dir=str(tmp_path / "exp"), exp_name="bank")
    stores = {split: synthetic_store(cfg.data.adopted_datasets, 2, vol_shape=(16, 24, 20), seed=i)
              for i, split in enumerate(["train", "val", "test"])}
    logger = logging.getLogger(f"bank_test_{want}")
    logger.setLevel(logging.INFO)
    rec = Records()
    logger.addHandler(rec)
    res = run_experiment(cfg, stores, logger=logger, device="cpu")
    logger.removeHandler(rec)
    bank_line = [x for x in rec.lines if "On-device pipeline" in x]
    host_line = [x for x in rec.lines if "Host pipeline" in x]
    over_line = [x for x in rec.lines if "would need" in x]
    if want == "bank":
        assert bank_line and not host_line and ran == ["run_train_epoch_device"] * 2
        assert "bank of 4 volumes padded to (16, 24, 20)" in bank_line[0]
    else:
        assert host_line and not bank_line and ran == ["run_train_epoch"] * 2
    assert bool(over_line) == (want == "host_over_budget")
    assert res["state"].step == 4 and res["state"].epoch == 2
    assert np.isfinite(res["train_log"]["loss/epoch"])
    assert np.isfinite(res["test_log"]["metric_test/MSE"])
    again = dataclasses.replace(cfg, path_exp_dir=str(tmp_path / "again"))
    if want == "bank":  # the same seed and flags give the same run
        res2 = run_experiment(again, stores, device="cpu")
        assert res2["train_log"]["loss/epoch"] == res["train_log"]["loss/epoch"]
