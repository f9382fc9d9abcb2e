"""The plain reference against the published code's own numbers (the float64
golden ``tests/goldens/repmode_small.npz``, captured from RepMode.py), and
against the port at a small size on the CPU (mult_chan 4, 16^3 patches)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import benchmark.reference as reference
from benchmark import cell, data, spec
from benchmark.reference import nets, tiling
from benchmark.reference.precision import FP32, FP8

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "goldens" / "repmode_small.npz"
SMALL = {"mult_chan": 2, "depth": 4, "num_tasks": 3}
NAMES = [c["name"] for c in spec.benchmark()["configs"]]


@pytest.fixture(scope="module")
def golden():
    if not GOLDEN.exists():
        pytest.skip("the published code's golden is not in this checkout")
    z = np.load(GOLDEN)
    state = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    return z, state, {**spec.config("repmode"), **SMALL}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_against_the_published_code(golden, mode):
    z, state, cfg = golden
    x = torch.from_numpy(z["x"])
    tasks = torch.from_numpy(z["tasks_mixed" if mode == "train" else "tasks_uniform"])
    with torch.no_grad():
        y = nets.forward(state, x, tasks, cfg, FP32, train=mode == "train")
    np.testing.assert_allclose(y.numpy(), z[f"y_{mode}"], rtol=1e-9, atol=1e-11)


def test_gradients_against_the_published_code(golden):
    z, state, cfg = golden
    names = nets.parameter_names(cfg)
    params = {n: state[n].clone().requires_grad_(True) for n in names}
    out = nets.forward({**state, **params}, torch.from_numpy(z["x"]),
                       torch.from_numpy(z["tasks_mixed"]), cfg, FP32, train=True)
    loss = torch.mean((out - torch.from_numpy(z["grad_target"])) ** 2)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(z["grad_loss"]), rel=1e-12)
    assert len(names) == len([k for k in z.files if k.startswith("gr.")])
    for n, g in zip(names, grads):
        ref = z[f"gr.{n}"]
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-7, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=n)


def test_tiling_against_the_program_grid():
    from repmode_tpu_torch.infer.tiling import compute_patch_starts
    from repmode_tpu_torch.ops.gaussian import gaussian_importance_map

    for vol in [(32, 624, 924), (16, 40, 48), (32, 128, 128)]:
        np.testing.assert_array_equal(tiling.patch_starts(vol, (32, 128, 128) if vol[0] == 32
                                                          else (16, 32, 32), 0.5),
                                      compute_patch_starts(vol, (32, 128, 128) if vol[0] == 32
                                                           else (16, 32, 32), 0.5))
    np.testing.assert_array_equal(tiling.gaussian_map((32, 128, 128)),
                                  gaussian_importance_map((32, 128, 128)))


def _small(name):
    cfg = {**spec.config(name), "mult_chan": 4, "depth": 2}
    return cfg, torch.device("cpu")


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_against_the_port_in_fp32(name):
    """Three fp32 steps with Adam: the port (fp32, its expert sum or merged
    route on the CPU) and the reference agree to round-off."""
    from repmode_tpu_torch.config import Config, ModelConfig, TrainConfig
    from repmode_tpu_torch.train.state import create_train_state
    from repmode_tpu_torch.train.step import make_train_step

    cfg, dev = _small(name)
    state = data.seeded_weights(cfg, {}, 7, dev, [])
    pc = Config(model=ModelConfig(**{**cell.model_fields(cfg), "train_s2d": False}),
                train=TrainConfig(compute_dtype="float32", lr=cfg["lr"]))
    ts = create_train_state(pc, None, dev)
    ts.net.load_state_dict(state, strict=True)
    step = make_train_step(pc, ts)
    rng = np.random.default_rng(0)
    batches = [{"signal": rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32),
                "target": rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32),
                "task": np.array([t, (t + 5) % cfg["num_tasks"]], np.int32)} for t in range(3)]
    losses = [float(step({k: torch.from_numpy(v) for k, v in b.items()})["loss"]) for b in batches]
    ref = reference.train_steps(state, batches, cfg)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for n, p in ts.net.named_parameters():
        delta = float(torch.linalg.vector_norm((p.detach() - state[n]).double()))
        assert delta == pytest.approx(ref["delta"][n], rel=2e-2, abs=1e-7), n


@pytest.mark.parametrize("name", NAMES)
def test_whole_volume_against_the_port_and_the_control(name):
    """The stitched prediction: the port in fp32 to round-off, the float8
    control far off."""
    from repmode_tpu_torch.config import Config, EvalConfig, ModelConfig, TrainConfig
    from repmode_tpu_torch.infer.predict import TiledPredictor
    from repmode_tpu_torch.models.reparam import make_inference

    cfg, dev = _small(name)
    mix = {"patch_size": [16, 32, 32], "overlap": 0.5, "batch_size_eval": 2, "kind": "serve"}
    vols = [torch.randn((16, 40, 48), generator=torch.Generator().manual_seed(s)).numpy()
            for s in range(12)]
    state = data.seeded_weights(cfg, mix, 11, dev, vols)
    first_var = next(e.name for e in nets.spec(cfg) if e.name.endswith(".running_var"))
    assert float(state[first_var][0]) != 1.0
    pc = Config(model=ModelConfig(**{**cell.model_fields(cfg), "train_s2d": False}),
                train=TrainConfig(compute_dtype="float32", batch_size_eval=2,
                                  patch_size=(16, 32, 32)),
                eval=EvalConfig(patch_size=(16, 32, 32), s2d=False))
    vol = torch.randn((16, 40, 48), generator=torch.Generator().manual_seed(3))
    prepare, _ = make_inference(pc)
    pred = TiledPredictor(pc, device=dev)(prepare(state, 5), vol)
    ref = reference.predict_volume(state, vol, 5, cfg, mix)
    ctl = reference.predict_volume(state, vol, 5, cfg, mix, prec=FP8)
    rel = float((pred - ref).norm() / ref.norm())
    rel_ctl = float((ctl - ref).norm() / ref.norm())
    assert rel < 1e-5
    assert rel_ctl > 1e-2
