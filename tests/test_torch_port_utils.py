"""The port's ``utils/flops`` against the JAX package's, on the CPU: the FLOP
model's integers, the patch count against the predictor's grid, and the
trace ``run_experiment`` records of its first trained epoch under
``profile_dir`` (``utils/timing``; its spans: ``test_torch_port_tracing``)."""

import glob
import json

import pytest
import torch

from repmode_tpu.config import ModelConfig as JaxModelConfig
from repmode_tpu.utils import flops as jax_flops
from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.parallel.distributed import process_info
from repmode_tpu_torch.train.loop import run_experiment
from repmode_tpu_torch.utils import flops

torch.set_num_threads(2)

# (model fields, volume, patch): full width at the JAX bench's volume
# (BENCH_r05.json), the test size, and a 3^3-kernel net of depth 3
CASES = [
    ({}, (32, 624, 924), (32, 128, 128)),
    (dict(mult_chan=2, depth=2), (16, 24, 40), (8, 16, 16)),
    (dict(mult_chan=8, depth=3, kernel_size=3), (48, 130, 200), (16, 64, 64)),
]


@pytest.mark.parametrize("fields,vol,patch", CASES)
def test_flops_equal_jax(fields, vol, patch):
    ours, ref = ModelConfig(**fields), JaxModelConfig(**fields)
    assert flops.inference_flops_per_patch(ours, patch) == \
        jax_flops.inference_flops_per_patch(ref, patch)
    assert flops.tiling_patch_count(vol, patch) == jax_flops.tiling_patch_count(vol, patch)
    got, want = flops.tiled_inference_flops(ours, vol, patch), \
        jax_flops.tiled_inference_flops(ref, vol, patch)
    assert got == want
    for k in ("flops_per_patch", "n_patches", "total_flops"):
        assert isinstance(got[k], int), k
    assert flops.conv_flops(7, 3, 5, 27) == jax_flops.conv_flops(7, 3, 5, 27) == 2 * 7 * 3 * 5 * 27


def test_full_width_flops_are_the_benchs():
    """The full-width count the JAX bench printed for 32x624x924
    (BENCH_r05.json: model_flops_per_volume), 126 patches."""
    info = flops.tiled_inference_flops(ModelConfig(), (32, 624, 924), (32, 128, 128))
    assert info["n_patches"] == 126
    assert info["total_flops"] == 137637931253760


@pytest.mark.parametrize("vol", [(32, 624, 924), (32, 128, 128), (32, 129, 200), (48, 130, 128)])
def test_patch_count_equals_the_predictors_grid(vol):
    pred = TiledPredictor(Config(), device="cpu", forward_fn=lambda p, x: x)
    assert flops.tiling_patch_count(vol, (32, 128, 128), 0.5) == pred.num_patches(vol)


def test_process_info_without_a_group():
    assert process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                              "global_devices": 1}


def test_profile_dir_traces_the_first_epoch(tmp_path):
    """Two epochs of two steps: one Chrome trace, holding the first epoch's
    two Adam steps and their backward, and nothing of the second."""
    cfg = Config(
        model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
        data=DataConfig(adopted_datasets=("dna", "lamin_b1")),
        train=TrainConfig(num_epochs=2, batch_size=2, patch_size=(8, 16, 16), interval_val=5,
                          compute_dtype="float32"),
        eval=EvalConfig(patch_size=(8, 16, 16), s2d=False),
        path_exp_dir=str(tmp_path / "exp"), exp_name="prof")
    stores = {"train": synthetic_store(cfg.data.adopted_datasets, 2, vol_shape=(8, 16, 16))}
    res = run_experiment(cfg, stores, device="cpu", profile_dir=str(tmp_path / "trace"))
    assert res["state"].step == 4
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1
    names = [e.get("name", "") for e in json.load(open(traces[0]))["traceEvents"]]
    assert sum(n == "Optimizer.step#Adam.step" for n in names) == 2
    assert sum(n == "rm.step" for n in names) == 2
    assert any(n.startswith("autograd::engine::evaluate_function") for n in names)
    assert any(n.startswith("aten::conv3d") or n.startswith("aten::convolution") for n in names)
