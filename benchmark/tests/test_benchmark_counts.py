"""The yardstick's counts: FLOPs and bytes by hand for one conv, the whole
volume's FLOPs against the program's FLOP model, and the seeded weights
against the program's state layout, for every configuration; and RepMode's
counts, bounds and seeded weights pinned to the last digit."""

import hashlib

import pytest
import torch

from benchmark import cell, counts, data, spec
from benchmark.reference import nets

H100 = counts.peaks("NVIDIA H100 80GB HBM3")
NAMES = [c["name"] for c in spec.benchmark()["configs"]]


def test_one_conv_by_hand():
    # 32 -> 32 channels, 5^3 taps, one 32x128x128 patch
    vox = 32 * 128 * 128
    assert counts.conv_flops(vox, 32, 32, 125) == 2 * 524288 * 32 * 32 * 125
    cfg = {"model": "RepMode", "in_channels": 1, "mult_chan": 32, "depth": 1, "kernel_size": 5,
           "out_channels": 1,
           "conv_dtypes": {"input": "bfloat16", "weight": "bfloat16", "output": "bfloat16",
                           "final_output": "float32", "weight_grad": "float32",
                           "per_sample_weights": True}}
    convs = counts.same_convs(cfg, (32, 128, 128))
    assert convs[1] == counts.Conv(vox, 32, 32, 125, False)
    # one call of 8 patches: x, w and y once each, in bf16, and the fp32 bias
    mix = {"volume_shape": [32, 128, 128 * 4 - 3 * 64], "patch_size": [32, 128, 128],
           "overlap": 0.5, "batch_size_eval": 8}
    assert counts.tiling_patch_count(mix["volume_shape"], mix["patch_size"]) == 4
    flops = 4 * counts.conv_flops(vox, 32, 32, 125)
    nbytes = 4 * vox * (32 * 2 + 32 * 2) + 125 * 32 * 32 * 2 + 32 * 4
    one = max(flops / H100[0], nbytes / H100[1])
    total = counts.serve_conv_bound_s(cfg, mix, H100)
    parts = [max(4 * counts.conv_flops(c.voxels, c.ci, c.co, c.taps) / H100[0],
                 (4 * c.voxels * (c.ci * 2 + c.co * (4 if c.final else 2))
                  + c.taps * c.ci * c.co * 2 + (0 if c.final else 4 * c.co)) / H100[1])
             for c in convs]
    assert parts[1] == pytest.approx(one)
    assert total == pytest.approx(sum(parts))


def test_train_bound_counts_three_passes():
    cfg = spec.config("repmode")
    mix = spec.traffic("train_hostsampler")
    t = counts.train_conv_bound_s(cfg, mix, H100)
    fwd = sum(max(counts.conv_flops(c.voxels, c.ci, c.co, c.taps) * 8 / H100[0], 0)
              for c in counts.same_convs(cfg, mix["patch_size"]))
    # every conv bound by its FLOPs at least; dX skipped for the first conv
    assert t >= 3 * fwd - fwd * 0.01
    assert t < 3 * fwd * 1.5


def test_whole_volume_flops():
    cfg = spec.config("repmode")
    mix = spec.traffic("serve_12task")
    assert counts.tiling_patch_count(mix["volume_shape"], mix["patch_size"]) == 126
    assert counts.tiled_inference_flops(cfg, mix["volume_shape"], mix["patch_size"]) == \
        137_637_931_253_760
    assert counts.train_step_flops(cfg, 8, (32, 128, 128)) == 26_216_748_810_240


@pytest.mark.parametrize("name", NAMES)
def test_same_count_as_the_program_flops_model(name):
    from repmode_tpu_torch.config import ModelConfig
    from repmode_tpu_torch.utils import flops

    cfg = spec.config(name)
    assert counts.inference_flops_per_patch(cfg, (32, 128, 128)) == \
        flops.inference_flops_per_patch(ModelConfig(**cell.model_fields(cfg)), (32, 128, 128))


@pytest.mark.parametrize("name", NAMES)
def test_seeded_weights_load_into_the_program(name):
    from repmode_tpu_torch.config import Config, ModelConfig
    from repmode_tpu_torch.models import build_model

    cfg = {**spec.config(name), "mult_chan": 4, "depth": 2}
    pc = Config(model=ModelConfig(**cell.model_fields(cfg)))
    net = build_model(pc, None, "cpu")
    state = data.seeded_weights(cfg, {}, 2**31 + 5, torch.device("cpu"), [])
    net.load_state_dict(state, strict=True)
    assert set(nets.parameter_names(cfg)) == {k for k, _ in net.named_parameters()}
    again = data.seeded_weights(cfg, {}, 2**31 + 5, torch.device("cpu"), [])
    assert all(torch.equal(state[k], again[k]) for k in state)
    for e in nets.spec(cfg):
        if e.law == "uniform":
            bound = e.value ** -0.5
            assert float(state[e.name].abs().max()) <= bound


@pytest.mark.parametrize("name", NAMES)
def test_parameter_count_at_full_width(name):
    cfg = spec.config(name)
    entries = {e.name: e for e in nets.spec(cfg)}
    n = sum(int(torch.Size(entries[k].shape).numel()) for k in nets.parameter_names(cfg))
    assert n == cfg["parameters"]


def _repmode():
    return spec.config("repmode"), spec.traffic("serve_12task"), spec.traffic("train_hostsampler")


def _parameters(cfg):
    entries = {e.name: e for e in nets.spec(cfg)}
    return sum(int(torch.Size(entries[k].shape).numel()) for k in nets.parameter_names(cfg))


PINS = {
    "inference_flops_per_patch": (lambda c, s, t: counts.inference_flops_per_patch(c, (32, 128, 128)),
                                  1_092_364_533_760),
    "tiled_inference_flops": (lambda c, s, t: counts.tiled_inference_flops(
        c, s["volume_shape"], s["patch_size"], s["overlap"]), 137_637_931_253_760),
    "train_step_flops": (lambda c, s, t: counts.train_step_flops(c, t["batch_size"],
                                                                 t["patch_size"]),
                         26_216_748_810_240),
    "same_convs": (lambda c, s, t: len(counts.same_convs(c, (32, 128, 128))), 19),
    "serve_conv_bound_s": (lambda c, s, t: counts.serve_conv_bound_s(c, s, H100),
                           0.1399730771518827),
    "train_conv_bound_s": (lambda c, s, t: counts.train_conv_bound_s(c, t, H100),
                           0.02721097653220169),
    "spec_entries": (lambda c, s, t: len(nets.spec(c)), 309),
    "parameter_names": (lambda c, s, t: len(nets.parameter_names(c)), 193),
    "parameters": (lambda c, s, t: _parameters(c), 123_877_633),
}


@pytest.mark.parametrize("what", sorted(PINS))
def test_repmode_pinned(what):
    """Exact: a move of the net's code that reorders or recounts shows here."""
    fn, value = PINS[what]
    assert fn(*_repmode()) == value


@pytest.mark.parametrize("widths,digest", [
    ({"mult_chan": 4, "depth": 2},
     "4db7e778d2aeff6a7f40bf7669466e455afaee53c7a22aab443d4af32398fd17"),
    ({}, "0541707f87ea0f8ac58b3f8ba1e478e603e194cbe412d5e48105cad585bc3dc8"),
], ids=["small", "published"])
def test_repmode_seeded_weights_pinned(widths, digest):
    """SHA-256 over each entry in ``spec`` order, its name then its bytes:
    the one flat draw follows that order, so a reordered spec changes it."""
    cpu = torch.device("cpu")
    cfg = {**spec.config("repmode"), **widths}
    state = data.weights(cfg, data.generator(2**31 + 5, cpu), cpu)
    h = hashlib.sha256()
    for e in nets.spec(cfg):
        h.update(e.name.encode())
        h.update(state[e.name].contiguous().numpy().tobytes())
    assert h.hexdigest() == digest
