"""A configuration's reference net, conv list and fault leaf are found by its
``model``, in ``benchmark/reference/models/<model lower-cased>.py``; the
program is held to every ``ModelConfig`` field the configuration names."""

import pytest
import torch

from benchmark import cell, counts, data, faults, spec
from benchmark.reference import nets
from benchmark.reference.precision import FP32

TOY = '''
import torch
from benchmark.reference.nets import Conv, Entry

FAULT_LEAF = None


def spec(cfg):
    return [Entry("conv.weight", (1, 1, 3, 3, 3), "uniform", 27),
            Entry("norm.running_var", (1,), "ones", 0.0)]


def forward(state, x, task, cfg, prec, train):
    return prec.conv(lambda a, b: torch.nn.functional.conv3d(a, b, padding=1), x,
                     state["conv.weight"]) + 7.0


def convs(cfg, patch):
    d, h, w = patch
    return [Conv(d * h * w, 1, 1, 27, True), Conv(d * h * w // 8, 1, 1, 8, False, same=False)]
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(nets, "MODELS", tmp_path)
    return {"model": "Toy", "num_tasks": 1}


def test_a_model_file_is_found_by_its_model(toy):
    assert [e.name for e in nets.spec(toy)] == ["conv.weight", "norm.running_var"]
    assert nets.parameter_names(toy) == ["conv.weight"]
    cpu = torch.device("cpu")
    state = data.weights(toy, data.generator(2**31 + 5, cpu), cpu)
    assert set(state) == {"conv.weight", "norm.running_var"}
    x = torch.zeros((1, 1, 4, 4, 4))
    y = nets.forward(state, x, torch.zeros(1, dtype=torch.long), toy, FP32, train=False)
    assert torch.equal(y, torch.full_like(x, 7.0))
    assert counts.inference_flops_per_patch(toy, (4, 4, 4)) == \
        counts.conv_flops(64, 1, 1, 27) + counts.conv_flops(8, 1, 1, 8)
    assert counts.same_convs(toy, (4, 4, 4)) == [counts.Conv(64, 1, 1, 27, True)]


def test_an_unknown_model_names_the_files_found():
    with pytest.raises(KeyError, match=r"'NoSuchNet'.*repmode\.py"):
        nets.spec({"model": "NoSuchNet"})


def test_repmode_training_has_the_leaf_faults():
    assert list(faults.for_kind("train", 0, spec.config("repmode"))) == [
        "unchanged_state", "half_batch", "expert_leaf_double", "expert_leaf_zero"]


def test_no_fault_leaf_no_leaf_faults(toy):
    assert list(faults.for_kind("train", 0, toy)) == ["unchanged_state", "half_batch"]
    assert list(faults.for_kind("serve", 16, toy)) == ["half_batch", "altered_answer"]


def test_program_config_holds_every_named_model_field():
    cfg, mix = spec.config("repmode"), spec.traffic("train_hostsampler")
    assert cell.program_config(cfg, mix, 1).model.num_experts == 5
    with pytest.raises(ValueError, match="num_experts"):
        cell.program_config({**cfg, "num_experts": 4}, mix, 1)
