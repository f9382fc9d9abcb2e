"""The plain U-Nets' served forward (eval mode under ``torch.no_grad()``),
whose BN + ReLU runs in K1's epilogue, on the CPU (K1's plain version) at
mult_chan 2, depth 2, against the unfused composition it replaces:

  * ``conv3d_same_plain`` with a per-channel ``scale`` against the conv with
    its bias, then ``batch_norm_apply`` and ReLU, in float64;
  * ``UNet`` and ``fnet_nn_3d``: the served forward against the same net
    run unfused (kept below as the reference: the conv's output with its
    bias in the accumulation dtype, BN from the running statistics, ReLU,
    that dtype between convs and in the skip's concatenation), in float64,
    float32 and bfloat16, and again after a second ``load_state_dict`` with
    other weights and statistics;
  * the served forward's calls of ``conv3d_same`` with a scale (on the card,
    ``conv3d_same.bn_epilogues``' launches): 4 * depth + 2 = 10 a batch, none
    in a train step; the launch counter itself stays on the CPU.

The fused arithmetic is the unfused one up to reassociation: sum * scale +
shift against ((sum + bias) - mean) * rsqrt(var + eps) * gamma + beta, with
its rounding to bfloat16 where the next conv rounds its input anyway. Read
(rel L2 of the outputs): 4e-17 to 1.5e-15 in float64 (held to 1e-12); 0 in bfloat16
(held to 1e-3, the limit of the JAX package's bfloat16 parity test), where a
reassociation may move a rounding by one ulp. In float32 the nets' own
rounding is most of it: the UNet's output (std 0.006 from unit inputs) is
1.2e-6 from the float64 forward's, unfused or fused, and fused against
unfused reads 8e-7, so float32 is held by the served forward's distance
from float64 over the unfused one's (read: 0.93-1.09; held to 1.5). A fault
reads far above each: BN's mean off by 0.01 gives 0.07-0.69 in bfloat16,
the conv's bias left out of the shift 0.54 (``fnet_nn_3d``).
"""

import copy
import types
from unittest import mock

import pytest
import torch
from torch import nn

from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models import build_model
from repmode_tpu_torch.models import fnet as fnet_mod
from repmode_tpu_torch.models import unet as unet_mod
from repmode_tpu_torch.models.reparam import make_inference
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops.conv3d import conv3d_same, conv3d_same_plain
from repmode_tpu_torch.ops.norm import batch_norm_apply
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

MODELS = ["UNet", "fnet_nn_3d"]
PATCH, VOLUME = (8, 16, 16), (8, 24, 40)   # 2 x 4 patches: 4 batches of 2
TOL = {"float64": 1e-12, "float32": 1.5, "bfloat16": 1e-3}


def _cfg(model: str, compute_dtype: str = "float32") -> Config:
    return Config(model=ModelConfig(name=model, mult_chan=2, depth=2,
                                    kernel_size=3 if model == "fnet_nn_3d" else 5),
                  data=DataConfig(adopted_datasets=("dna", "lamin_b1")),
                  train=TrainConfig(batch_size=2, batch_size_eval=2, patch_size=PATCH,
                                    compute_dtype=compute_dtype),
                  eval=EvalConfig(patch_size=PATCH, s2d=False))


def _net(cfg: Config, seed: int) -> torch.nn.Module:
    """A seeded net with BN statistics and affines away from their init (a
    mean of 0 and a variance of 1 would leave BN nearly the identity)."""
    g = torch.Generator().manual_seed(seed)
    net = build_model(cfg, g, device="cpu")
    with torch.no_grad():
        for bn in (m for m in net.modules() if isinstance(m, nn.BatchNorm3d)):
            c = bn.num_features
            bn.running_mean.copy_((torch.rand(c, generator=g) - 0.5) * 0.2)
            bn.running_var.copy_(torch.rand(c, generator=g) * 0.3 + 0.3)
            bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            bn.bias.copy_((torch.rand(c, generator=g) - 0.5) * 0.2)
    return net.eval()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# ------------------------------------------------- the unfused reference


def _bn_relu_unfused(y, bn):
    return torch.relu(batch_norm_apply(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                       bn.eps))


def _conv_bn_relu_unfused(x, w, compute_dtype, training, bn, bias=None):
    assert not training
    return _bn_relu_unfused(conv3d_same_plain(x, w, bias, compute_dtype=compute_dtype), bn)


def _resample_bn_relu_unfused(y, bias, bn, compute_dtype, training):
    assert not training
    return _bn_relu_unfused(y if bias is None else y + bias, bn)


def _unfused(net, x):
    """The served forward as it ran before BN moved into K1's epilogue."""
    with mock.patch.multiple(unet_mod, _conv_bn_relu=_conv_bn_relu_unfused,
                             _resample_bn_relu=_resample_bn_relu_unfused), \
            mock.patch.multiple(fnet_mod, _conv_bn_relu=_conv_bn_relu_unfused,
                                _resample_bn_relu=_resample_bn_relu_unfused), \
            torch.no_grad():
        return net.eval()(x)


def _served(net, x):
    with torch.no_grad():
        return net.eval()(x)


# --------------------------------------------------------------- tests


def test_plain_scale_is_bn_after_the_conv():
    """act(conv * scale + shift) with scale = gamma * rsqrt(var + eps) and
    shift = (bias - mean) * scale + beta is the conv with its bias, then
    ``batch_norm_apply`` and ReLU, in float64 to 1e-12."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 6, 10, 8), generator=g, dtype=torch.float64)
    w = torch.randn((3, 3, 3, 8, 12), generator=g, dtype=torch.float64) / 8
    bias, mean, beta = (torch.randn((12,), generator=g, dtype=torch.float64) for _ in range(3))
    var = torch.rand((12,), generator=g, dtype=torch.float64) + 0.1
    gamma = torch.randn((12,), generator=g, dtype=torch.float64)
    scale = gamma * torch.rsqrt(var + 1e-5)
    shift = (bias - mean) * scale + beta
    ref = torch.relu(batch_norm_apply(conv3d_same_plain(x, w, bias), mean, var, gamma, beta))
    before = conv3d_same.bn_epilogues
    for y in (conv3d_same_plain(x, w, shift, scale=scale, relu=True),
              conv3d_same(x, w, shift, scale=scale, relu=True)):
        assert y.dtype == torch.float64 and y.shape == ref.shape
        assert float((y - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    assert conv3d_same.bn_epilogues == before  # counts K1's launches: none on the CPU
    # without the epilogue's ReLU, a negative scale flips the sign
    y = conv3d_same_plain(x, w, shift, scale=scale)
    assert float((y - batch_norm_apply(conv3d_same_plain(x, w, bias), mean, var, gamma, beta)
                  ).abs().max()) <= 1e-12 * float(ref.abs().max())


def _fused_error(net, x, dtype: str) -> float:
    """How far the served forward is from the unfused one: in float64 and
    bfloat16 their rel L2; in float32 the served forward's rel L2 to the
    unfused float64 forward over the unfused float32 forward's (the net's
    own float32 rounding, which the fused arithmetic should not exceed)."""
    if dtype == "float64":
        net, x = net.double(), x.double()
    y, ref = _served(net, x), _unfused(net, x)
    assert y.dtype == ref.dtype == x.dtype and y.shape == ref.shape == x.shape
    assert float(ref.std()) > 0
    if dtype != "float32":
        return _rel(y, ref)
    exact = _unfused(copy.deepcopy(net).double(), x.double())
    return _rel(y, exact) / _rel(ref, exact)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("model", MODELS)
def test_served_forward_matches_unfused(model, dtype):
    """The served forward against the unfused one from the same net, then
    after a ``load_state_dict`` of another net's weights and statistics
    into it: the scale and shift come from the buffers at each call, so the
    reloaded net serves the new state, as a fresh net of it does."""
    cfg = _cfg(model, "bfloat16" if dtype == "bfloat16" else "float32")
    x = torch.randn((2, *PATCH, 1), generator=torch.Generator().manual_seed(7))
    net, other = _net(cfg, 1), _net(cfg, 2)
    if dtype == "float64":
        net, other, x = net.double(), other.double(), x.double()
    assert _fused_error(net, x, dtype) <= TOL[dtype]
    first = _served(net, x)
    net.load_state_dict(other.state_dict(), strict=True)
    assert _fused_error(net, x, dtype) <= TOL[dtype]
    y = _served(net, x)
    assert _rel(y, first) > 1e-2, "the reloaded net served the first state"
    assert torch.equal(y, _served(other, x))


@pytest.mark.parametrize("model", MODELS)
def test_bn_epilogues_a_batch_and_none_in_training(model):
    """A served volume runs 10 convs with BN in the epilogue a batch (every
    'same' conv but ``conv_out``), through ``make_inference`` and the tiled
    predictor; a train step none. Counted by a spy on the nets'
    ``conv3d_same`` (calls with a scale), since ``conv3d_same.bn_epilogues``
    counts K1's launches, which the CPU makes none of."""
    scaled = []

    def spy(*args, scale=None, **kwargs):
        scaled.append(scale is not None)
        return conv3d_same(*args, scale=scale, **kwargs)

    cfg = _cfg(model)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"signal": torch.randn((2, *PATCH, 1), generator=g),
             "target": torch.randn((2, *PATCH, 1), generator=g), "task": torch.tensor([0, 1])}
    prepare, _ = make_inference(cfg)
    predictor = TiledPredictor(cfg, device="cpu")
    batches = len(predictor.grid(VOLUME)[0])
    assert batches == 4
    vol = torch.randn(VOLUME, generator=g)
    before = conv3d_same.bn_epilogues
    with mock.patch.object(unet_mod, "conv3d_same", spy):
        make_train_step(cfg, state)(batch)
        assert scaled == []
        pred = predictor(prepare(state.net.state_dict(), 1), vol)
    assert sum(scaled) == 10 * batches and len(scaled) == 11 * batches
    assert conv3d_same.bn_epilogues == before
    assert pred.shape == VOLUME and bool(torch.isfinite(pred).all())


def test_bn_epilogues_count_launches_only(monkeypatch):
    """``conv3d_same.bn_epilogues`` goes up with ``.launches``, after K1
    launched with a scale: not for a CPU call, not for a call refused before
    the launch (autograd, or a check of the operands that raises), not for a
    launch without a scale. A stub stands in for the CUDA tensor and K1."""
    def launch(*args):
        if args[3] is not None and args[3].device.type != "cuda":
            raise ValueError("conv3d_same: scale on cpu")
        return "y"

    monkeypatch.setattr(conv3d_mod, "_conv3d_same_cuda", launch)
    cuda = torch.device("cuda")
    x = types.SimpleNamespace(device=cuda, requires_grad=False)
    w = types.SimpleNamespace(device=cuda, requires_grad=True)
    scale = types.SimpleNamespace(device=cuda, requires_grad=False)
    counts = lambda: (conv3d_same.launches, conv3d_same.bn_epilogues)  # noqa: E731
    before = counts()
    with pytest.raises(RuntimeError, match="no backward"):
        conv3d_same(x, w, scale=scale)
    w.requires_grad = False
    with pytest.raises(ValueError, match="scale on cpu"):
        conv3d_same(x, w, scale=torch.ones(1))
    conv3d_same(torch.ones((1, 2, 2, 2, 1)), torch.ones((1, 1, 1, 1, 1)), scale=torch.ones(1))
    assert counts() == before
    assert conv3d_same(x, w) == "y"
    assert counts() == (before[0] + 1, before[1])
    assert conv3d_same(x, w, scale=scale) == "y"
    assert counts() == (before[0] + 2, before[1] + 1)
