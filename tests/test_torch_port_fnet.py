"""The port's ``fnet_nn_3d`` against pytorch_fnet's ``Net`` as published
(``tests/fnet_nn_3d_ref.py``), on the CPU at mult_chan 2, depth 2, batch 2
of 16^3 patches, from the same seeded weights:

  * the registry, the published geometry at full width, and ``to_config``'s
    kernel size;
  * the ``state_dict``: the reference's names, shapes and order, loaded with
    ``strict=True`` both ways;
  * the train-mode forward (batch statistics, the running ones updated), the
    eval-mode forward (running statistics) with and without grad, and every
    leaf's gradient;
  * one ``make_train_step`` against the reference's MSE, backward and
    ``torch.optim.Adam`` step.

Both run in float32. The port's BN takes the variance as E[x^2] - E[x]^2
(``ops/norm``) where torch takes it in two passes, its resamples are
matrix products where the reference runs ``conv3d`` and
``conv_transpose3d``, and its convs sum in another order: each a rounding
of float32 (2^-24 relative), which the net grows to 2e-6 relative on its
output and 3.5e-5 on its worst leaf gradient (a BN scale of the decoder).
The tolerances below, 1e-4 on outputs and statistics and 3e-4 on
gradients, are ~10x those readings and far under the 10 % a lost term or
a wrong statistic gives.
"""

import numpy as np
import pytest
import torch

from fnet_nn_3d_ref import Net, exact
from repmode_tpu_torch.cli.args import build_parser, to_config
from repmode_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.models import FNet3D, available_models, build_model, kernel_size_of
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

MULT, DEPTH, LR = 2, 2, 1e-4
RTOL, GRAD_RTOL = 1e-4, 3e-4


def _cfg() -> Config:
    return Config(model=ModelConfig(name="fnet_nn_3d", mult_chan=MULT, depth=DEPTH, kernel_size=3),
                  data=DataConfig(adopted_datasets=("a", "b")),
                  train=TrainConfig(compute_dtype="float32", patch_size=(16, 16, 16),
                                    batch_size=2, lr=LR))


def _ref(seed=0) -> Net:
    torch.manual_seed(seed)
    return Net(mult_chan=MULT, depth=DEPTH)


def _batch(seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    y = (0.5 * x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _ncdhw(t):
    return t.permute(0, 4, 1, 2, 3)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _pair(seed=0):
    """(port net, reference net) with the reference's weights in both."""
    ref = _ref(seed)
    net = build_model(_cfg(), device="cpu")
    net.load_state_dict(ref.state_dict(), strict=True)
    return net, ref


# ------------------------------------------------------------------ registry


def test_registry_and_published_geometry():
    assert "fnet_nn_3d" in available_models()
    assert kernel_size_of("fnet_nn_3d") == 3 and kernel_size_of("UNet") == 5
    cfg = to_config(build_parser().parse_args(["--nn_module", "fnet_nn_3d", "--mult_chan", "32"]))
    assert (cfg.model.kernel_size, cfg.model.depth, cfg.model.mult_chan) == (3, 4, 32)
    assert to_config(build_parser().parse_args([])).model.kernel_size == 5
    net = build_model(cfg, device="cpu")
    assert isinstance(net, FNet3D)
    ours, pub = net.state_dict(), Net().state_dict()
    assert list(ours) == list(pub) and len(pub) == 184
    assert all(ours[k].shape == pub[k].shape for k in pub)
    assert sum(p.numel() for p in net.parameters()) == 23_280_769
    assert len(list(net.parameters())) == 106
    assert "net_recurse.sub_u.sub_2conv_more.conv1.bias" in ours


def test_kernel_size_is_the_published_one():
    with pytest.raises(ValueError, match="3\\^3"):
        build_model(Config(model=ModelConfig(name="fnet_nn_3d", mult_chan=2, depth=2)),
                    device="cpu")


def test_state_dict_loads_strictly_both_ways():
    net, ref = _pair()
    ours, theirs = net.state_dict(), ref.state_dict()
    assert list(ours) == list(theirs)
    assert all(ours[k].shape == theirs[k].shape and torch.equal(ours[k], theirs[k])
               for k in theirs)
    _ref(1).load_state_dict(net.state_dict(), strict=True)


# ------------------------------------------------------------------ forwards


def test_train_mode_forward_and_running_statistics():
    net, ref = _pair()
    x, _ = _batch()
    with exact():
        y = net.train()(x)
        r = ref.train()(_ncdhw(x))
    assert y.shape == (2, 16, 16, 16, 1) and y.dtype == torch.float32
    assert _rel(y, r.permute(0, 2, 3, 4, 1)) <= RTOL
    ours, theirs = net.state_dict(), ref.state_dict()
    for k in theirs:
        if "running" in k:
            assert _rel(ours[k], theirs[k]) <= RTOL, k
        elif k.endswith("num_batches_tracked"):
            assert int(ours[k]) == int(theirs[k]) == 1, k


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_eval_mode_forward(grad):
    """Running statistics from two train-mode forwards; eval mode without grad
    takes ``conv3d_same`` (K1's plain version here), with grad the autograd
    conv."""
    net, ref = _pair(2)
    with exact(), torch.no_grad():
        for seed in (3, 4):
            ref.train()(_ncdhw(_batch(seed)[0]))
    net.load_state_dict(ref.state_dict(), strict=True)
    x, _ = _batch(5)
    with exact(), torch.set_grad_enabled(grad):
        y = net.eval()(x)
        r = ref.eval()(_ncdhw(x))
    assert _rel(y, r.permute(0, 2, 3, 4, 1)) <= RTOL


def test_every_leaf_gradient():
    """Every leaf within 3e-4 of the reference's gradient norm, where that
    norm is at least a thousandth of the median leaf's; below it lie the
    biases of the 14 convs before a train-mode BN, which BN cancels, so their
    exact gradient is 0: both read round-off there (the reference up to
    ~3e-5 of the median), held under 1e-4 of it."""
    net, ref = _pair(7)
    x, t = _batch(8)
    with exact():
        torch.mean((net.train()(x) - t) ** 2).backward()
        torch.mean((ref.train()(_ncdhw(x)) - _ncdhw(t)) ** 2).backward()
    ours = dict(net.named_parameters())
    theirs = dict(ref.named_parameters())
    norms = {k: float(torch.linalg.vector_norm(p.grad)) for k, p in theirs.items()}
    med = float(np.median(list(norms.values())))
    small = sorted(k for k, v in norms.items() if v < 1e-3 * med)
    before_bn = sorted(k for k in theirs if k.endswith(".bias") and (
        ".conv1." in k or ".conv2." in k or "conv_down" in k or "convt" in k))
    assert small == before_bn and len(small) == 14
    for k, p in theirs.items():
        g = ours[k].grad
        assert g is not None and g.shape == p.grad.shape, k
        if k in small:
            assert float(torch.linalg.vector_norm(g)) <= 1e-4 * med, k
            assert norms[k] <= 1e-4 * med, k
        else:
            assert _rel(g, p.grad) <= GRAD_RTOL, (k, _rel(g, p.grad))


# ------------------------------------------------------------ one train step


def test_one_train_step_against_the_reference():
    """The port's step (MSE over every element, backward, ``torch.optim.Adam``
    at betas 0.9 / 0.999, eps 1e-8) against the reference's. Adam's first
    step moves each element by lr * g / (|g| + eps): by lr where g is sure
    and by round-off's sign where g is round-off, so the 14 BN-cancelled
    biases are held only to move by at most lr. Elsewhere a leaf's change
    differs only in elements whose gradient is near 0 (read: 7.7e-5 of the
    change at worst), held to 1e-3; the loss (read: 2e-7) to 1e-5."""
    ref = _ref(9)
    cfg = _cfg()
    state = create_train_state(cfg, None, "cpu")
    state.net.load_state_dict(ref.state_dict(), strict=True)
    before = {k: v.clone() for k, v in ref.state_dict().items()}
    step = make_train_step(cfg, state)
    x, t = _batch(10)
    task = torch.tensor([1, 0])
    with exact():
        m = step({"signal": x, "target": t, "task": task})
        opt = torch.optim.Adam(ref.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
        opt.zero_grad()
        loss = torch.mean((ref.train()(_ncdhw(x)) - _ncdhw(t)) ** 2)
        loss.backward()
        opt.step()
    assert float(m["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    norms = {k: float(torch.linalg.vector_norm(p.grad)) for k, p in ref.named_parameters()}
    med = float(np.median(list(norms.values())))
    ours, theirs = state.net.state_dict(), ref.state_dict()
    moved = 0
    for k, p in ref.named_parameters():
        d_ours, d_ref = ours[k] - before[k], theirs[k] - before[k]
        if norms[k] < 1e-3 * med:
            assert float(d_ours.abs().max()) <= LR * (1 + 1e-3), k
            continue
        moved += 1
        assert _rel(d_ours, d_ref) <= 1e-3, (k, _rel(d_ours, d_ref))
    assert moved == len(norms) - 14 and len(norms) == 58
    for k in theirs:
        if "running" in k:
            assert _rel(ours[k], theirs[k]) <= RTOL, k
