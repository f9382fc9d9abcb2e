"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

K1 (``conv3d_same``: its plan, each tile of its warpgroup-MMA
instance through forced plans, and fnet_nn_3d's 27-tap serving convs with
their bias), K2 and K3 (``conv3d_same_persample``, forward and
``transpose_taps``), K4 (``conv3d_dw_persample``: its narrow and mma.sync
wide instances, and each tile of its warpgroup-MMA instance, whose
descriptors a one-block test holds first), K5 (``conv3d_dpad``: its plan, each tile of its
warpgroup-MMA instance through forced plans, its halo rows) and K6
(``conv3d_tapconcat_persample``: its plan, each tile of its persistent
warpgroup-MMA instance, whose descriptors and weight map a one-block test
holds first, and its mma.sync instance), the gate-merge kernels of the
training route (``gate_merge_persample``: forward and backward, at every
MoDE conv of the net), the training path through K2-K4 and, under
``train_impl='expert_sum'``, through ``conv3d_same_autograd``, the
space-to-depth serving routes through K1 and K5, and the space-to-depth
training path through K6 and K2-K4; also the training loop's pinned
host-to-device copy, which does not wait for queued work. Every test needs a CUDA card (the kernels have no CPU mode) and
skips without one. On the card, run this file without the JAX package's
conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

The reference r is the plain version evaluated in fp64 on the same
bf16-rounded inputs (cuDNN may pick fp32 algorithms whose own error exceeds
a bf16 ulp near zero). Tolerances: fp32 out, max|k - r| <= 1e-3 * max|r|;
bf16 out, |k - r| <= 2^-7 |r| + 1e-4 max|r| (one bf16 ulp, plus a floor for
values near zero that covers fp32 accumulation over up to 64,000 products).
K4's fp32 dW is held to max|k - r| <= 1e-3 * max|r|.
"""

import numpy as np
import pytest
import torch

from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models import reparam
from repmode_tpu_torch.models.reparam import plain_forward, reparameterize
from repmode_tpu_torch.models.repmode import RepModeNet
from repmode_tpu_torch.ops.conv3d import (
    conv3d_dpad,
    conv3d_dpad_plain,
    conv3d_dpad_plan,
    conv3d_dw_persample,
    conv3d_dw_persample_plain,
    conv3d_dw_persample_plan,
    conv3d_same,
    conv3d_same_persample,
    conv3d_same_persample_plain,
    conv3d_same_persample_plan,
    conv3d_same_plain,
    conv3d_same_plan,
    conv3d_tapconcat_persample,
    conv3d_tapconcat_persample_plain,
    conv3d_tapconcat_persample_plan,
)
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops.kernels import build
from repmode_tpu_torch.ops import mode as tmode
from repmode_tpu_torch.ops.mode import MergedConvPerSample
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def plain_fp64(x, w, b, relu):
    bf = torch.bfloat16
    return conv3d_same_plain(x.to(bf).double(), w.to(bf).double(),
                             None if b is None else b.double(), relu=relu)


def within_tolerance(y: torch.Tensor, ref: torch.Tensor) -> bool:
    err = (y.double() - ref).abs()
    top = ref.abs().max()
    if y.dtype == torch.float32:
        return bool(err.max() <= 1e-3 * top)
    return bool((err <= 2.0**-7 * ref.abs() + 1e-4 * top).all())


# (N, D, H, W, Ci, Co, taps): covers the scalar (Ci % 8 != 0) and vector
# input paths, partial channel chunks and Co tiles, W below and above the
# 128-position tile, partial tiles and depths smaller than the taps. From
# (1, 5, 3, 130, ...) on the plan takes the wide (wgmma) instance: Co = 40,
# 100 and 160 leave partial Co tiles, taps 5^3, 3^3, 1^3 and (5,3,3).
CASES = [
    (2, 4, 6, 8, 1, 32, (5, 5, 5)),
    (1, 3, 5, 20, 3, 5, (3, 5, 3)),
    (2, 2, 4, 8, 16, 1, (5, 5, 5)),
    (1, 1, 9, 16, 40, 16, (1, 3, 3)),
    (1, 5, 3, 130, 24, 40, (3, 3, 3)),
    (1, 2, 2, 200, 8, 100, (1, 1, 1)),
    (2, 2, 8, 8, 64, 64, (5, 5, 5)),
    (2, 4, 8, 16, 128, 128, (5, 3, 3)),  # the s2d routes' level-1 taps and width
    (1, 3, 4, 136, 32, 40, (5, 5, 5)),
    (2, 2, 12, 24, 48, 100, (3, 3, 3)),
    (1, 4, 8, 32, 64, 160, (1, 1, 1)),
    (2, 3, 6, 20, 16, 32, (5, 3, 3)),
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda, case, epilogue, out_dtype):
    n, d, h, w, ci, co, taps = case
    g = torch.Generator().manual_seed(hash(case) % 2**31)
    x = torch.randn((n, d, h, w, ci), generator=g).to(cuda)
    wk = (torch.randn(taps + (ci, co), generator=g) / (ci * np.prod(taps)) ** 0.5).to(cuda)
    b = torch.randn((co,), generator=g).to(cuda) if epilogue != "none" else None
    relu = epilogue == "bias_relu"
    before = conv3d_same.launches
    y = conv3d_same(x, wk, b, relu=relu, compute_dtype=torch.bfloat16, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv3d_same.launches == before + 1
    ref = plain_fp64(x, wk, b, relu)
    assert y.shape == ref.shape and y.dtype == out_dtype
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


# Every (KC, BN) the plan can pick, with 1 or 2 warpgroups of 1, 2 or 4 m64
# tiles (2 only up to BN = 64, 4 at BN = 32), on each tile shape: m64 tiles
# of 8 rows x 8
# columns (W < 64; H = 13 leaves a partial tile, W = 20 a partial column
# block), of one row segment with a partial last one (W = BM + 12), and of
# W = 64 (one row a tile). Ci = 2 KC, Co = 1.5 BN: one full and one partial
# Co tile.
WIDE_TILES = [(16, 32), (16, 64), (16, 128), (32, 32), (32, 64), (32, 128), (64, 32), (64, 64)]
WIDE_CASES = [(kc, bn, wgs, mt, geometry)
              for kc, bn in WIDE_TILES for wgs in (1, 2) for mt in (1, 2, 4)
              for geometry in ("patch", "segments", "row64")
              if mt == 1 or (geometry != "patch"
                             and ((mt == 2 and bn <= 64) or (mt == 4 and bn == 32 and kc <= 32)))]


def forced_plan(shape, co, taps, wgs, mt, kc, bn, stages):
    """The wide instance at a chosen tile, KC and ring depth (the plan
    shrinks the tiles of a small test grid)."""
    plan = dict(conv3d_same_plan(shape, co, taps), instance="wgmma", bm=64 * wgs * mt, mt=mt,
                bn=bn, kc=kc, stages=stages)
    cip = plan["packed"][0]
    return dict(plan, ci_pad=-(-cip // kc) * kc, co_pad=-(-co // bn) * bn)


def k1_operands(shape, co, taps, cuda, seed, bias=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(cuda)
    wk = (torch.randn(taps + (shape[-1], co), generator=g)
          / (shape[-1] * np.prod(taps)) ** 0.5).to(cuda)
    b = torch.randn((co,), generator=g).to(cuda) if bias else None
    return x, wk, b


@pytest.mark.parametrize("kc,bn,wgs,mt,geometry", WIDE_CASES)
def test_wide_instance_matches_plain(cuda, kc, bn, wgs, mt, geometry):
    """Each tile of the wide instance against the fp64 plain version, depth
    3 under 5 taps, rings of 3 and 4 stages."""
    w = {"patch": 20, "segments": 64 * wgs * mt + 12, "row64": 64}[geometry]
    ci, co = 2 * kc, 3 * bn // 2
    shape = (2, 3, 13 if geometry == "patch" else 5, w, ci)
    taps = (5, 5, 3)
    plan = forced_plan(shape, co, taps, wgs, mt, kc, bn, 3 + (kc + bn + wgs) % 2)
    x, wk, b = k1_operands(shape, co, taps, cuda, seed=kc + bn + wgs + mt)
    y = conv3d_mod._k1_launch(x, wk, b, None, True, torch.bfloat16, plan)
    torch.cuda.synchronize()
    ref = plain_fp64(x, wk, b, True)
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


@pytest.mark.parametrize("kc,bn,mt,w", [(16, 128, 1, 24), (32, 64, 2, 128), (64, 32, 1, 96)])
def test_wide_instance_is_deterministic(cuda, kc, bn, mt, w):
    """Every output is written once from a fixed order of products: two
    launches give the same bits."""
    shape, co, taps = (2, 4, 9, w, 2 * kc), 2 * bn, (5, 5, 5)
    plan = forced_plan(shape, co, taps, 2, mt, kc, bn, 3)
    x, wk, b = k1_operands(shape, co, taps, cuda, seed=kc)
    y1 = conv3d_mod._k1_launch(x, wk, b, None, False, torch.float32, plan)
    y2 = conv3d_mod._k1_launch(x, wk, b, None, False, torch.float32, plan)
    assert torch.equal(y1, y2)
    assert torch.equal(conv3d_same(x, wk, b, compute_dtype=torch.bfloat16),
                       conv3d_same(x, wk, b, compute_dtype=torch.bfloat16))


def k1_serving_shapes(cfg, batch=8, patch=(32, 128, 128)):
    """(x shape, Co) of each 'same' conv of plain_forward."""
    c = cfg.in_channels * cfg.mult_chan
    chans = [c * 2**i for i in range(cfg.depth + 1)]
    out, in_ch = [], cfg.in_channels

    def add(level, ci, co):
        out.append(((batch, *(s >> level for s in patch), ci), co))

    for i in range(1, cfg.depth + 1):
        add(i - 1, in_ch, chans[i - 1])
        add(i - 1, chans[i - 1], chans[i - 1])
        in_ch = chans[i - 1]
    add(cfg.depth, chans[-2], chans[-1])
    add(cfg.depth, chans[-1], chans[-1])
    for i in range(cfg.depth, 0, -1):
        add(i - 1, 2 * chans[i - 1], chans[i - 1])
        add(i - 1, chans[i - 1], chans[i - 1])
    add(0, c, cfg.out_channels)
    return out


def test_every_wide_serving_shape_plans_wgmma(cuda):
    """At full width the 15 wide convs of plain_forward above the
    bottleneck (11 distinct shapes) take the wgmma instance, compiled
    without spills; the 1-channel input conv, conv_out and the two 2x8x8
    bottleneck convs take the narrow one."""
    shapes = k1_serving_shapes(ModelConfig(mult_chan=32, depth=4))
    assert len(shapes) == 19
    for shape, co in shapes:
        plan = conv3d_same_plan(shape, co, (5, 5, 5), torch.bfloat16, device=cuda)
        wide = shape[-1] > 1 and co > 1 and shape[2] * shape[3] >= 128
        assert plan["instance"] == ("wgmma" if wide else "mma_sync"), (shape, co, plan)
        assert plan["registers"] > 0 and (plan["local_bytes"] == 0 or not wide), (shape, co, plan)


# fnet_nn_3d's 19 serving convs at full width (27 taps), batch 2
FNET3D_SHAPES = k1_serving_shapes(ModelConfig(name="fnet_nn_3d", mult_chan=32, depth=4,
                                              kernel_size=3), batch=2)


@pytest.mark.parametrize("shape,co", FNET3D_SHAPES, ids=[f"{s[1:]}->{co}" for s, co in FNET3D_SHAPES])
def test_fnet3d_serving_shapes_match_plain(cuda, shape, co):
    """K1 at each 'same' conv of fnet_nn_3d's eval forward (``models/fnet``
    through ``models/unet._conv``): 27 taps, its bias in the epilogue, fp32
    out, with the plan the wrapper picks, against the fp64 plain version."""
    x, wk, b = k1_operands(shape, co, (3, 3, 3), cuda, seed=shape[-1] + co)
    y = conv3d_same(x, wk, b, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ref = plain_fp64(x, wk, b, False)
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,co", FNET3D_SHAPES, ids=[f"{s[1:]}->{co}" for s, co in FNET3D_SHAPES])
def test_fnet3d_serving_shapes_with_bn_scale_match_plain(cuda, shape, co, out_dtype):
    """K1 with an eval BN's per-channel scale before the bias, and the ReLU,
    in its epilogue (``models/unet._conv_bn_relu``) at each 'same' conv of
    fnet_nn_3d's eval forward, fp32 and bf16 out, against the fp64 plain
    version; with a scale of ones, K1 with the bias alone, bit for bit."""
    bf = torch.bfloat16
    x, wk, b = k1_operands(shape, co, (3, 3, 3), cuda, seed=shape[-1] + co)
    g = torch.Generator().manual_seed(shape[-1] * co)
    scale = (torch.rand((co,), generator=g) * 2 - 0.5).to(cuda)  # BN's gamma may be negative
    before = conv3d_same.bn_epilogues
    y = conv3d_same(x, wk, b, scale=scale, relu=True, compute_dtype=bf, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv3d_same.bn_epilogues == before + 1
    ref = conv3d_same_plain(x.to(bf).double(), wk.to(bf).double(), b.double(),
                            scale=scale.double(), relu=True)
    assert y.shape == ref.shape and y.dtype == out_dtype
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()
    ones = conv3d_same(x, wk, b, scale=torch.ones_like(scale), relu=True, compute_dtype=bf,
                       out_dtype=out_dtype)
    assert torch.equal(ones, conv3d_same(x, wk, b, relu=True, compute_dtype=bf,
                                         out_dtype=out_dtype))


def test_kernel_rejects_fp32_compute(cuda):
    x = torch.zeros((1, 2, 2, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3d_same(x, torch.zeros((3, 3, 3, 8, 8), device=cuda))


def test_plain_forward_through_kernel_matches_plain_version(cuda, monkeypatch):
    cfg = ModelConfig(mult_chan=8, depth=3, train_s2d=False)
    net = RepModeNet(cfg, 3, generator=torch.Generator().manual_seed(1), device=cuda).eval()
    plain = reparameterize(net.state_dict(), cfg, 3, 2)
    x = torch.randn((2, 16, 32, 32, 1), generator=torch.Generator().manual_seed(2)).to(cuda)
    before = conv3d_same.launches
    y = plain_forward(plain, x, cfg, compute_dtype=torch.bfloat16)
    assert conv3d_same.launches == before + 4 * cfg.depth + 3
    monkeypatch.setattr(reparam, "conv3d_same", conv3d_same_plain)
    ref = plain_forward(plain, x, cfg, compute_dtype=torch.bfloat16)
    rel = ((y - ref).norm() / ref.norm()).item()
    assert torch.isfinite(y).all() and rel <= 1e-2, rel


def test_kernel_refuses_autograd(cuda):
    x = torch.zeros((1, 2, 2, 2, 8), device=cuda)
    w = torch.zeros((3, 3, 3, 8, 8), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        conv3d_same(x, w, compute_dtype=torch.bfloat16)


# ------------------------------------------------ per-sample kernels K2-K4

# (N, D, H, W, Ci, Co, taps): the narrow cases Ci=1 (taps packed into
# channels) and Co=1, asymmetric Ci != Co, channel counts off the tiles, W
# below 64, between 64 and 128 and above 128, depths smaller than the taps,
# non-cubic taps and a kW (7) that K4 serves one tap at a time.
PS_CASES = [
    (2, 4, 6, 8, 1, 32, (5, 5, 5)),
    (2, 3, 5, 20, 32, 1, (5, 5, 5)),
    (1, 3, 5, 130, 24, 40, (3, 3, 3)),
    (2, 2, 8, 8, 64, 48, (5, 5, 5)),
    (1, 2, 9, 70, 16, 8, (3, 5, 1)),
    (2, 5, 3, 12, 8, 16, (1, 1, 1)),
    (1, 3, 4, 36, 3, 5, (5, 3, 5)),
    (1, 2, 4, 20, 8, 8, (3, 3, 7)),
]


def ps_operands(case, cuda):
    n, d, h, w, ci, co, taps = case
    g = torch.Generator().manual_seed(hash(case) % 2**31)
    bf = torch.bfloat16
    x = torch.randn((n, d, h, w, ci), generator=g).to(cuda, bf)
    wk = (torch.randn((n, *taps, ci, co), generator=g) / (ci * np.prod(taps)) ** 0.5).to(cuda, bf)
    dy = torch.randn((n, d, h, w, co), generator=g).to(cuda, bf)
    return x, wk, dy, taps


@pytest.mark.parametrize("kernel", ["forward", "transpose", "dw"])
@pytest.mark.parametrize("case", PS_CASES)
def test_persample_kernels_match_plain(cuda, case, kernel):
    x, wk, dy, taps = ps_operands(case, cuda)
    counters = lambda: (conv3d_same_persample.launches, conv3d_same_persample.transpose_launches,
                        conv3d_dw_persample.launches)
    before = counters()
    if kernel == "forward":
        y = conv3d_same_persample(x, wk)
        ref = conv3d_same_persample_plain(x.double(), wk.double())
        expect = (1, 0, 0)
    elif kernel == "transpose":
        y = conv3d_same_persample(dy, wk, transpose_taps=True)
        ref = conv3d_same_persample_plain(dy.double(), wk.double(), transpose_taps=True)
        expect = (0, 1, 0)
    else:
        y = conv3d_dw_persample(x, dy, *taps)
        ref = conv3d_dw_persample_plain(x.double(), dy.double(), *taps)
        expect = (0, 0, 1)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counters(), before)) == expect
    assert y.shape == ref.shape
    assert y.dtype == (torch.float32 if kernel == "dw" else torch.bfloat16)
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


def test_persample_kernels_are_deterministic(cuda):
    x, wk, dy, taps = ps_operands((2, 8, 32, 64, 32, 32, (5, 5, 5)), cuda)
    assert torch.equal(conv3d_dw_persample(x, dy, *taps), conv3d_dw_persample(x, dy, *taps))
    assert torch.equal(conv3d_same_persample(dy, wk, transpose_taps=True),
                       conv3d_same_persample(dy, wk, transpose_taps=True))


# K2 and K3's wide instance at every tile K1's wide instance takes (the
# same WIDE_CASES: KC, BN, warpgroups, m64 tiles a warpgroup, 8x8-patch or
# row-segment geometry), forward and transposed. C = 2 KC contraction
# channels, Co = 1.5 BN output channels (one full and one partial Co tile;
# for K3 the forward's Ci), taps (5, 5, 3), depth 3 under 5 taps.
def forced_k23_plan(shape, co, taps, transpose, wgs, mt, kc, bn, stages):
    return dict(conv3d_same_persample_plan(shape, co, taps, transpose), instance="wgmma",
                bm=64 * wgs * mt, mt=mt, bn=bn, kc=kc, stages=stages)


def k23_operands(n, d, h, w, c, co, taps, transpose, cuda, seed, same_x=False):
    """x (the forward's input, or K3's cotangent) with C channels, and the
    forward kernels w (N, taps, Ci, Co) of a conv with ``co`` output
    channels. ``same_x``: one x for every sample, and kernels whose scale
    differs 4x from sample to sample."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn((1 if same_x else n, d, h, w, c), generator=g).expand(n, d, h, w, c)
    ci, cf = (co, c) if transpose else (c, co)
    wk = torch.randn((n, *taps, ci, cf), generator=g) / (c * np.prod(taps)) ** 0.5
    if same_x:
        wk = wk * (4.0 ** torch.arange(n, dtype=wk.dtype)).view(n, 1, 1, 1, 1, 1)
    return x.contiguous().to(cuda, bf), wk.to(cuda, bf)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kc,bn,wgs,mt,geometry", WIDE_CASES)
def test_k23_wide_instance_matches_plain(cuda, kc, bn, wgs, mt, geometry, transpose):
    w = {"patch": 20, "segments": 64 * wgs * mt + 12, "row64": 64}[geometry]
    n, d, h, c, co, taps = 2, 3, 13 if geometry == "patch" else 5, 2 * kc, 3 * bn // 2, (5, 5, 3)
    plan = forced_k23_plan((n, d, h, w, c), co, taps, transpose, wgs, mt, kc, bn,
                           3 + (kc + bn + wgs) % 2)
    x, wk = k23_operands(n, d, h, w, c, co, taps, transpose, cuda, seed=kc + bn + wgs + mt)
    y = conv3d_mod._k23_launch(x, wk, transpose, plan)
    torch.cuda.synchronize()
    ref = conv3d_same_persample_plain(x.double(), wk.double(), transpose_taps=transpose)
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


# (N, D, H, W, C, Co, taps) at which the plan picks the wide instance, with
# taps (5, 3, 3) (the s2d levels') and (3, 5, 1): a reversed-tap or
# tap-index error of K3 changes the result
K23_SAMPLE_CASES = [(4, 4, 16, 16, 32, 64, (5, 3, 3)), (4, 3, 8, 64, 64, 128, (5, 3, 3)),
                    (3, 5, 12, 24, 48, 40, (3, 5, 1))]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", K23_SAMPLE_CASES)
def test_k23_reads_each_samples_kernel(cuda, case, transpose):
    """The same x for every sample and kernels whose scale differs 4x from
    sample to sample: a kernel read for the wrong sample or tap shows in the
    sample's output."""
    n, d, h, w, c, co, taps = case
    assert conv3d_same_persample_plan((n, d, h, w, c), co, taps, transpose)["instance"] == "wgmma"
    x, wk = k23_operands(n, d, h, w, c, co, taps, transpose, cuda, seed=sum(case[:6]),
                         same_x=True)
    before = (conv3d_same_persample.launches, conv3d_same_persample.transpose_launches)
    y = conv3d_same_persample(x, wk, transpose_taps=transpose)
    torch.cuda.synchronize()
    after = (conv3d_same_persample.launches, conv3d_same_persample.transpose_launches)
    assert (after[0] - before[0], after[1] - before[1]) == ((0, 1) if transpose else (1, 0))
    ref = conv3d_same_persample_plain(x.double(), wk.double(), transpose_taps=transpose)
    for i in range(n):
        assert within_tolerance(y[i], ref[i]), (i, (y[i].double() - ref[i]).abs().max().item())


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kc,bn,mt,w", [(16, 128, 1, 24), (32, 64, 2, 128), (64, 32, 1, 96)])
def test_k23_wide_instance_is_deterministic(cuda, kc, bn, mt, w, transpose):
    """Every output is written once from a fixed order of products: two
    launches give the same bits."""
    n, d, h, c, co, taps = 2, 4, 9, 2 * kc, 2 * bn, (5, 5, 5)
    plan = forced_k23_plan((n, d, h, w, c), co, taps, transpose, 2, mt, kc, bn, 3)
    x, wk = k23_operands(n, d, h, w, c, co, taps, transpose, cuda, seed=kc)
    assert torch.equal(conv3d_mod._k23_launch(x, wk, transpose, plan),
                       conv3d_mod._k23_launch(x, wk, transpose, plan))
    assert torch.equal(conv3d_same_persample(x, wk, transpose_taps=transpose),
                       conv3d_same_persample(x, wk, transpose_taps=transpose))


def k23_training_shapes(cfg, batch=8, patch=(32, 128, 128)):
    """(x shape, output channels, taps, transpose) of each distinct K2 and K3
    call of a train step, native and s2d layouts."""
    shapes = set()
    for shape, co in k1_serving_shapes(cfg, batch, patch):  # the native forward convs
        shapes.add((shape, co, (5, 5, 5), False))
        if shape[-1] > 1:  # the input conv's dx is not needed
            shapes.add((shape[:4] + (co,), shape[-1], (5, 5, 5), True))
    c = cfg.in_channels * cfg.mult_chan
    for level, convs in ((1, [(4 * c, 4 * c), (8 * c, 4 * c)]),
                         (2, [(4 * c, 8 * c), (8 * c, 8 * c), (16 * c, 8 * c)])):
        d, h, w = patch[0] >> (level - 1), patch[1] >> level, patch[2] >> level
        for ci, co in convs:
            shapes.add(((batch, d, h, w, ci), co, (5, 3, 3), False))
            shapes.add(((batch, d, h, w, co), ci, (5, 3, 3), True))
    return sorted(shapes)


def test_every_wide_training_shape_plans_wgmma(cuda):
    """At full width every K2 and K3 call of a train step but the 1-channel
    convs and the 2x8x8 bottleneck takes the wgmma instance, compiled without
    spills."""
    shapes = k23_training_shapes(ModelConfig(mult_chan=32, depth=4))
    wide = 0
    for shape, co, taps, transpose in shapes:
        plan = conv3d_same_persample_plan(shape, co, taps, transpose, device=cuda)
        expect = shape[-1] > 1 and co > 1 and shape[2] * shape[3] >= 128
        assert plan["instance"] == ("wgmma" if expect else "mma_sync"), (shape, co, plan)
        assert plan["registers"] > 0 and (plan["local_bytes"] == 0 or not expect), plan
        wide += expect
    assert wide == len(shapes) - 7


# K4's block tiles, one shape each: (N, D, H, W, Ci, Co). The wgmma
# instance takes Ci >= 64 with Co >= 32 (its own tiles below); the mma.sync
# wide instance takes 32x64 (Ci 32: two position groups, 128-position
# chunks), and 32x32 tiles take the narrow instance. W = 70 gives a full and
# a partial 64-position row segment, W = 20 six rows a 128-position chunk
# with H = 7 not a multiple of them, W = 36 three rows, W = 130 three
# 64-position segments; Ci = 72 and Ci = Co = 40 leave a partial channel
# tile.
K4_WIDE_CASES = {
    "64x64": (2, 3, 7, 70, 64, 128),
    "64x32": (2, 3, 7, 20, 72, 32),
    "32x64": (1, 4, 5, 36, 32, 64),
    "32x32": (2, 3, 9, 130, 40, 40),
}
# the instance each case plans: Ci >= 64 went to the wgmma instance
K4_INSTANCE = {"64x64": "wgmma", "64x32": "wgmma", "32x64": "mma_sync", "32x32": "narrow"}


def check_wide_plan(plan, tile, kw):
    assert plan["taps_per_block"] == kw and plan["instance"] == K4_INSTANCE[tile]
    assert plan["wide"] == (tile != "32x32")
    if plan["instance"] == "wgmma":  # 64 input channels, Co's tile: K4_WGMMA_TILES
        assert plan["tile_i"] == 64 and plan["position_groups"] == 1, plan
        return
    assert f"{plan['tile_i']}x{plan['tile_o']}" == tile
    assert plan["position_groups"] == (2 if tile == "32x64" else 1)


@pytest.mark.parametrize("kw", [1, 3, 5])
@pytest.mark.parametrize("tile", sorted(K4_WIDE_CASES))
def test_dw_wide_instances_match_plain(cuda, tile, kw):
    n, d, h, w, ci, co = K4_WIDE_CASES[tile]
    taps = (3, 5, kw)
    check_wide_plan(conv3d_dw_persample_plan((n, d, h, w, ci), co, taps), tile, kw)
    x, _, dy, _ = ps_operands((n, d, h, w, ci, co, taps), cuda)
    before = conv3d_dw_persample.launches
    y = conv3d_dw_persample(x, dy, *taps)
    torch.cuda.synchronize()
    assert conv3d_dw_persample.launches == before + 1
    ref = conv3d_dw_persample_plain(x.double(), dy.double(), *taps)
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


@pytest.mark.parametrize("tile", sorted(K4_WIDE_CASES))
def test_dw_wide_instances_are_deterministic(cuda, tile):
    """Split positions and position groups add in a fixed order: two
    launches give the same bits."""
    ci, co = K4_WIDE_CASES[tile][4:]
    shape = (2, 8, 32, 64, ci)
    plan = conv3d_dw_persample_plan(shape, co, (5, 5, 5))
    check_wide_plan(plan, tile, 5)
    assert plan["splits"] > 1
    x, _, dy, taps = ps_operands((*shape, co, (5, 5, 5)), cuda)
    assert torch.equal(conv3d_dw_persample(x, dy, *taps), conv3d_dw_persample(x, dy, *taps))


# ------------------------------------------------ K4's wgmma instance

@pytest.mark.parametrize("tw", [64, 8])
def test_dw_wgmma_descriptors_one_k16_step(cuda, tw):
    """One block, one k16 step, taps dx = 0..4, through the wgmma
    instance's own descriptors (A = x^T and B = dy, both MN-major without
    swizzle, read with the transpose immediates) against an fp64 matmul: a
    chunk row of 64 columns (the step is 16 positions of one slab row) and
    of 8 (8 positions of each of two rows, pitch * 16 bytes apart)."""
    pitch = tw + 4
    slab_cap = (1 if tw >= 16 else 2) * pitch
    rng = np.random.default_rng(tw)
    bf = torch.bfloat16
    xs = torch.from_numpy(rng.standard_normal((8, slab_cap, 8))).to(cuda, bf)  # chunk, pos, ch
    ys = torch.from_numpy(rng.standard_normal((8, 128, 8))).to(cuda, bf)  # a 128-position chunk
    out = torch.full((5, 64, 64), float("nan"), device=cuda)
    lib = build.load("conv3d_dw_persample")
    err = lib.conv3d_dw_persample_wgmma_unit(xs.data_ptr(), ys.data_ptr(), out.data_ptr(), tw,
                                             pitch, slab_cap, torch.cuda.current_stream().cuda_stream)
    assert err == 0, lib.conv3d_dw_persample_error_string(err).decode()
    torch.cuda.synchronize()
    xt = xs.double().permute(0, 2, 1).reshape(64, slab_cap)  # x^T: (channel, slab position)
    y = ys.double().permute(1, 0, 2).reshape(128, 64)[:16]  # dy: (position, output channel)
    for dx in range(5):
        pos = [(q // tw) * pitch + q % tw + dx for q in range(16)]
        ref = xt[:, pos] @ y
        assert within_tolerance(out[dx], ref), (dx, (out[dx].double() - ref).abs().max().item())


# The wgmma instance's tiles, (Ci, Co) each: warpgroups x Co tile. Ci = 72
# and 136 leave a partial tile of input channels, Co = 96 and 160 one of
# output channels; Co = 160 plans BN 128 at 1 and 3 taps a block, 64 at 5.
K4_WGMMA_TILES = {
    "1x32": (64, 32),
    "1x64": (72, 64),
    "2x64": (136, 96),
    "2x128": (128, 160),
}


def k4_wgmma_case(tile, kw, w):
    ci, co = K4_WGMMA_TILES[tile]
    shape = (2, 3, 5 if w >= 32 else 17, w, ci)  # planes of 128 positions or more
    plan = conv3d_dw_persample_plan(shape, co, (3, 3, kw))
    wgs = 2 if ci >= 128 else 1
    bn = min(int(tile.split("x")[1]), 64 if kw == 5 else 128)
    assert plan["instance"] == "wgmma", plan
    assert (plan["tile_i"], plan["tile_o"], plan["threads"]) == (64 * wgs, bn, 128 * wgs), plan
    assert plan["a_k_stride"] == (128 if w > 8 else (8 + kw - 1) * 16), plan
    return shape, co


@pytest.mark.parametrize("w", [70, 32, 16, 8])
@pytest.mark.parametrize("kw", [1, 3, 5])
@pytest.mark.parametrize("tile", sorted(K4_WGMMA_TILES))
def test_dw_wgmma_tiles_match_plain(cuda, tile, kw, w):
    """Each tile of the wgmma instance at 1, 3 and 5 taps a block, with
    chunk rows of 128 columns (W = 70: one partial segment), 32, 16 and 8
    (H = 17: a partial chunk of rows), depth 3 under 3 taps."""
    shape, co = k4_wgmma_case(tile, kw, w)
    x, _, dy, taps = ps_operands((*shape, co, (3, 3, kw)), cuda)
    before = conv3d_dw_persample.launches
    y = conv3d_dw_persample(x, dy, *taps)
    torch.cuda.synchronize()
    assert conv3d_dw_persample.launches == before + 1
    ref = conv3d_dw_persample_plain(x.double(), dy.double(), *taps)
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


@pytest.mark.parametrize("tile", sorted(K4_WGMMA_TILES))
def test_dw_wgmma_tiles_are_deterministic(cuda, tile):
    """A split over positions adds its partial sums in a fixed order: two
    launches give the same bits."""
    ci, co = K4_WGMMA_TILES[tile]
    taps = (5, 3, 3)
    shape = (2, 8, 32, 64, ci)
    plan = conv3d_dw_persample_plan(shape, co, taps)
    assert plan["instance"] == "wgmma" and plan["splits"] > 1, plan
    x, _, dy, _ = ps_operands((*shape, co, taps), cuda)
    assert torch.equal(conv3d_dw_persample(x, dy, *taps), conv3d_dw_persample(x, dy, *taps))


@pytest.mark.parametrize("taps", [(5, 5, 5), (5, 3, 3)])
def test_dw_wgmma_reads_each_sample(cuda, taps):
    """Sample 1 is sample 0 with x scaled by 4 (exact in bf16 and fp32):
    its dW is 4 times sample 0's, bit for bit, and sample 0's holds the
    plain version."""
    n, d, h, w, ci, co = 2, 4, 8, 32, 128, 128
    g = torch.Generator().manual_seed(11)
    x0 = torch.randn((1, d, h, w, ci), generator=g)
    dy0 = torch.randn((1, d, h, w, co), generator=g)
    x = torch.cat([x0, 4 * x0]).to(cuda, torch.bfloat16)
    dy = torch.cat([dy0, dy0]).to(cuda, torch.bfloat16)
    assert conv3d_dw_persample_plan(x.shape, co, taps)["instance"] == "wgmma"
    y = conv3d_dw_persample(x, dy, *taps)
    torch.cuda.synchronize()
    assert torch.equal(y[1], 4 * y[0])
    assert within_tolerance(y[:1], conv3d_dw_persample_plain(x[:1].double(), dy[:1].double(),
                                                               *taps))


def k4_training_shapes(cfg, batch=8, patch=(32, 128, 128)):
    """(x shape, Co, taps) of each distinct K4 call of a train step, native
    and s2d layouts (K4 takes the forward's x and the cotangent dy)."""
    shapes = {(s, co, t) for s, co, t, transpose in k23_training_shapes(cfg, batch, patch)
              if not transpose}
    c = cfg.in_channels * cfg.mult_chan
    d, h, w = patch[0], patch[1] >> 1, patch[2] >> 1
    shapes.add(((batch, d, h, w, 4), 4 * c, (5, 3, 3)))  # the s2d entry conv (K6's forward)
    return sorted(shapes)


def test_every_wide_training_shape_plans_wgmma_for_k4(cuda):
    """At full width every K4 call of a train step with packed Ci >= 64, Co
    >= 32 and planes of 128 positions or more takes the wgmma instance,
    compiled without spills, the kernel's own plan equal to the host's;
    enc2.conv1 (32 -> 64) and the 2x8x8 bottleneck keep the mma.sync wide
    instance, the 1-channel convs, level 1's 32 -> 32 and the s2d entry conv
    the narrow one."""
    counts = {"wgmma": 0, "mma_sync": 0, "narrow": 0}
    for shape, co, taps in k4_training_shapes(ModelConfig(mult_chan=32, depth=4)):
        plan = conv3d_dw_persample_plan(shape, co, taps, device=cuda)
        cip, cop = plan["packed"][:2]
        expect = ("wgmma" if cip >= 64 and cop >= 32 and shape[2] * shape[3] >= 128 else
                  "mma_sync" if cip >= 32 and cop >= 32 and max(cip, cop) >= 64 else "narrow")
        assert plan["instance"] == expect, (shape, co, plan)
        assert plan["registers"] > 0 and plan["local_bytes"] == 0, plan
        counts[expect] += 1
    assert counts == {"wgmma": 14, "mma_sync": 3, "narrow": 4}, counts


def test_merged_conv_backward_launches_k3_and_k4(cuda):
    x, wk, dy, _ = ps_operands((2, 3, 5, 20, 16, 24, (5, 5, 5)), cuda)
    x.requires_grad_()
    wk.requires_grad_()
    before = (conv3d_same_persample.transpose_launches, conv3d_dw_persample.launches)
    y = MergedConvPerSample.apply(x, wk)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (conv3d_same_persample.transpose_launches, conv3d_dw_persample.launches) == (
        before[0] + 1, before[1] + 1)
    ref_dx = conv3d_same_persample_plain(dy.double(), wk.detach().double(), transpose_taps=True)
    ref_dw = conv3d_dw_persample_plain(x.detach().double(), dy.double(), 5, 5, 5)
    assert x.grad.dtype == torch.bfloat16 and within_tolerance(x.grad, ref_dx)
    # dW is summed in fp32 and returned in the kernels' dtype (bf16), as in JAX
    assert wk.grad.dtype == torch.bfloat16 and within_tolerance(wk.grad, ref_dw)


def test_train_step_runs_through_the_per_sample_kernels(cuda):
    """A small bf16 train step on the card: every MoDE conv's forward, dx
    (but the first conv's) and dW run through K2, K3 and K4; K1 is not used."""
    cfg = Config(model=ModelConfig(mult_chan=4, depth=2, train_s2d=False),
                 data=DataConfig(adopted_datasets=("dna", "lamin_b1")), train=TrainConfig())
    state = create_train_state(cfg, torch.Generator().manual_seed(3), cuda)
    step = make_train_step(cfg, state)
    g = torch.Generator().manual_seed(4)
    sig = torch.randn((2, 16, 32, 32, 1), generator=g)
    batch = {"signal": sig.to(cuda), "target": (0.5 * sig).to(cuda),
             "task": torch.tensor([0, 1], dtype=torch.int32, device=cuda)}
    before = (conv3d_same.launches, conv3d_same_persample.launches,
              conv3d_same_persample.transpose_launches, conv3d_dw_persample.launches)
    m = step(batch)
    torch.cuda.synchronize()
    after = (conv3d_same.launches, conv3d_same_persample.launches,
             conv3d_same_persample.transpose_launches, conv3d_dw_persample.launches)
    convs = 4 * cfg.model.depth + 3
    assert tuple(a - b for a, b in zip(after, before)) == (0, convs, convs - 1, convs)
    assert torch.isfinite(m["loss"]) and int(m["per_task_count"].sum()) == 2
    for name, p in state.net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


# (Ci, Co) of the 19 MoDE convs at mult_chan 32, in the net's order
MERGE_CONVS = [(shape[-1], co) for shape, co in k1_serving_shapes(ModelConfig(), batch=1)]


def merge_operands(n, ci, co, device, seed):
    """Expert parameters (Co,Ci,k,k,k) fp32 and their DHWIO views, a
    softmaxed gate (N,5,Co) and a bf16 per-sample dW (N,5,5,5,Ci,Co)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = [(torch.randn((co, ci) + taps, generator=gen, device=device) / (ci * 125) ** 0.5)
              .requires_grad_() for taps in ((5, 5, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1))]
    g = torch.softmax(2 * torch.randn((n, 5, co), generator=gen, device=device), 1)
    dw = torch.randn((n, 5, 5, 5, ci, co), generator=gen, device=device).to(torch.bfloat16)
    return params, g.requires_grad_(), dw


def merge_on_card(params, g, dw):
    """wn and the six gradients (experts in their parameters' layout, gate)."""
    for p in params + [g]:
        p.grad = None
    ek = tmode.ExpertKernels(*(p.permute(2, 3, 4, 1, 0) for p in params))
    wn = tmode.gate_merge_persample(ek, g, torch.bfloat16)
    wn.backward(dw)
    return wn.detach(), [p.grad for p in params] + [g.grad]


@pytest.mark.parametrize("ci,co", MERGE_CONVS)
def test_gate_merge_kernels_match_plain(cuda, ci, co):
    """The gate-merge kernels at each MoDE conv of mult_chan 32, batch 8,
    against the plain version: wn within one bf16 ulp of the plain fp32
    merge rounded to bf16 (and within half an ulp of the fp64 merge), each
    with a floor of 1e-6 of the largest for the fp32 sums' rounding near
    zero; the six gradients to 1e-5 of the largest,
    against autograd through the fp64 bank and einsum on the same bf16 dW.
    The weights' gradients come in the parameters' layout, contiguous."""
    params, g, dw = merge_operands(8, ci, co, cuda, seed=ci * 1000 + co)
    wn, grads = merge_on_card(params, g, dw)
    assert wn.dtype == torch.bfloat16 and wn.shape == (8, 5, 5, 5, ci, co) and wn.is_contiguous()
    ek = tmode.ExpertKernels(*(p.detach().permute(2, 3, 4, 1, 0) for p in params))
    plain = tmode.gate_merge_persample_plain(ek, g.detach(), torch.bfloat16).float()
    ulp = torch.ldexp(torch.ones_like(plain), torch.frexp(plain.abs().clamp_min(1e-30))[1] - 8)
    # plus a floor for values near zero, where the two fp32 sums' orders differ
    assert bool(((wn.float() - plain).abs() <= ulp + 1e-6 * plain.abs().max()).all())
    leaves = [p.detach().double().requires_grad_() for p in params]
    g64 = g.detach().double().requires_grad_()
    ref = tmode.gate_merge_persample_plain(
        tmode.ExpertKernels(*(p.permute(2, 3, 4, 1, 0) for p in leaves)), g64)
    ref.backward(dw.double())
    top = ref.detach().abs().max()
    assert bool(((wn.double() - ref.detach()).abs() <= 2.0**-8 * ref.detach().abs()
                 + 1e-6 * top).all())
    for k, (got, want) in enumerate(zip(grads, [p.grad for p in leaves] + [g64.grad])):
        assert got.dtype == torch.float32 and got.shape == want.shape and got.is_contiguous(), k
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max()), k


@pytest.mark.parametrize("ci,co", [(32, 32), (512, 512), (32, 1)])
def test_gate_merge_kernels_are_deterministic(cuda, ci, co):
    """Two runs on the same operands give the same bits: wn and every
    gradient (the backward adds the input-channel groups' shares in order)."""
    params, g, dw = merge_operands(8, ci, co, cuda, seed=7)
    wn1, grads1 = merge_on_card(params, g, dw)
    grads1 = [x.clone() for x in grads1]
    wn2, grads2 = merge_on_card(params, g, dw)
    assert torch.equal(wn1, wn2)
    assert all(torch.equal(a, b) for a, b in zip(grads1, grads2))


def test_train_step_runs_the_gate_merge_kernels(cuda, monkeypatch):
    """A bf16 train step at mult_chan 32 (patch 16x32x32, batch 2): the
    gate-merge kernels launch 19 times each way, and no expert bank is
    formed on the card's route."""
    def no_bank(*a, **k):
        raise AssertionError("expert_bank called on the card's training route")

    monkeypatch.setattr(tmode, "expert_bank", no_bank)
    cfg = Config(model=ModelConfig(train_s2d=False),
                 data=DataConfig(adopted_datasets=("dna", "lamin_b1")), train=TrainConfig())
    state = create_train_state(cfg, torch.Generator().manual_seed(5), cuda)
    step = make_train_step(cfg, state)
    g = torch.Generator().manual_seed(6)
    sig = torch.randn((2, 16, 32, 32, 1), generator=g)
    batch = {"signal": sig.to(cuda), "target": (0.5 * sig).to(cuda),
             "task": torch.tensor([0, 1], dtype=torch.int32, device=cuda)}
    merge = tmode.gate_merge_persample
    before = (merge.launches, merge.backward_launches)
    m = step(batch)
    torch.cuda.synchronize()
    assert (merge.launches - before[0], merge.backward_launches - before[1]) == (19, 19)
    assert torch.isfinite(m["loss"])
    for name, p in state.net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("s2d", [False, True])
def test_expert_sum_train_step_on_the_card(cuda, s2d):
    """train_impl 'expert_sum' trains on the card (mult_chan 8, bf16): its
    convs go through conv3d_same_autograd, so no K1 and no per-sample kernel
    runs, and every parameter gets a finite gradient."""
    cfg = Config(model=ModelConfig(mult_chan=8, depth=2, train_s2d=s2d, train_impl="expert_sum"),
                 data=DataConfig(adopted_datasets=("dna", "lamin_b1")), train=TrainConfig())
    state = create_train_state(cfg, torch.Generator().manual_seed(11), cuda)
    step = make_train_step(cfg, state)
    g = torch.Generator().manual_seed(12)
    sig = torch.randn((2, 16, 32, 32, 1), generator=g)
    batch = {"signal": sig.to(cuda), "target": (0.5 * sig).to(cuda),
             "task": torch.tensor([0, 1], dtype=torch.int32, device=cuda)}
    counters = lambda: (conv3d_same.launches, conv3d_same_persample.launches,
                        conv3d_same_persample.transpose_launches, conv3d_dw_persample.launches)
    before = counters()
    m = step(batch)
    torch.cuda.synchronize()
    assert counters() == before
    assert torch.isfinite(m["loss"])
    for name, p in state.net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


# ---------------------------------------------- the depth-padded chain K5

# (N, D, H, W, Ci, Co, kD, epilogue): W below 64, above 128 with a partial
# tile, H not a multiple of a tile's rows, Co tiles > 1, kD 3 and 5, and the
# full-width decoder_block1.conv1 shape (batch 2 keeps the fp64 check cheap).
DPAD_CASES = [
    (1, 2, 4, 8, 128, 128, 3, "bias_relu"),
    (2, 3, 6, 20, 128, 256, 5, "bias"),
    (1, 1, 9, 130, 256, 128, 5, "none"),
    (2, 4, 5, 48, 384, 128, 3, "bias_relu"),
    (2, 32, 64, 64, 256, 128, 5, "bias_relu"),
]


def dpad_operands(case, cuda):
    n, d, h, w, ci, co, kd, epilogue = case
    pd = (kd - 1) // 2
    g = torch.Generator().manual_seed(hash(case) % 2**31)
    x = torch.zeros((n, d + 2 * pd, h, w, ci), dtype=torch.bfloat16)
    x[:, pd:pd + d] = torch.randn((n, d, h, w, ci), generator=g).to(torch.bfloat16)
    wk = (torch.randn((kd, 3, 3, ci, co), generator=g) / (kd * 9 * ci) ** 0.5).to(torch.bfloat16)
    b = torch.randn((co,), generator=g) if epilogue != "none" else None
    return x.to(cuda), wk.to(cuda), None if b is None else b.to(cuda), epilogue == "bias_relu", pd


@pytest.mark.parametrize("case", DPAD_CASES)
def test_dpad_kernel_matches_plain(cuda, case):
    x, wk, b, relu, pd = dpad_operands(case, cuda)
    before = conv3d_dpad.launches
    y = conv3d_dpad(x, wk, b, relu=relu)
    torch.cuda.synchronize()
    assert conv3d_dpad.launches == before + 1
    ref = conv3d_dpad_plain(x.double(), wk.double(), None if b is None else b.double(), relu=relu)
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert bool((y[:, :pd] == 0).all()) and bool((y[:, -pd:] == 0).all())
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


def test_dpad_kernel_chain_reads_its_own_halo(cuda):
    """The second conv reads the first's output, halo rows included, as it
    stands; each is held against the plain version on its own input."""
    x, wk, b, _, pd = dpad_operands((2, 4, 8, 16, 128, 128, 5, "bias_relu"), cuda)
    y1 = conv3d_dpad(x, wk, b, relu=True)
    y2 = conv3d_dpad(y1, wk, b, relu=True)
    for y, inp in ((y1, x), (y2, y1)):
        ref = conv3d_dpad_plain(inp.double(), wk.double(), b.double(), relu=True)
        assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()
    assert bool((y2[:, :pd] == 0).all()) and bool((y2[:, -pd:] == 0).all())


# K5's wide instance through forced plans: (N, D, H, W, Ci, Co, kD,
# warpgroups, epilogue). Row mode at W = 64 and at W = 130 (one full and
# one partial tile row), patch mode at W = 32 (H = 13: a partial tile), W =
# 40 and W = 12 (a partial column block); one and two warpgroups in both
# modes; BN 128 with one, two and three Co tiles; kD 3 and 5; every
# epilogue.
K5_WIDE_CASES = [
    (2, 3, 5, 64, 256, 128, 5, 2, "bias_relu"),
    (1, 2, 3, 130, 128, 256, 3, 2, "bias"),
    (2, 3, 13, 32, 128, 256, 5, 2, "none"),
    (1, 3, 4, 130, 128, 128, 3, 1, "bias_relu"),
    (2, 2, 9, 12, 128, 256, 5, 1, "bias"),
    (1, 2, 5, 64, 256, 384, 5, 1, "bias_relu"),
    (2, 2, 6, 40, 128, 128, 3, 1, "none"),
]


def forced_k5_plan(shape, co, kd, wgs, stages):
    """The wide instance at a chosen number of warpgroups and ring depth."""
    return dict(conv3d_dpad_plan(shape, co, (kd, 3, 3)), instance="wgmma", bm=64 * wgs, mt=1,
                bn=128, kc=32, stages=stages)


@pytest.mark.parametrize("stages", [3, 4])
@pytest.mark.parametrize("case", K5_WIDE_CASES)
def test_k5_wide_instance_matches_plain(cuda, case, stages):
    """Each tile of the wide instance against the fp64 plain version, with
    rings of 3 and 4 stages."""
    n, d, h, w, ci, co, kd, wgs, epilogue = case
    x, wk, b, relu, pd = dpad_operands((n, d, h, w, ci, co, kd, epilogue), cuda)
    plan = forced_k5_plan(tuple(x.shape), co, kd, wgs, stages)
    y = conv3d_mod._k5_launch(x, wk, b, relu, plan)
    torch.cuda.synchronize()
    ref = conv3d_dpad_plain(x.double(), wk.double(), None if b is None else b.double(), relu=relu)
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert bool((y[:, :pd] == 0).all()) and bool((y[:, -pd:] == 0).all())
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


# (N, D, H, W, Ci, Co, kD, epilogue) planned wide in row and in patch mode,
# and narrow (a plane under 128 positions)
K5_HALO_CASES = [(2, 3, 4, 64, 128, 256, 5, "bias_relu"), (1, 2, 8, 40, 256, 128, 3, "bias"),
                 (2, 2, 4, 8, 128, 128, 5, "bias_relu")]


@pytest.mark.parametrize("case", K5_HALO_CASES)
def test_k5_writes_its_halo_rows(cuda, case):
    """The output's memory first holds NaN (a freed NaN tensor of its size,
    which the caching allocator hands back): the kernel itself writes the
    halo rows' zeros, and every interior value."""
    x, wk, b, relu, pd = dpad_operands(case, cuda)
    n, dp, h, w = x.shape[:4]
    junk = torch.full((n, dp, h, w, wk.shape[-1]), float("nan"), dtype=torch.bfloat16,
                      device=cuda)
    junk_ptr = junk.data_ptr()
    del junk
    y = conv3d_dpad(x, wk, b, relu=relu)
    torch.cuda.synchronize()
    assert y.data_ptr() == junk_ptr  # the check below reads memory that held NaN
    assert bool((y[:, :pd] == 0).all()) and bool((y[:, -pd:] == 0).all())
    assert bool(torch.isfinite(y).all())
    ref = conv3d_dpad_plain(x.double(), wk.double(), b.double(), relu=relu)
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


def test_k5_is_deterministic(cuda):
    """Every output is written once from a fixed order of products: two
    launches, and rings of 3 and 4 stages, give the same bits."""
    x, wk, b, relu, _ = dpad_operands((2, 4, 9, 64, 256, 256, 5, "bias_relu"), cuda)
    shape, co = tuple(x.shape), wk.shape[-1]
    y1 = conv3d_dpad(x, wk, b, relu=relu)
    assert torch.equal(y1, conv3d_dpad(x, wk, b, relu=relu))
    plan = conv3d_dpad_plan(shape, co, (5, 3, 3))
    assert plan["instance"] == "wgmma" and plan["grid"] == [plan["blocks"], 1]
    for stages in (3, 4):
        forced = forced_k5_plan(shape, co, 5, 2, stages)
        assert torch.equal(conv3d_mod._k5_launch(x, wk, b, relu, forced), y1)


def k5_serving_shapes(cfg, batch=8, patch=(32, 128, 128)):
    """(depth-padded x shape, Co) of each K5 call of plain_forward_s2d_pallas
    (levels 1 and 2 in s2d channels; encoder_block1.conv1 runs on K1)."""
    c = [4 * cfg.in_channels * cfg.mult_chan * 2**i for i in range(2)]
    out = []
    for level, convs in ((1, [(c[0], c[0]), (2 * c[0], c[0]), (c[0], c[0])]),
                         (2, [(c[0], c[1]), (c[1], c[1]), (2 * c[1], c[1]), (c[1], c[1])])):
        d, h, w = patch[0] >> (level - 1), patch[1] >> level, patch[2] >> level
        out += [((batch, d + 4, h, w, ci), co) for ci, co in convs]
    return out


def test_every_k5_serving_shape_plans_wgmma(cuda):
    """At full width the 7 K5 calls (5 distinct shapes) take the wgmma
    instance, compiled without spills, at two blocks an SM."""
    shapes = k5_serving_shapes(ModelConfig(mult_chan=32, depth=4))
    assert len(shapes) == 7 and len(set(shapes)) == 5
    for shape, co in shapes:
        plan = conv3d_dpad_plan(shape, co, (5, 3, 3), device=cuda)
        assert plan["instance"] == "wgmma", (shape, co, plan)
        assert plan["registers"] > 0 and plan["local_bytes"] == 0, (shape, co, plan)
        assert plan["smem_bytes"] <= 113 * 1024, plan


def test_dpad_kernel_refuses_autograd(cuda):
    x, wk, b, _, _ = dpad_operands(DPAD_CASES[0], cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        conv3d_dpad(x, wk.requires_grad_(), b, relu=True)


@pytest.mark.parametrize("bad", ["ci_64", "kh_5", "fp32_x"])
def test_dpad_kernel_refuses_other_geometry(cuda, bad):
    """On the card the wrapper raises, and never runs the plain version."""
    x, wk, b, _, _ = dpad_operands(DPAD_CASES[0], cuda)
    if bad == "ci_64":
        x, wk = x[..., :64].contiguous(), wk[:, :, :, :64].contiguous()
    elif bad == "kh_5":
        wk = torch.zeros((3, 5, 3, 128, 128), dtype=torch.bfloat16, device=cuda)
    else:
        x = x.float()
    before = conv3d_dpad.launches
    with pytest.raises(ValueError):
        conv3d_dpad(x, wk, b, relu=True)
    assert conv3d_dpad.launches == before


def s2d_net(cuda):
    cfg = ModelConfig(mult_chan=32, depth=2, train_s2d=False)
    net = RepModeNet(cfg, 2, generator=torch.Generator().manual_seed(7), device=cuda).eval()
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_((torch.rand(buf.shape, generator=g) - 0.5) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 0.3 + 0.3)
    return cfg, net.state_dict()


def test_s2d_routes_on_the_card(cuda, monkeypatch):
    """The K5 route against the XLA s2d route (both through the kernels) and
    against itself with the plain versions patched in; K5 runs 7 times."""
    cfg, state = s2d_net(cuda)
    levels = reparam.default_s2d_levels(cfg)
    plain2 = reparam.to_s2d_plain(reparameterize(state, cfg, 2, 1), cfg, levels)
    x = torch.randn((2, 16, 32, 32, 1), generator=torch.Generator().manual_seed(9)).to(cuda)
    bf = torch.bfloat16
    before = (conv3d_same.launches, conv3d_dpad.launches)
    y = reparam.plain_forward_s2d_pallas(plain2, x, cfg, levels, compute_dtype=bf)
    assert (conv3d_same.launches - before[0], conv3d_dpad.launches - before[1]) == (4, 7)
    y_xla = reparam.plain_forward_s2d(plain2, x, cfg, levels, compute_dtype=bf)
    monkeypatch.setattr(reparam, "conv3d_same", conv3d_same_plain)
    monkeypatch.setattr(reparam, "conv3d_dpad", conv3d_dpad_plain)
    ref = reparam.plain_forward_s2d_pallas(plain2, x, cfg, levels, compute_dtype=bf)
    for other in (y_xla, ref):
        rel = ((y - other).norm() / other.norm()).item()
        assert torch.isfinite(y).all() and rel <= 1e-2, rel


def test_two_phase_equals_fused_on_the_card(cuda):
    cfg, state = s2d_net(cuda)
    kw = dict(s2d=True, pallas_conv=True, patch_size=(16, 32, 32))
    c = Config(model=cfg, data=DataConfig(adopted_datasets=("dna", "lamin_b1")),
               train=TrainConfig(batch_size_eval=2), eval=EvalConfig(**kw))
    plain = reparam.make_inference(c)[0](state, 0)
    vol = torch.randn((16, 48, 48), generator=torch.Generator().manual_seed(10))
    before = conv3d_dpad.launches
    fused = TiledPredictor(c)(plain, vol)
    assert conv3d_dpad.launches > before
    two = TiledPredictor(c, mode="two_phase")(plain, vol)
    assert torch.isfinite(fused).all() and torch.equal(fused, two)


# ----------------------------------------------- the tap-concat entry conv K6

# (N, D, H, W, Co): the full-width training shape (K6's main use), W below
# the 128-position tile with H not a multiple of its rows, W above it with a
# partial tile, Co below 8, Co above one 128-wide block; then the wgmma
# instance's tiles: rows of 64 columns (H = 5: a partial last tile) and of
# 128, 8x8 patches at W = 8 and 16 (H = 20: a partial band of 16 rows), Co
# = 32, 64 and 256, and W = 100 and 200 (a partial column tile) with Co = 96
# and 160 (a partial Co tile)
K6_CASES = [
    (8, 32, 64, 64, 128),
    (2, 4, 8, 8, 8),
    (3, 5, 12, 20, 24),
    (1, 3, 2, 130, 4),
    (2, 6, 6, 16, 136),
    (2, 3, 5, 64, 64),
    (2, 3, 3, 128, 256),
    (2, 4, 16, 8, 32),
    (1, 3, 20, 16, 128),
    (2, 2, 9, 100, 96),
    (1, 2, 4, 200, 160),
]


@pytest.mark.parametrize("case", K6_CASES)
def test_tapconcat_kernel_matches_plain(cuda, case):
    n, d, h, w, co = case
    g = torch.Generator().manual_seed(hash(case) % 2**31)
    bf = torch.bfloat16
    x = torch.randn((n, d, h, w, 4), generator=g).to(cuda, bf)
    wn = (torch.randn((n, 180, co), generator=g) / 180 ** 0.5).to(cuda, bf)
    before = conv3d_tapconcat_persample.launches
    y = conv3d_tapconcat_persample(x, wn)
    torch.cuda.synchronize()
    assert conv3d_tapconcat_persample.launches == before + 1
    idx = [0, n - 1]  # samples are independent: two keep the fp64 check cheap
    ref = conv3d_tapconcat_persample_plain(x[idx].double(), wn[idx].double())
    assert y.shape == (n, d, h, w, co) and y.dtype == bf
    assert within_tolerance(y[idx], ref), (y[idx].double() - ref).abs().max().item()


def k6_operands(shape, cuda, seed=0):
    n, d, h, w, co = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d, h, w, 4), generator=g).to(cuda, torch.bfloat16)
    wn = (torch.randn((n, 180, co), generator=g) / 180 ** 0.5).to(cuda, torch.bfloat16)
    return x, wn


@pytest.mark.parametrize("tw", [64, 8])
def test_tapconcat_wgmma_descriptors_one_k16_step(cuda, tw):
    """One block, the k16 steps of groups (dz 0, dy 0..2), through the wgmma
    instance's own descriptors and weight map against an fp64 matmul: A the
    paired slab, K-major without swizzle, K 8-15 two entries (32 bytes)
    after K 0-7; B the weights loaded in place through their 5-D map,
    MN-major in the 128-byte swizzle, two atoms of 64 Co, tap dx 3
    zero-filled by the map. A tile of 2 rows of 64 columns, and one of 16
    rows of 8 (8x8 patches: core matrices a slab row apart)."""
    rows, p2 = 128 // tw, tw + 2
    rng = np.random.default_rng(tw)
    bf = torch.bfloat16
    s2 = torch.from_numpy(rng.standard_normal((rows + 2, p2, 8))).to(cuda, bf)
    wn = torch.from_numpy(rng.standard_normal((1, 180, 128))).to(cuda, bf)
    out = torch.full((3, 128, 128), float("nan"), device=cuda)
    lib = build.load("conv3d_tapconcat")
    err = lib.conv3d_tapconcat_wgmma_unit(s2.data_ptr(), wn.data_ptr(), out.data_ptr(), tw,
                                          torch.cuda.current_stream().cuda_stream)
    assert err == 0, lib.conv3d_tapconcat_error_string(err).decode()
    torch.cuda.synchronize()
    s, w = s2.double(), wn[0].double()
    q = torch.arange(128, device=cuda)
    r, c = q // tw, q % tw
    for dy in range(3):
        a = torch.cat([s[r + dy, c], s[r + dy, c + 2]], dim=1)  # (position, K = 16)
        b = torch.zeros((16, 128), dtype=torch.float64, device=cuda)
        b[:12] = w[12 * dy:12 * dy + 12]  # group (0, dy): taps dx 0..2 x 4 lanes
        ref = a @ b
        assert within_tolerance(out[dy], ref), (dy, (out[dy].double() - ref).abs().max().item())


def test_tapconcat_full_width_is_deterministic(cuda):
    """The full-width shape on the wgmma instance: two calls give the same
    bits."""
    x, wn = k6_operands(K6_CASES[0], cuda)
    assert conv3d_tapconcat_persample_plan(x.shape, 128)["instance"] == "wgmma"
    assert torch.equal(conv3d_tapconcat_persample(x, wn), conv3d_tapconcat_persample(x, wn))


def test_tapconcat_reads_each_samples_weights(cuda):
    """Sample 1 is sample 0 with x and w each scaled by 4 (exact in bf16 and
    fp32): its y is 16 times sample 0's, bit for bit; sample 2 is drawn
    apart; all hold the plain version. Persistent blocks over 1, 2 and 5
    SMs, whose tile ranges cross samples and reload the weights, give the
    same bits as the card's own plan."""
    n, d, h, w, co = 3, 4, 6, 64, 128
    x0, w0 = k6_operands((1, d, h, w, co), cuda, seed=12)
    x2, w2 = k6_operands((1, d, h, w, co), cuda, seed=13)
    x, wn = torch.cat([x0, 4 * x0, x2]), torch.cat([w0, 4 * w0, w2])
    plan = conv3d_tapconcat_persample_plan(x.shape, co, device=cuda)
    assert plan["instance"] == "wgmma" and plan["local_bytes"] == 0, plan
    y = conv3d_tapconcat_persample(x, wn)
    torch.cuda.synchronize()
    assert torch.equal(y[1], 16 * y[0])
    assert within_tolerance(y, conv3d_tapconcat_persample_plain(x.double(), wn.double()))
    for sms in (1, 2, 5):
        p = conv3d_tapconcat_persample_plan(x.shape, co, num_sms=sms)
        assert p["blocks"] == sms and p["weight_loads"] > 1, p
        assert torch.equal(conv3d_mod._k6_launch(x, wn, co, p), y), sms


@pytest.mark.parametrize("case", [(2, 4, 8, 64, 128), (2, 3, 16, 8, 64)])
def test_tapconcat_instances_agree(cuda, case):
    """The mma.sync instance, forced at shapes the wgmma one takes, holds
    the plain version too."""
    x, wn = k6_operands(case, cuda, seed=5)
    plan = conv3d_tapconcat_persample_plan(x.shape, case[-1], device=cuda)
    assert plan["instance"] == "wgmma", plan
    y = conv3d_mod._k6_launch(x, wn, case[-1], dict(plan, instance="mma_sync"))
    torch.cuda.synchronize()
    assert within_tolerance(y, conv3d_tapconcat_persample_plain(x.double(), wn.double()))


def test_every_k6_case_plans_without_spills(cuda):
    """The full-width shape plans the wgmma instance (at most 2 weight loads
    a block); every K6 case's plan holds the kernel's own shared memory and
    grid, and the wgmma instance compiles without spills (the mma.sync
    kernel spills 24 bytes a thread, as it did)."""
    plan = conv3d_tapconcat_persample_plan(K6_CASES[0][:4] + (4,), 128, device=cuda)
    assert plan["instance"] == "wgmma" and plan["weight_loads"] <= 2, plan
    for n, d, h, w, co in K6_CASES:
        plan = conv3d_tapconcat_persample_plan((n, d, h, w, 4), co, device=cuda)
        assert plan["registers"] > 0, plan
        assert plan["instance"] == "mma_sync" or plan["local_bytes"] == 0, plan


def test_tapconcat_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 2, 4, 4, 4), device=cuda)
    wn = torch.zeros((1, 180, 8), device=cuda)
    before = conv3d_tapconcat_persample.launches
    with pytest.raises(ValueError, match="bfloat16"):
        conv3d_tapconcat_persample(x, wn)  # fp32 compute
    with pytest.raises(ValueError, match="4-channel"):
        conv3d_tapconcat_persample(torch.zeros((1, 2, 4, 4, 8), device=cuda, dtype=torch.bfloat16),
                                   torch.zeros((1, 360, 8), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="taps"):
        conv3d_tapconcat_persample(x.bfloat16(), torch.zeros((1, 108, 8), device=cuda))
    assert conv3d_tapconcat_persample.launches == before


# the s2d training convs at 45 taps: level 1 (w' = 64, two rows per tile) and
# the level-2 decoder concat (4Ci = 512)
S2D_PS_CASES = [
    (2, 4, 16, 64, 128, 128, (5, 3, 3)),
    (2, 3, 8, 32, 512, 256, (5, 3, 3)),
]


@pytest.mark.parametrize("case", S2D_PS_CASES)
def test_merged_conv_at_s2d_shapes(cuda, case):
    """MergedConvPerSample at 45-tap s2d shapes: y (K2), dx (K3), dW (K4)."""
    x, wk, dy, taps = ps_operands(case, cuda)
    x.requires_grad_()
    wk.requires_grad_()
    y = MergedConvPerSample.apply(x, wk)
    y.backward(dy)
    torch.cuda.synchronize()
    xd, wd = x.detach().double(), wk.detach().double()
    assert within_tolerance(y.detach(), conv3d_same_persample_plain(xd, wd))
    assert within_tolerance(x.grad, conv3d_same_persample_plain(dy.double(), wd,
                                                                 transpose_taps=True))
    # dW is summed in fp32 and returned in the kernels' dtype (bf16), as in JAX
    assert wk.grad.dtype == torch.bfloat16
    assert within_tolerance(wk.grad, conv3d_dw_persample_plain(xd, dy.double(), *taps))


def test_s2d_train_step_at_full_width(cuda):
    """One full-width bf16 train step in the s2d layout (the default Config,
    batch 8 of 32x128x128): K6 once, K2 and K3 17 times, K4 18 times, a
    finite loss and a finite gradient for every parameter."""
    tasks = ("dna", "lamin_b1", "tom20", "zo1")
    cfg = Config(data=DataConfig(adopted_datasets=tasks))
    assert cfg.model.train_s2d and cfg.model.mult_chan == 32
    state = create_train_state(cfg, torch.Generator().manual_seed(5), cuda)
    step = make_train_step(cfg, state)
    g = torch.Generator().manual_seed(6)
    sig = torch.randn((8, 32, 128, 128, 1), generator=g)
    batch = {"signal": sig.to(cuda), "target": (0.5 * sig).to(cuda),
             "task": (torch.arange(8) % 4).int().to(cuda)}
    counters = lambda: (conv3d_tapconcat_persample.launches, conv3d_same_persample.launches,
                        conv3d_same_persample.transpose_launches, conv3d_dw_persample.launches,
                        conv3d_same.launches)
    before = counters()
    m = step(batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counters(), before)) == (1, 17, 17, 18, 0)
    assert torch.isfinite(m["loss"])
    for name, p in state.net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_s2d_eval_net_runs_the_expert_sum_through_k1(cuda, monkeypatch):
    """The eval-mode net in the s2d layout (mult_chan 8: levels 1 and 2; bf16
    compute, which K1 needs) under no_grad: five K1 launches per s2d or
    native MoDE conv, the tap-major conv_out, and the output against the
    same net with the plain conv."""
    from repmode_tpu_torch.ops import mode as mode_ops

    net = RepModeNet(ModelConfig(mult_chan=8, depth=2), 2, compute_dtype="bfloat16",
                     generator=torch.Generator().manual_seed(9), device=cuda).eval()
    x = torch.randn((2, 8, 32, 32, 1), generator=torch.Generator().manual_seed(10)).to(cuda)
    task = torch.tensor([1, 1], device=cuda)
    before = conv3d_same.launches
    with torch.no_grad():
        y = net(x, task)
        torch.cuda.synchronize()
        launches = conv3d_same.launches - before
        monkeypatch.setattr(mode_ops, "conv3d_same", conv3d_same_plain)
        ref = net(x, task)
    assert launches == 5 * (4 * 2 + 2)  # conv_out runs tap-major, without K1
    assert y.shape == ref.shape == (2, 8, 32, 32, 1) and torch.isfinite(y).all()
    assert float((y - ref).norm() / ref.norm()) <= 1e-2


def test_train_loop_h2d_does_not_wait_for_queued_work(cuda):
    """``train/loop._h2d`` returns while the card still runs earlier work
    (a pageable copy would wait for it), and the batch arrives intact."""
    from repmode_tpu_torch.train import loop

    a = np.random.default_rng(0).standard_normal((8, 32, 64, 64, 1), dtype=np.float32)
    loop._h2d(a, cuda)  # warm the pinned pool
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at H100 clocks
    t = loop._h2d(a, cuda)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy, "the copy waited for the queued work"
    assert t.device.type == "cuda" and torch.equal(t.cpu(), torch.from_numpy(a))
