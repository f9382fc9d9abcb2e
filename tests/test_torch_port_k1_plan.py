"""K1's launch plan and weight layout, on the CPU (no card).

``conv3d_same_plan`` decides the instance (warpgroup MMA or mma.sync), the
tile, the input channels a stage, the ring and the grid of every K1 launch;
``_k1_weights`` lays the weights out for the instance. Here the plan is held
to what the kernel source accepts at every K1 call of the serving paths at
full width (mult_chan 32, depth 4, batch 8 of 32x128x128): ``plain_forward``,
both space-to-depth routes and the eval-mode expert sums, native and s2d.
The calls are recorded on the meta device, so no activation is computed. The
weight repack is held to ``conv3d_same_plain`` in fp64.
"""

import numpy as np
import pytest
import torch

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models import reparam
from repmode_tpu_torch.models import repmode as repmode_mod
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops import mode as mode_mod
from repmode_tpu_torch.ops.conv3d import conv3d_same_plain, conv3d_same_plan

torch.set_num_threads(2)

META = torch.device("meta")
SMS = 132  # an H100 SXM
SMEM_MAX = 227 * 1024
TWO_BLOCKS = 113 * 1024


def meta_net(monkeypatch, train_s2d: bool, num_tasks: int = 2):
    """The full-width net with its parameters on the meta device."""
    monkeypatch.setattr(repmode_mod, "resolve_device", lambda device: META)
    cfg = ModelConfig(mult_chan=32, depth=4, train_s2d=train_s2d)
    return cfg, repmode_mod.RepModeNet(cfg, num_tasks, device="cpu").eval()


def recorder(calls):
    """A stand-in for conv3d_same that records (x shape, Co, taps, out
    dtype) and returns an empty meta tensor of the output's shape."""
    def conv(x, w, bias=None, *, relu=False, compute_dtype=None, out_dtype=None):
        odt = out_dtype or torch.promote_types(x.dtype, torch.float32)
        calls.append((tuple(x.shape), int(w.shape[-1]), tuple(w.shape[:3]), odt))
        return torch.empty((*x.shape[:4], w.shape[-1]), dtype=odt, device=META)
    return conv


def dpad_stub(x, w, bias=None, *, relu=False, compute_dtype=None):
    return torch.empty((*x.shape[:4], w.shape[-1]), dtype=torch.bfloat16, device=META)


def k1_calls(monkeypatch, route):
    """Every K1 call one batch of 8 patches makes on ``route``."""
    calls = []
    x = torch.empty((8, 32, 128, 128, 1), device=META)
    bf = torch.bfloat16
    if route.startswith("expert_sum"):
        cfg, net = meta_net(monkeypatch, train_s2d=route == "expert_sum_s2d")
        monkeypatch.setattr(mode_mod, "conv3d_same", recorder(calls))
        with torch.no_grad():
            net(x, torch.zeros((8,), dtype=torch.long, device=META))
        return calls
    cfg, net = meta_net(monkeypatch, train_s2d=False)
    monkeypatch.setattr(reparam, "conv3d_same", recorder(calls))
    monkeypatch.setattr(reparam, "conv3d_dpad", dpad_stub)
    plain = reparam.reparameterize(net.state_dict(), cfg, 2, 0)
    levels = reparam.default_s2d_levels(cfg)
    with torch.no_grad():
        if route == "native":
            reparam.plain_forward(plain, x, cfg, compute_dtype=bf)
        else:
            plain2 = reparam.to_s2d_plain(plain, cfg, levels)
            fwd = reparam.plain_forward_s2d if route == "xla_s2d" else \
                reparam.plain_forward_s2d_pallas
            fwd(plain2, x, cfg, levels, compute_dtype=bf)
    return calls


# launches a batch: 19 native, 20 on the XLA s2d route (each s2d decoder conv1
# is two calls, conv_out the tap-major matmul), 12 on the K5 route; the
# expert sums run five expert convs for each of the 19 MoDE convs (18 in the
# s2d layout, whose conv_out is the tap-major matmul)
ROUTES = {"native": 19, "xla_s2d": 20, "k5": 12, "expert_sum": 95, "expert_sum_s2d": 90}


@pytest.fixture(scope="module")
def calls_by_route():
    out = {}
    for route in ROUTES:
        with pytest.MonkeyPatch.context() as mp:
            out[route] = k1_calls(mp, route)
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plan_covers_every_k1_call_at_full_width(calls_by_route, route):
    calls = calls_by_route[route]
    assert len(calls) == ROUTES[route]
    wide = 0
    for shape, co, taps, odt in calls:
        plan = conv3d_same_plan(shape, co, taps, odt)
        n, d, h, w, _ = shape
        cip, kw = plan["packed"]
        assert plan["smem_bytes"] <= SMEM_MAX, (shape, co, taps, plan)
        assert plan["co_pad"] % plan["bn"] == 0 and plan["co_pad"] >= co
        assert plan["ci_pad"] % plan["kc"] == 0 and plan["ci_pad"] >= cip
        assert plan["blocks"] == plan["grid"][0] * plan["grid"][1]
        expect_wide = cip >= 16 and co >= 32 and h * w >= 128
        assert plan["instance"] == ("wgmma" if expect_wide else "mma_sync"), (shape, co, plan)
        if plan["instance"] != "wgmma":
            continue
        wide += 1
        assert plan["stages"] in (3, 4) and plan["kc"] in (16, 32, 64)
        assert plan["bn"] in (32, 64, 128) and plan["mt"] in (1, 2, 4)
        assert plan["bm"] // (64 * plan["mt"]) in (1, 2)
        # at least 3/4 of a wave of blocks, unless the tile cannot shrink
        assert plan["blocks"] >= SMS * 3 // 4 or (plan["bm"], plan["bn"]) == (64, 32), plan
        # 4 stages only where they fit as many blocks an SM as 3 would
        three = (plan["smem_bytes"] - 1024) // plan["stages"] * 3 + 1024
        if plan["stages"] == 4:
            assert (plan["smem_bytes"] <= TWO_BLOCKS) == (three <= TWO_BLOCKS), plan
    assert wide > 0


def test_every_wide_serving_conv_of_the_native_route_plans_wgmma(calls_by_route):
    """15 of the 19 convs: all but the 1-channel input conv, conv_out and
    the two 2x8x8 bottleneck convs."""
    calls = calls_by_route["native"]
    instances = [conv3d_same_plan(s, co, t, o)["instance"] for s, co, t, o in calls]
    assert instances.count("wgmma") == 15
    narrow = [s for (s, co, t, o), i in zip(calls, instances) if i == "mma_sync"]
    assert narrow == [(8, 32, 128, 128, 1), (8, 2, 8, 8, 256), (8, 2, 8, 8, 512),
                      (8, 32, 128, 128, 32)]


@pytest.mark.parametrize("ci,kw", [(1, 5), (3, 3), (4, 3), (8, 5), (12, 1), (24, 5), (40, 3)])
def test_plan_packs_channels_as_the_wrapper_does(ci, kw):
    x = torch.zeros((1, 2, 3, 4, ci))
    w = torch.zeros((3, 3, kw, ci, 8))
    xp, wp = conv3d_mod._to_multiple_of_8_channels(x, w)
    plan = conv3d_same_plan(tuple(x.shape), 8, (3, 3, kw))
    assert plan["packed"] == [xp.shape[-1], wp.shape[2]]


def conv_through_layout(x, wp, plan, taps, ci, co):
    """'same' conv of x (N,D,H,W,Ci) computed tap by tap from the padded
    weights of ``plan``'s layout: (taps, co_pad, ci_pad) for wgmma, (taps,
    ci_pad, co_pad) for mma_sync."""
    kd, kh, kw = taps
    n, d, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2, kd // 2, kd // 2))
    y = torch.zeros((n, d, h, w, co), dtype=x.dtype)
    t = 0
    for a in range(kd):
        for b in range(kh):
            for c in range(kw):
                wt = wp[t].double()
                wt = wt.T[:ci, :co] if plan["instance"] == "wgmma" else wt[:ci, :co]
                y += xp[:, a:a + d, b:b + h, c:c + w] @ wt
                t += 1
    return y


@pytest.mark.parametrize("ci,co,taps,hw", [(32, 40, (3, 3, 3), (8, 16)),
                                           (24, 100, (5, 3, 3), (4, 32)),
                                           (48, 160, (1, 1, 1), (2, 64)), (8, 20, (3, 5, 3), (4, 4))])
def test_k1_weight_layout_round_trips(ci, co, taps, hw):
    """The padded bf16 weights of the plan's layout hold the weights and
    zeros elsewhere: a conv through them equals conv3d_same_plain."""
    rng = np.random.default_rng(ci + co)
    x = torch.from_numpy(rng.standard_normal((2, 3, *hw, ci)))
    w = torch.from_numpy(rng.standard_normal((*taps, ci, co))).to(torch.bfloat16).double()
    plan = conv3d_same_plan(tuple(x.shape), co, taps)
    wp = conv3d_mod._k1_weights(w, plan)
    assert wp.dtype == torch.bfloat16
    rows = (plan["co_pad"], plan["ci_pad"]) if plan["instance"] == "wgmma" else \
        (plan["ci_pad"], plan["co_pad"])
    assert tuple(wp.shape) == (int(np.prod(taps)), *rows)
    assert float(wp.double().abs().sum()) == pytest.approx(float(w.abs().sum()))
    y = conv_through_layout(x, wp, plan, taps, ci, co)
    ref = conv3d_same_plain(x, w)
    assert torch.allclose(y, ref, rtol=1e-12, atol=1e-12)
