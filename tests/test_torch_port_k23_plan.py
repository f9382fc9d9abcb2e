"""K2 and K3's launch plan, on the CPU (no card).

``conv3d_same_persample_plan`` decides the instance (warpgroup MMA or
mma.sync), the tile, the contraction channels a stage, the ring and the grid
of every launch of the per-sample conv (K2) and of its transpose (K3, the
dx). Here the plan is held to what the kernel source accepts at every K2 and
K3 call of one train step of the full-width net (mult_chan 32, depth 4,
batch 8 of 32x128x128), in both training layouts (native and
space-to-depth). The calls are recorded on the meta device: the forward and
backward run, no activation is computed.
"""

import numpy as np
import pytest
import torch

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models import repmode as repmode_mod
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops import mode as mode_mod
from repmode_tpu_torch.ops.conv3d import conv3d_same_persample_plan

torch.set_num_threads(2)

META = torch.device("meta")
SMS = 132  # an H100 SXM
SMEM_MAX = 227 * 1024


def k23_calls(monkeypatch, train_s2d: bool):
    """(x shape, output channels, taps, transpose) of every K2 and K3 call of
    one train step (forward, loss, backward) on a batch of 8 patches."""
    calls = []

    def k23(x, w, *, transpose_taps=False, compute_dtype=None, out_dtype=None):
        co = w.shape[4] if transpose_taps else w.shape[5]
        calls.append((tuple(x.shape), int(co), tuple(w.shape[1:4]), transpose_taps))
        return torch.empty((*x.shape[:4], co), dtype=out_dtype or x.dtype, device=META)

    def k4(x, dy, kd, kh, kw, *, compute_dtype=None):
        return torch.empty((x.shape[0], kd, kh, kw, x.shape[-1], dy.shape[-1]),
                           dtype=torch.float32, device=META)

    def k6(x, wn, *, compute_dtype=None, out_dtype=None):
        return torch.empty((*x.shape[:4], wn.shape[-1]), dtype=out_dtype or x.dtype, device=META)

    monkeypatch.setattr(repmode_mod, "resolve_device", lambda device: META)
    monkeypatch.setattr(mode_mod, "conv3d_same_persample", k23)
    monkeypatch.setattr(mode_mod, "conv3d_dw_persample", k4)
    monkeypatch.setattr(mode_mod, "conv3d_tapconcat_persample", k6)
    cfg = ModelConfig(mult_chan=32, depth=4, train_s2d=train_s2d)
    net = repmode_mod.RepModeNet(cfg, 4, device="cpu").train()
    x = torch.empty((8, 32, 128, 128, 1), device=META)
    out = net(x, torch.zeros((8,), dtype=torch.long, device=META))
    (out.float() ** 2).mean().backward()
    return calls


@pytest.fixture(scope="module")
def calls_by_layout():
    out = {}
    for layout in ("native", "s2d"):
        with pytest.MonkeyPatch.context() as mp:
            out[layout] = k23_calls(mp, train_s2d=layout == "s2d")
    return out


# K2 and K3 launches a step: native 19 and 18 (the input conv needs no dx);
# s2d 17 and 17 (K6 takes the s2d entry conv's forward, which needs no dx
# either, and the s2d conv_out runs as tap-major einsums)
LAUNCHES = {"native": (19, 18), "s2d": (17, 17)}


def tiles_and_slab(plan, h, w, kw):
    """(position tiles a plane, slab positions a stage), from the tile rule
    the kernel source applies."""
    bm, mt = plan["bm"], plan["mt"]
    if plan["instance"] == "mma_sync":
        if w >= bm:
            return h * -(-w // bm), bm + kw - 1
        rows = bm // w
        return -(-h // rows), rows * (w + kw - 1)
    if w >= 64:
        tw = 64
        while tw * 2 <= bm and tw * 2 <= w and tw < 128:
            tw *= 2
        rows = bm // tw
    else:
        rows, tw = 8, 8 * (bm // (64 * mt))
    return -(-h // rows) * -(-w // tw), rows * (tw + kw - 1)


@pytest.mark.parametrize("layout", ["native", "s2d"])
def test_plan_covers_every_k23_call_of_a_train_step(calls_by_layout, layout):
    calls = calls_by_layout[layout]
    assert (sum(not c[3] for c in calls), sum(c[3] for c in calls)) == LAUNCHES[layout]
    wide = 0
    for shape, co, taps, transpose in calls:
        plan = conv3d_same_persample_plan(shape, co, taps, transpose)
        n, d, h, w, c = shape
        cin, kw = plan["packed"]
        assert plan["transpose"] == transpose
        assert plan["smem_bytes"] <= SMEM_MAX, (shape, co, taps, plan)
        assert plan["blocks"] == plan["grid"][0] * plan["grid"][1]
        expect_wide = cin >= 16 and co >= 32 and h * w >= 128
        assert plan["instance"] == ("wgmma" if expect_wide else "mma_sync"), (shape, co, plan)
        tiles, slab = tiles_and_slab(plan, h, w, kw)
        co_tiles = -(-co // plan["bn"])
        if plan["instance"] == "mma_sync":
            assert (plan["bm"], plan["mt"], plan["stages"]) == (128, 1, 2)
            assert plan["kc"] in (16, 32) and plan["bn"] in (16, 32, 64)
            assert plan["grid"] == [n * d * tiles, co_tiles]
            continue
        wide += 1
        assert plan["grid"] == [n * d * tiles * co_tiles, 1], plan
        assert plan["stages"] in (3, 4) and plan["kc"] in (16, 32, 64) and plan["kc"] <= cin
        assert plan["bn"] in (32, 64, 128) and plan["mt"] in (1, 2, 4)
        assert plan["bm"] // (64 * plan["mt"]) in (1, 2)
        # the instances the source compiles
        assert plan["mt"] != 4 or (plan["bn"] == 32 and plan["kc"] <= 32), plan
        assert plan["bn"] != 128 or (plan["mt"] == 1 and plan["kc"] <= 32), plan
        assert plan["kc"] != 64 or plan["mt"] <= 2, plan
        stage = kw * plan["bn"] * plan["kc"] * 2 + -(-slab // 8) * 8 * plan["kc"] * 2
        assert plan["smem_bytes"] == plan["stages"] * stage + 1024, plan
        # at least 3/4 of a wave of blocks, unless the tile cannot shrink
        assert plan["blocks"] >= SMS * 3 // 4 or (plan["bm"], plan["bn"]) == (64, 32), plan
    assert wide > 0


def test_every_wide_training_conv_plans_wgmma(calls_by_layout):
    """Native: all but the 1-channel input conv, conv_out and its dx and the
    2x8x8 bottleneck's two convs and their dx (7 of 37 calls). s2d: all but
    the bottleneck's 4 calls."""
    for layout, n_narrow in (("native", 7), ("s2d", 4)):
        calls = calls_by_layout[layout]
        narrow = [(s, co, t) for s, co, taps_, t in calls
                  if conv3d_same_persample_plan(s, co, taps_, t)["instance"] == "mma_sync"]
        assert len(narrow) == n_narrow, (layout, narrow)
        for shape, co, transpose in narrow:
            bottleneck = shape[1:4] == (2, 8, 8)
            one_channel = (shape[-1] == 1) or co == 1
            assert bottleneck or (layout == "native" and one_channel), (layout, shape, co)
    native = calls_by_layout["native"]
    assert [(s, co, t) for s, co, _, t in native if s[-1] == 1 or co == 1] == [
        ((8, 32, 128, 128, 1), 32, False), ((8, 32, 128, 128, 32), 1, False),
        ((8, 32, 128, 128, 1), 32, True)]


@pytest.mark.parametrize("cin,kw,transpose", [(1, 5, False), (3, 3, False), (4, 3, False),
                                              (1, 5, True), (12, 5, True), (24, 5, False),
                                              (40, 3, True), (8, 7, False)])
def test_plan_packs_channels_as_the_wrapper_does(cin, kw, transpose):
    co = 16
    shape = (1, 2, 3, 4, cin)
    x = torch.zeros(shape)
    w = torch.zeros((1, 3, 3, kw, co, cin) if transpose else (1, 3, 3, kw, cin, co))
    xp, wp = conv3d_mod._persample_operands(x, w, transpose)
    plan = conv3d_same_persample_plan(shape, co, (3, 3, kw), transpose)
    assert plan["packed"] == [xp.shape[-1], wp.shape[3]]


@pytest.mark.parametrize("transpose", [False, True])
def test_wide_plan_is_k1s_tile_rule(transpose):
    """The wide tiles, KC and ring follow K1's rule at the same packed
    shape; only the grid is flattened (one sample's blocks together)."""
    rng = np.random.default_rng(int(transpose))
    for _ in range(40):
        n, d = int(rng.integers(1, 9)), int(rng.integers(1, 33))
        h, w = (int(v) for v in rng.choice([8, 16, 32, 64, 128], 2))
        c, co = (int(v) for v in rng.choice([16, 32, 64, 128, 256, 512], 2))
        taps = (5, 5, 5) if rng.random() < 0.5 else (5, 3, 3)
        p = conv3d_same_persample_plan((n, d, h, w, c), co, taps, transpose)
        k1 = conv3d_mod.conv3d_same_plan((n, d, h, w, c), co, taps)
        assert p["instance"] == k1["instance"]
        if p["instance"] != "wgmma":
            continue
        for key in ("bm", "mt", "bn", "kc", "stages", "smem_bytes", "blocks"):
            assert p[key] == k1[key], (key, p, k1)
        assert p["grid"] == [k1["blocks"], 1]
