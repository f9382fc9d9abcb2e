"""K4's launch plan, on the CPU (no card).

``conv3d_dw_persample_plan`` mirrors the kernel source's ``make_plan``: the
instance (warpgroup MMA, the mma.sync wide tile or the narrow one), the
tile, the chunk of positions, the split over positions, the ring and the
shared memory of every launch of the per-sample weight gradient (K4). Here
the plan is held to the rules of the source at every K4 call of one train
step of the full-width net (mult_chan 32, depth 4, batch 8 of 32x128x128),
in both training layouts (native and space-to-depth). The calls are
recorded on the meta device: the forward and backward run, no activation
is computed. On the card, ``tests/test_torch_port_cuda.py`` checks that the
source's own plan equals this one at each of these shapes.
"""

import pytest
import torch

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models import repmode as repmode_mod
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops import mode as mode_mod
from repmode_tpu_torch.ops.conv3d import conv3d_dw_persample_plan

torch.set_num_threads(2)

META = torch.device("meta")
SMS = 132  # an H100 SXM
SMEM_MAX = 227 * 1024
# fp32 accumulators a thread of the wgmma instance: 160 at 5 taps a block
# (BN 64), 192 at 3 (BN 128)
ACC_BUDGET = {5: 160, 3: 192, 1: 64}


def k4_calls(monkeypatch, train_s2d: bool):
    """(x shape, Co, taps) of every K4 call of one train step (forward,
    loss, backward) on a batch of 8 patches."""
    calls = []

    def k23(x, w, *, transpose_taps=False, compute_dtype=None, out_dtype=None):
        co = w.shape[4] if transpose_taps else w.shape[5]
        return torch.empty((*x.shape[:4], co), dtype=out_dtype or x.dtype, device=META)

    def k4(x, dy, kd, kh, kw, *, compute_dtype=None):
        calls.append((tuple(x.shape), int(dy.shape[-1]), (kd, kh, kw)))
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
            out[layout] = k4_calls(mp, train_s2d=layout == "s2d")
    return out


def expected_instance(cip: int, cop: int, plane: int) -> str:
    if cip >= 64 and cop >= 32 and plane >= 128:
        return "wgmma"
    if cip >= 32 and cop >= 32 and (cip >= 64 or cop >= 64):
        return "mma_sync"
    return "narrow"


# The instance of each K4 call a step: native, the 1-channel input conv,
# level 1's two 32->32 convs and conv_out narrow, enc2.conv1 (32->64) and
# the 2x8x8 bottleneck's two convs on mma.sync wide tiles, the other 12 on
# wgmma; s2d, the entry conv narrow, the bottleneck's two on mma.sync and
# the other 15 on wgmma.
INSTANCES = {"native": {"narrow": 4, "mma_sync": 3, "wgmma": 12},
             "s2d": {"narrow": 1, "mma_sync": 2, "wgmma": 15}}


@pytest.mark.parametrize("layout", ["native", "s2d"])
def test_plan_covers_every_k4_call_of_a_train_step(calls_by_layout, layout):
    calls = calls_by_layout[layout]
    assert len(calls) == {"native": 19, "s2d": 18}[layout]
    counts = {"narrow": 0, "mma_sync": 0, "wgmma": 0}
    for shape, co, taps in calls:
        plan = conv3d_dw_persample_plan(shape, co, taps)
        n, d, h, w, ci = shape
        cip, cop, kw = plan["packed"]
        kwb = plan["taps_per_block"]
        counts[plan["instance"]] += 1
        assert plan["instance"] == expected_instance(cip, cop, h * w), (shape, co, plan)
        assert plan["wide"] == (plan["instance"] != "narrow")
        assert plan["shared_bytes"] <= SMEM_MAX, (shape, co, plan)
        assert kwb == kw and kw in (1, 3, 5)
        base = n * taps[0] * taps[1] * -(-cip // plan["tile_i"]) * -(-cop // plan["tile_o"])
        assert plan["blocks"] == base * plan["splits"], plan
        rows, tw = plan["chunk_rows"], plan["chunk_cols"]
        if plan["instance"] != "wgmma":
            assert plan["a_k_stride"] == 0
            continue
        # warpgroups of 64 input channels, two where Ci >= 128; BN by the
        # taps a block, within the accumulator budget; no position groups
        wgs = 2 if cip >= 128 else 1
        assert (plan["tile_i"], plan["threads"], plan["position_groups"]) == (64 * wgs, 128 * wgs, 1)
        assert plan["tile_o"] == min(64 if kwb == 5 else 128, cop), plan
        assert plan["accumulators"] == kwb * plan["tile_o"] // 2 <= ACC_BUDGET[kwb], plan
        # chunks of 128 positions: one row segment, or whole rows of a power
        # of two >= W columns
        assert rows * tw == 128 and (tw == 128 if w >= 128 else tw >= w and tw & (tw - 1) == 0)
        assert plan["a_k_stride"] == (128 if tw >= 16 else (tw + kwb - 1) * 16)
        # the ring: 3-4 stages of the slab (its 8-channel chunks back to
        # back, one tensor copy) and the dy tile, each 128-byte aligned, in
        # 113 KB where 3 stages fit it (one warpgroup: two blocks an SM),
        # else in 227 KB
        slab = -(-8 * wgs * rows * (tw + kwb - 1) * 16 // 128) * 128
        stage = slab + plan["tile_o"] // 8 * 128 * 16
        assert plan["stages"] in (3, 4)
        assert plan["shared_bytes"] == plan["stages"] * stage + 128, plan
        two_blocks = wgs == 1 and 3 * stage + 128 <= 113 * 1024
        assert plan["shared_bytes"] <= (113 * 1024 if two_blocks else SMEM_MAX)
    assert counts == INSTANCES[layout], counts


@pytest.mark.parametrize("layout", ["native", "s2d"])
def test_splits_follow_the_bytes_rule(calls_by_layout, layout):
    """The wide instances split positions only where the fp32 dW does not
    outweigh x and dy, and then to about 4 waves of blocks (2 an SM, 1 of
    two warpgroups); every split holds chunks."""
    for shape, co, taps in calls_by_layout[layout]:
        plan = conv3d_dw_persample_plan(shape, co, taps)
        if plan["instance"] == "narrow":
            continue
        n, d, h, w, _ = shape
        cip, cop, kw = plan["packed"]
        dw_bytes = taps[0] * taps[1] * kw * cip * cop * 4
        chunks = d * -(-h // plan["chunk_rows"]) * -(-w // plan["chunk_cols"])
        assert 1 <= plan["splits"] <= chunks
        if dw_bytes > d * h * w * (cip + cop) * 2:
            assert plan["splits"] == 1, (shape, co, plan)
        else:
            wgs = plan["threads"] // 128 if plan["instance"] == "wgmma" else 1
            target = SMS * 8 // wgs
            assert plan["blocks"] >= min(target, plan["blocks"] // plan["splits"] * chunks)
            assert plan["blocks"] // plan["splits"] * (plan["splits"] - 1) < target, plan


# (W, taps) -> (a_k_stride, splits) at x (8, 8, 32, W, 128), Co 128: W >= 16
# reads a k16 step from one slab row, W = 8 from two rows pitch * 16 bytes
# apart (pitch 12 at 5 taps a block, 10 at 3). Splits: 400 blocks of two
# warpgroups at 5 taps (BN 64), 120 at 3 (BN 128), split to 528 (4 waves of
# 132) until the fp32 dW (8.2 MB at 125 taps, 2.9 MB at 45) outweighs x and
# dy (16.8 MB at W = 128, halving with W).
K_STRIDE_CASES = {
    (128, (5, 5, 5)): (128, 2), (64, (5, 5, 5)): (128, 2), (32, (5, 5, 5)): (128, 1),
    (16, (5, 5, 5)): (128, 1), (8, (5, 5, 5)): (192, 1),
    (128, (5, 3, 3)): (128, 5), (64, (5, 3, 3)): (128, 5), (32, (5, 3, 3)): (128, 5),
    (16, (5, 3, 3)): (128, 1), (8, (5, 3, 3)): (160, 1),
}


@pytest.mark.parametrize("w,taps", sorted(K_STRIDE_CASES))
def test_k_direction_offset_and_splits_by_width(w, taps):
    plan = conv3d_dw_persample_plan((8, 8, 32, w, 128), 128, taps)
    assert plan["instance"] == "wgmma"
    assert (plan["a_k_stride"], plan["splits"]) == K_STRIDE_CASES[(w, taps)], plan
    assert plan["chunk_cols"] == max(8, min(w, 128))


def test_plan_reads_the_sm_count():
    """A card with fewer SMs gets fewer splits; without a device the plan is
    an H100's 132."""
    shape, co, taps = (8, 32, 64, 64, 128), 128, (5, 3, 3)
    h100 = conv3d_dw_persample_plan(shape, co, taps)
    assert h100 == conv3d_dw_persample_plan(shape, co, taps, num_sms=SMS)
    assert conv3d_dw_persample_plan(shape, co, taps, num_sms=66)["splits"] < h100["splits"]
    assert conv3d_dw_persample_plan(shape, co, taps, device="cpu") == h100


@pytest.mark.parametrize("ci,co,kw", [(1, 32, 5), (4, 128, 3), (32, 1, 5), (72, 40, 3),
                                      (3, 5, 5), (128, 20, 7), (64, 24, 5)])
def test_plan_packs_channels_as_the_wrapper_does(ci, co, kw):
    shape = (1, 2, 3, 4, ci)
    xp, dyp, kw_k = conv3d_mod._dw_operands(torch.zeros(shape), torch.zeros((*shape[:4], co)), kw)
    plan = conv3d_dw_persample_plan(shape, co, (3, 3, kw))
    assert plan["packed"] == [xp.shape[-1], dyp.shape[-1], kw_k]
    assert plan["instance"] == expected_instance(xp.shape[-1], dyp.shape[-1], 3 * 4)
