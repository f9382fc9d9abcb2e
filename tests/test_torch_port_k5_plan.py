"""K5's launch plan, on the CPU (no card).

``conv3d_dpad_plan`` decides the instance (warpgroup MMA or mma.sync), the
tile, the input channels a stage, the ring and the grid of every launch of
the depth-padded s2d conv chain (K5). Here the plan is held to what the
kernel source (``csrc/conv3d_dpad.cu``) accepts at every K5 call of the K5
serving route (``plain_forward_s2d_pallas``) at full width (mult_chan 32,
depth 4, 32x128x128 patches, batches of 8 and of 1), and at small shapes
at the edges of its tile rules. The calls are recorded on the meta device,
so no activation is computed.
"""

import pytest
import torch

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models import reparam
from repmode_tpu_torch.models import repmode as repmode_mod
from repmode_tpu_torch.ops.conv3d import conv3d_dpad_plan

torch.set_num_threads(2)

META = torch.device("meta")
SMS = 132  # an H100 SXM
SMEM_MAX = 227 * 1024
TWO_BLOCKS = 113 * 1024


def k5_calls(monkeypatch):
    """(x shape, Co, taps) of every K5 call one batch of 8 patches makes on
    the K5 route, in launch order."""
    calls = []

    def dpad(x, w, bias=None, *, relu=False, compute_dtype=None):
        calls.append((tuple(x.shape), int(w.shape[-1]), tuple(w.shape[:3])))
        return torch.empty((*x.shape[:4], w.shape[-1]), dtype=torch.bfloat16, device=META)

    def same(x, w, bias=None, *, relu=False, compute_dtype=None, out_dtype=None):
        odt = out_dtype or torch.promote_types(x.dtype, torch.float32)
        return torch.empty((*x.shape[:4], w.shape[-1]), dtype=odt, device=META)

    monkeypatch.setattr(repmode_mod, "resolve_device", lambda device: META)
    monkeypatch.setattr(reparam, "conv3d_dpad", dpad)
    monkeypatch.setattr(reparam, "conv3d_same", same)
    cfg = ModelConfig(mult_chan=32, depth=4, train_s2d=False)
    net = repmode_mod.RepModeNet(cfg, 2, device="cpu").eval()
    plain = reparam.reparameterize(net.state_dict(), cfg, 2, 0)
    levels = reparam.default_s2d_levels(cfg)
    x = torch.empty((8, 32, 128, 128, 1), device=META)
    with torch.no_grad():
        reparam.plain_forward_s2d_pallas(reparam.to_s2d_plain(plain, cfg, levels), x, cfg,
                                         levels, compute_dtype=torch.bfloat16)
    return calls


@pytest.fixture(scope="module")
def calls():
    with pytest.MonkeyPatch.context() as mp:
        return k5_calls(mp)


def wide_tiles(h, w, bm):
    """Tiles a (n, dp) plane of the wide instance, as the source cuts it:
    m64 tiles of one row segment where W >= 64 (tile rows of 64 or, at BM
    128 and W >= 128, 128 columns), else of 8 rows x 8 columns, one a
    warpgroup."""
    if w >= 64:
        tw = 128 if bm == 128 and w >= 128 else 64
        rows = bm // tw
    else:
        rows, tw = 8, 8 * (bm // 64)
    return -(-h // rows) * -(-w // tw)


def check_plan(shape, co, plan):
    """The plan is one the source can launch, and its grid covers every
    (sample, padded depth row, position tile, Co tile) once."""
    n, dp, h, w, ci = shape
    assert plan["smem_bytes"] <= SMEM_MAX, (shape, co, plan)
    assert co % plan["bn"] == 0 and ci % plan["kc"] == 0
    assert plan["blocks"] == plan["grid"][0] * plan["grid"][1]
    # the one tile of both instances: BN 128, KC 32
    assert (plan["mt"], plan["bn"], plan["kc"]) == (1, 128, 32), plan
    if plan["instance"] == "mma_sync":
        assert (plan["bm"], plan["stages"]) == (128, 2)
        tiles = h * -(-w // 128) if w >= 128 else -(-h // (128 // w))
    else:
        # one or two warpgroups (one only where W < 16), a 3-4 stage ring
        assert plan["bm"] == (64 if w < 16 else 128) and plan["stages"] in (3, 4), plan
        tiles = wide_tiles(h, w, plan["bm"])
    co_tiles = co // plan["bn"]
    assert plan["blocks"] == n * dp * tiles * co_tiles, (shape, co, plan)
    # wide: a 1-D grid, the Co tile fastest; narrow: the Co tile on grid y
    assert plan["grid"] == ([plan["blocks"], 1] if plan["instance"] == "wgmma"
                            else [n * dp * tiles, co_tiles])


def test_the_k5_route_makes_seven_calls_of_five_shapes(calls):
    assert len(calls) == 7
    assert len(set(calls)) == 5
    assert {taps for _, _, taps in calls} == {(5, 3, 3)}
    assert {s[1:4] for s, _, _ in calls} == {(36, 64, 64), (20, 32, 32)}


@pytest.mark.parametrize("index", range(7))
@pytest.mark.parametrize("batch", [8, 1])
def test_plan_fits_the_source_at_every_k5_call(calls, index, batch):
    """wgmma at every full-width call, two blocks an SM, a grid that covers
    every tile, and at least a wave of blocks even at a batch of one (why
    the plan never shrinks its tile)."""
    shape, co, taps = calls[index]
    shape = (batch, *shape[1:])
    plan = conv3d_dpad_plan(shape, co, taps)
    check_plan(shape, co, plan)
    assert plan["instance"] == "wgmma", (shape, co, plan)
    assert (plan["bm"], plan["bn"], plan["kc"], plan["stages"]) == (128, 128, 32, 3), plan
    assert plan["smem_bytes"] <= TWO_BLOCKS and plan["blocks"] >= SMS


# (N, Dp, H, W, Ci, Co) at the edges of the tile rules: planes under 128
# positions (the narrow instance; the first two are the card tests' small K5
# cases), of exactly 128, row mode (W >= 64) with tile rows of 64 and of
# 128 columns and partial tiles, patch mode with two warpgroups (16 <= W <
# 64) and with one (W < 16), one to four Co tiles
SMALL = [(1, 4, 4, 8, 128, 128), (2, 7, 6, 20, 128, 256), (1, 3, 1, 127, 256, 128),
         (1, 3, 1, 128, 128, 128), (1, 3, 16, 8, 128, 256), (1, 3, 2, 64, 128, 128),
         (1, 5, 9, 130, 256, 128), (2, 6, 5, 48, 384, 128), (2, 5, 12, 12, 128, 256),
         (1, 4, 3, 64, 128, 512), (1, 3, 2, 300, 128, 128), (2, 9, 16, 16, 512, 256),
         (2, 9, 32, 64, 128, 128), (1, 3, 9, 15, 128, 256), (1, 3, 3, 63, 128, 128),
         (1, 3, 2, 65, 128, 128), (1, 3, 1, 129, 128, 384), (3, 5, 20, 32, 256, 256),
         (1, 7, 64, 64, 128, 128), (4, 6, 7, 100, 128, 128)]


@pytest.mark.parametrize("shape_co", SMALL)
def test_plan_fits_the_source_at_small_shapes(shape_co):
    shape, co = shape_co[:5], shape_co[5]
    plan = conv3d_dpad_plan(shape, co, (3, 3, 3))
    check_plan(shape, co, plan)
    assert plan["instance"] == ("wgmma" if shape[2] * shape[3] >= 128 else "mma_sync"), plan
    assert plan["smem_bytes"] <= TWO_BLOCKS, plan


def test_small_shapes_reach_every_instance():
    """The small shapes reach the narrow instance and the wide one with one
    and with two warpgroups, in row and in patch mode."""
    seen = set()
    for shape_co in SMALL:
        plan = conv3d_dpad_plan(shape_co[:5], shape_co[5], (5, 3, 3))
        seen.add((plan["instance"], plan["bm"], shape_co[3] >= 64))
    assert seen == {("mma_sync", 128, False), ("mma_sync", 128, True), ("wgmma", 64, False),
                    ("wgmma", 128, False), ("wgmma", 128, True)}
