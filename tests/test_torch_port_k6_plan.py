"""K6's launch plan and its warpgroup-MMA instance's arithmetic, on the CPU.

``conv3d_tapconcat_persample_plan`` decides K6's instance (a persistent
warpgroup-MMA kernel, or the first design's mma.sync one for the shapes it does not
tile), the tile, the Co tile, the persistent blocks, the weight loads a
block and the shared memory. Here the plan is held at the K6 call of one
train step of the full-width s2d net (recorded on the meta device: the
forward and backward run, no activation is computed) and at every shape of
the card tests; the persistent schedule and the tile walk of the kernel are
modelled in Python; and the wgmma instance's contraction (a paired slab
built from the plain one, K = 15 (dz, dy) groups x 16 with zero weights at
tap dx = 3) is emulated tile by tile and held against the plain version in
fp64. No card: the kernel itself runs in ``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models import repmode as repmode_mod
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.ops import mode as mode_mod
from repmode_tpu_torch.ops.conv3d import (
    conv3d_tapconcat_persample_plain,
    conv3d_tapconcat_persample_plan,
)
from test_torch_port_cuda import K6_CASES

torch.set_num_threads(2)

META = torch.device("meta")
SMS = 132  # an H100 SXM
SMEM_MAX = 227 * 1024
SMEM_TWO_BLOCKS = 113 * 1024


def k6_calls(monkeypatch):
    """(x shape, Co) of every K6 call of one s2d train step (forward, loss,
    backward) of the full-width net on a batch of 8 patches."""
    calls = []

    def k23(x, w, *, transpose_taps=False, compute_dtype=None, out_dtype=None):
        co = w.shape[4] if transpose_taps else w.shape[5]
        return torch.empty((*x.shape[:4], co), dtype=out_dtype or x.dtype, device=META)

    def k4(x, dy, kd, kh, kw, *, compute_dtype=None):
        return torch.empty((x.shape[0], kd, kh, kw, x.shape[-1], dy.shape[-1]),
                           dtype=torch.float32, device=META)

    def k6(x, wn, *, compute_dtype=None, out_dtype=None):
        calls.append((tuple(x.shape), int(wn.shape[-1])))
        return torch.empty((*x.shape[:4], wn.shape[-1]), dtype=out_dtype or x.dtype, device=META)

    monkeypatch.setattr(repmode_mod, "resolve_device", lambda device: META)
    monkeypatch.setattr(mode_mod, "conv3d_same_persample", k23)
    monkeypatch.setattr(mode_mod, "conv3d_dw_persample", k4)
    monkeypatch.setattr(mode_mod, "conv3d_tapconcat_persample", k6)
    net = repmode_mod.RepModeNet(ModelConfig(mult_chan=32, depth=4), 4, device="cpu").train()
    x = torch.empty((8, 32, 128, 128, 1), device=META)
    out = net(x, torch.zeros((8,), dtype=torch.long, device=META))
    (out.float() ** 2).mean().backward()
    return calls


def test_the_full_width_s2d_step_plans_the_wgmma_instance(monkeypatch):
    """One K6 call a step, at x (8,32,64,64,4) -> 128: the persistent wgmma
    instance, tiles of 2 rows x 64 columns, one 128-wide Co tile, a block an
    SM, each loading at most two samples' weights."""
    calls = k6_calls(monkeypatch)
    assert calls == [((8, 32, 64, 64, 4), 128)]
    plan = conv3d_tapconcat_persample_plan(*calls[0], num_sms=SMS)
    assert plan["instance"] == "wgmma", plan
    assert (plan["tile"], plan["bn"], plan["co_tiles"]) == ([2, 64], 128, 1), plan
    assert (plan["tiles"], plan["blocks"], plan["blocks_per_sm"]) == (8192, SMS, 1), plan
    assert plan["weight_loads"] == 2 and plan["grid"] == [SMS, 1], plan
    assert plan["smem_bytes"] <= SMEM_MAX, plan


@pytest.mark.parametrize("case", K6_CASES)
def test_instance_at_each_card_case(case):
    """The card tests' shapes: Co a multiple of 32 (with W even, W >= 8 and
    planes of 128 positions or more, as all of them have) take the wgmma
    instance, the rest the mma.sync one; the plan is the same for any SM
    count but its blocks."""
    n, d, h, w, co = case
    plan = conv3d_tapconcat_persample_plan((n, d, h, w, 4), co, num_sms=SMS)
    assert plan["instance"] == ("wgmma" if co % 32 == 0 else "mma_sync"), (case, plan)
    other = conv3d_tapconcat_persample_plan((n, d, h, w, 4), co, num_sms=7)
    varies = ("grid", "blocks", "num_sms", "weight_loads")
    assert {k: v for k, v in other.items() if k not in varies} == \
        {k: v for k, v in plan.items() if k not in varies}


def test_the_card_cases_cover_every_wgmma_tile():
    """The card tests reach each tile shape (2 x 64, 1 x 128, 16 x 8) and Co
    tile (32, 64, 128) of the wgmma instance, a partial Co tile, and the
    mma.sync instance."""
    plans = [conv3d_tapconcat_persample_plan((n, d, h, w, 4), co, num_sms=SMS)
             for n, d, h, w, co in K6_CASES]
    wide = [p for p in plans if p["instance"] == "wgmma"]
    assert {tuple(p["tile"]) for p in wide} == {(2, 64), (1, 128), (16, 8)}
    assert {p["bn"] for p in wide} == {32, 64, 128}
    assert any(co % p["bn"] for (*_, co), p in zip(K6_CASES, plans) if p["instance"] == "wgmma")
    assert len(wide) < len(plans)


SHAPES = [(8, 32, 64, 64, 128), (1, 3, 5, 128, 256), (2, 4, 16, 8, 32), (1, 2, 9, 100, 96),
          (1, 2, 4, 200, 160), (3, 4, 6, 64, 128), (2, 4, 8, 8, 8), (1, 3, 2, 130, 4),
          (2, 6, 6, 16, 136), (1, 2, 3, 1000, 64)]


@pytest.mark.parametrize("case", SHAPES)
def test_shared_memory_fits(case):
    """A block's dynamic shared memory fits the card's 227 KB, and where the
    plan puts two blocks on an SM, both fit."""
    n, d, h, w, co = case
    plan = conv3d_tapconcat_persample_plan((n, d, h, w, 4), co, num_sms=SMS)
    assert 0 < plan["smem_bytes"] <= SMEM_MAX, plan
    if plan["instance"] == "wgmma" and plan["blocks_per_sm"] == 2:
        assert plan["smem_bytes"] <= SMEM_TWO_BLOCKS, plan


def walk(p, h, w, d, first, last):
    """The kernel's tile walk: its cursor (key, depth, tile row, tile
    column) decoded at ``first`` by divisions, then advanced one tile at a
    time (``TcwCursor``)."""
    rows, tw = p["tile"]
    tiles_per_row, tiles_per_col = -(-w // tw), -(-h // rows)
    per_plane = tiles_per_row * tiles_per_col
    key, rest = divmod(first, d * per_plane)
    dd, rest = divmod(rest, per_plane)
    tr, tc = divmod(rest, tiles_per_row)
    out = []
    for _ in range(first, last):
        out.append((key, dd, tr, tc))
        tc += 1
        if tc == tiles_per_row:
            tc, tr = 0, tr + 1
            if tr == tiles_per_col:
                tr, dd = 0, dd + 1
                if dd == d:
                    dd, key = 0, key + 1
    return out


@pytest.mark.parametrize("sms", [SMS, 7, 1])
@pytest.mark.parametrize("case", SHAPES[:6])
def test_persistent_schedule(case, sms):
    """Each block takes tiles [c*T//C, (c+1)*T//C): every tile of every
    (sample, Co tile) once, no block empty; the walk visits each (key,
    depth, tile row, tile column) once in the order of the flat index; the
    weight loads a block are the keys its range touches, at most two at
    full width."""
    n, d, h, w, co = case
    p = conv3d_tapconcat_persample_plan((n, d, h, w, 4), co, num_sms=sms)
    assert p["instance"] == "wgmma", p
    tiles, ctas = p["tiles"], p["blocks"]
    assert ctas == min(sms * p["blocks_per_sm"], tiles) and p["grid"] == [ctas, 1]
    rows, tw = p["tile"]
    per_key = d * -(-h // rows) * -(-w // tw)
    assert tiles == n * p["co_tiles"] * per_key
    seen, loads = [], []
    for c in range(ctas):
        first, last = c * tiles // ctas, (c + 1) * tiles // ctas
        assert last > first
        steps = walk(p, h, w, d, first, last)
        seen += steps
        loads.append(len({key for key, *_ in steps}))
    assert seen == walk(p, h, w, d, 0, tiles)
    assert len(set(seen)) == tiles and seen[-1][0] == n * p["co_tiles"] - 1
    assert max(loads) == p["weight_loads"]
    if case == SHAPES[0] and sms == SMS:
        assert p["weight_loads"] <= 2


def emulate_wgmma_instance(x, wn, plan):
    """K6's wgmma instance in fp64, tile by tile as the plan cuts y: each
    tile's plain slab (5 depths x rows + 2 x tw + 4 columns from w0 - 2,
    zero past the volume), the paired slab built from it (entry s = plain
    positions s + 1 and s + 2), and per (dz, dy) group one K = 16 step: the
    entries of output column c and c + 2 against the group's 16 weight rows
    (tap dx 3 zero), as the descriptors and the weight map read them."""
    n, d, h, wl, _ = x.shape
    co = wn.shape[-1]
    rows, tw = plan["tile"]
    xp = torch.nn.functional.pad(x, (0, 0, 2, tw + 2, 1, rows + 1, 2, 2))  # generous zero pad
    wg = torch.zeros((n, 15, 4, 4, co), dtype=x.dtype)  # (group, tap dx, lane, Co)
    wg[:, :, :3] = wn.reshape(n, 15, 3, 4, co)
    wg = wg.reshape(n, 15, 16, co)
    y = torch.zeros((n, d, h, wl, co), dtype=x.dtype)
    for nn in range(n):
        for dd in range(d):
            for h0 in range(0, h, rows):
                for w0 in range(0, wl, tw):
                    # plain slab: padded index = true index + (2, 1, 2) along (D, H, W)
                    plain = xp[nn, dd:dd + 5, h0:h0 + rows + 2, w0:w0 + tw + 4]
                    pairs = torch.cat([plain[:, :, 1:tw + 3], plain[:, :, 2:tw + 4]], dim=-1)
                    acc = torch.zeros((rows, tw, co), dtype=x.dtype)
                    for g in range(15):
                        dz, dy = divmod(g, 3)
                        rowp = pairs[dz, dy:dy + rows]  # (rows, tw + 2, 8)
                        a = torch.cat([rowp[:, :tw], rowp[:, 2:tw + 2]], dim=-1)  # (rows, tw, 16)
                        acc += a @ wg[nn, g]
                    rh, rw = min(rows, h - h0), min(tw, wl - w0)  # the store clips
                    y[nn, dd, h0:h0 + rh, w0:w0 + rw] = acc[:rh, :rw]
    return y


@pytest.mark.parametrize("case", [(2, 3, 20, 8, 32), (1, 3, 7, 20, 64), (2, 3, 3, 64, 32),
                                  (1, 2, 2, 130, 32)])
def test_paired_slab_contraction_matches_plain(case):
    """The wgmma instance's K = 240 contraction over the paired slab, with
    the tile geometry of its plan (W = 8 and 20: 8x8 patches, a partial
    column tile at 20; 64: rows of 64; 130: a row of 128 and a partial one),
    equals the plain version in fp64."""
    n, d, h, w, co = case
    plan = conv3d_tapconcat_persample_plan((n, d, h, w, 4), co, num_sms=SMS)
    assert plan["instance"] == "wgmma", plan
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.standard_normal((n, d, h, w, 4)))
    wn = torch.from_numpy(rng.standard_normal((n, 180, co)))
    ref = conv3d_tapconcat_persample_plain(x, wn)
    got = emulate_wgmma_instance(x, wn, plan)
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-12), (got - ref).abs().max().item()


@pytest.mark.parametrize("co", [128, 12])
def test_wrapper_pads_the_weights_only_when_needed(monkeypatch, co):
    """The wrapper hands the kernel w in place when Co is a multiple of 8
    (no copy, so a call launches K6 alone), and padded to one otherwise."""
    launched = {}

    def launch(xb, wb, c, plan):
        launched.update(wb=wb, co=c, plan=plan)
        return torch.empty((*xb.shape[:4], c), dtype=torch.bfloat16)

    monkeypatch.setattr(conv3d_mod, "_k6_launch", launch)
    monkeypatch.setattr(conv3d_mod, "_num_sms", lambda device: SMS)
    x = torch.zeros((1, 2, 8, 64, 4), dtype=torch.bfloat16)
    wn = torch.zeros((1, 180, co), dtype=torch.bfloat16)
    conv3d_mod._conv3d_tapconcat_cuda(x, wn, None, None)
    assert launched["co"] == co
    if co % 8 == 0:
        assert launched["wb"].data_ptr() == wn.data_ptr()
    else:
        assert tuple(launched["wb"].shape) == (1, 180, 16)
    assert launched["plan"] == conv3d_tapconcat_persample_plan(x.shape, co, num_sms=SMS)
