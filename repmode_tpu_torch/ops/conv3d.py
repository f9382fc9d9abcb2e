"""3-D conv primitives on NDHWC activations and DHWIO kernels.

Four wrappers port the TPU kernels of ``repmode_tpu/ops/pallas/conv3d.py``.
On a CUDA tensor each launches its hand-written kernel; on a CPU tensor it
runs its plain PyTorch version, which defines the same arithmetic (inputs
rounded to the compute dtype, sums in fp32, fp64 stays fp64):

  conv3d_same            K1, ``pallas_conv3d_same``: shared kernel, fused
                         scale, bias (+ReLU) epilogue (``csrc/conv3d_same.cu``;
                         its instance, warpgroup MMA or mma.sync, and tiles
                         from ``conv3d_same_plan``);
  conv3d_same_persample  K2 and K3, ``pallas_conv3d_same_persample``: one
                         kernel per sample, and its transpose (the dx of the
                         merged MoDE conv) reading the forward kernels in
                         place (``csrc/conv3d_persample.cu``; its instance,
                         warpgroup MMA or mma.sync, and tiles from
                         ``conv3d_same_persample_plan``);
  conv3d_dw_persample    K4, ``pallas_conv3d_dw_persample``: the per-sample
                         weight gradient (``csrc/conv3d_dw_persample.cu``;
                         its instance, warpgroup MMA or one of two mma.sync
                         ones, and tiles from ``conv3d_dw_persample_plan``);
  conv3d_dpad            K5, ``pallas_conv3d_dpad``: the chainable conv of
                         the space-to-depth serving levels on depth-padded
                         tensors, fused bias+ReLU (``csrc/conv3d_dpad.cu``;
                         its instance, warpgroup MMA or mma.sync, and tiles
                         from ``conv3d_dpad_plan``);
  conv3d_tapconcat_persample  K6, the tap-concat conv of
                         ``tools/bench_enc1c1_kernel.py``: the per-sample
                         conv of a 4-lane input as one GEMM per tile over
                         the concatenated taps, the space-to-depth entry
                         conv of training (``csrc/conv3d_tapconcat.cu``;
                         its instance, persistent warpgroup MMA or
                         mma.sync, and tiles from
                         ``conv3d_tapconcat_persample_plan``).

Each wrapper counts the launches of its kernel in ``<wrapper>.launches``
(and ``conv3d_same_persample.transpose_launches`` those of K3;
``conv3d_same.bn_epilogues`` its launches with a per-channel scale).

``conv3d_same_autograd`` is no kernel port: it is the XLA conv of the JAX
package's differentiated expert sum as a plain PyTorch op (``F.conv3d``,
autograd gives the backward), the train-mode counterpart of K1; it counts
its calls in ``conv3d_same_autograd.calls``.

The k=2, s=2 down/upsample convs have non-overlapping windows, so they are
reshapes around one matrix product, as in the JAX package; so is the
tap-major ``conv3d_same_tapmajor`` of the s2d ``conv_out``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repmode_tpu_torch.ops.kernels import build


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 floor for sums; fp64 inputs keep fp64 (golden parity runs)."""
    return torch.promote_types(dtype, torch.float32)


def _round(t: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Round to the compute dtype, then widen to the accumulation dtype."""
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return t.to(_acc_dtype(t.dtype))


def _acc_or_compute(x: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x in the compute dtype, or, in exact mode, in the accumulation dtype."""
    return x.to(compute_dtype) if compute_dtype is not None else x.to(_acc_dtype(x.dtype))


def conv3d_same_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[torch.Tensor] = None,
    relu: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``conv3d_same``: the kernel's function in PyTorch ops.

    x: (N,D,H,W,Ci), w: (kD,kH,kW,Ci,Co) with odd taps, scale and bias:
    (Co,). Returns act(conv(x, w) * scale + bias) as (N,D,H,W,Co) in
    ``out_dtype`` (default: the accumulation dtype, fp32 or fp64).
    """
    kd, kh, kw = w.shape[:3]
    xr = _round(x, compute_dtype)
    wr = _round(w, compute_dtype).to(xr.dtype)
    y = F.conv3d(
        xr.permute(0, 4, 1, 2, 3),
        wr.permute(4, 3, 0, 1, 2),
        padding=((kd - 1) // 2, (kh - 1) // 2, (kw - 1) // 2),
    ).permute(0, 2, 3, 4, 1)
    if scale is not None:
        y = y * scale.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype or y.dtype).contiguous()


def conv3d_same(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[torch.Tensor] = None,
    relu: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """'same' stride-1 3-D conv with an optional fused epilogue: a
    per-channel ``scale`` (fp32, before the bias: an eval-mode BN as an
    affine), a bias, a ReLU.

    On a CUDA tensor: one launch of the bf16 tensor-core kernel on the
    current stream, the instance and tiles of ``conv3d_same_plan``
    (``compute_dtype`` must be bf16, or None with a bf16 ``x``;
    ``out_dtype`` fp32 (default) or bf16); a refused launch raises with the
    plan in its message. The kernel has no
    backward, as its TPU counterpart has none: with grad enabled and an input
    that requires grad it raises. On a CPU tensor: the plain version.
    ``conv3d_same.launches`` counts kernel launches, ``.bn_epilogues`` those
    of them that carry a scale.
    """
    if x.device.type == "cpu":
        return conv3d_same_plain(x, w, bias, scale=scale, relu=relu,
                                 compute_dtype=compute_dtype, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias, scale)
    ):
        raise RuntimeError(
            "conv3d_same: the CUDA kernel has no backward, and an input requires grad; "
            "train through conv3d_same_autograd (as train_impl 'expert_sum' does) or the "
            "per-sample merged route (train_impl 'auto'), or run this conv under "
            "torch.no_grad()"
        )
    y = _conv3d_same_cuda(x, w, bias, scale, relu, compute_dtype, out_dtype)
    conv3d_same.launches += 1
    if scale is not None:
        conv3d_same.bn_epilogues += 1
    return y


conv3d_same.launches = 0
conv3d_same.bn_epilogues = 0


def conv3d_same_autograd(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """'same' stride-1 3-D conv on a differentiated path: the port of the XLA
    op ``repmode_tpu/ops/conv3d.py:conv3d_same`` with ``accum_dtype=None``.

    x: (N,D,H,W,Ci), w: (kD,kH,kW,Ci,Co) with odd taps -> (N,D,H,W,Co). Both
    are rounded to ``compute_dtype`` (without one, to their common dtype) and
    the output is in that dtype, as JAX's AD-safe conv rounds its output.
    ``F.conv3d`` runs on an NCDHW view of x (channels_last_3d in memory, no
    copy) and autograd gives the backward, on any device. A ``bias`` (Co,)
    is added to that output as it is, so the sum is in the wider of the two
    dtypes: a bf16 conv with an fp32 bias gives fp32 in the one pass that
    widens it. ``conv3d_same_autograd.calls`` counts calls.
    """
    conv3d_same_autograd.calls += 1
    dt = compute_dtype or torch.promote_types(x.dtype, w.dtype)
    kd, kh, kw = w.shape[:3]
    y = F.conv3d(
        x.to(dt).permute(0, 4, 1, 2, 3),
        w.to(dt).permute(4, 3, 0, 1, 2),
        padding=((kd - 1) // 2, (kh - 1) // 2, (kw - 1) // 2),
    ).permute(0, 2, 3, 4, 1)
    return y if bias is None else y + bias


conv3d_same_autograd.calls = 0


def _conv3d_same_cuda(x, w, bias, scale, relu, compute_dtype, out_dtype) -> torch.Tensor:
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f"conv3d_same: x {tuple(x.shape)} and w {tuple(w.shape)} must be 5-D")
    n, d, h, wl, ci = x.shape
    kd, kh, kw, wci, co = w.shape
    if wci != ci or kd % 2 == 0 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(
            f"conv3d_same: w {tuple(w.shape)} must have odd taps and Ci={ci}"
        )
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    if cdt != torch.bfloat16:
        raise ValueError(
            f"conv3d_same: the CUDA kernel computes in bfloat16, got compute_dtype {cdt}"
        )
    odt = out_dtype if out_dtype is not None else torch.float32
    if odt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3d_same: out_dtype must be float32 or bfloat16, got {odt}")
    for name, t in (("w", w), ("bias", bias), ("scale", scale)):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3d_same: {name} on {t.device}, x on {x.device}")
    for name, t in (("bias", bias), ("scale", scale)):
        if t is not None and tuple(t.shape) != (co,):
            raise ValueError(f"conv3d_same: {name} {tuple(t.shape)} must be ({co},)")

    plan = conv3d_same_plan(tuple(x.shape), co, (kd, kh, kw), odt, num_sms=_num_sms(x.device))
    return _k1_launch(x, w, bias, scale, relu, odt, plan)


def _k1_launch(x, w, bias, scale, relu, odt, plan) -> torch.Tensor:
    """Launch K1 as ``plan`` says (its instance, bm, mt, bn, kc, stages,
    ci_pad, co_pad) on checked operands."""
    n, d, h, wl = x.shape[:4]
    xb, w = _to_multiple_of_8_channels(x.to(torch.bfloat16), w)
    kd, kh, kw, ci, co = w.shape
    xb = _aligned(xb)
    wp = _k1_weights(w, plan)
    bp, sp = (None if t is None else _epilogue_vector(t, plan["co_pad"]) for t in (bias, scale))
    y = torch.empty((n, d, h, wl, co), dtype=odt, device=x.device)

    lib = build.load("conv3d_same")
    err = lib.conv3d_same_bf16(
        xb.data_ptr(), wp.data_ptr(), None if bp is None else bp.data_ptr(),
        None if sp is None else sp.data_ptr(), y.data_ptr(),
        n, d, h, wl, ci, co, kd, kh, kw, plan["ci_pad"], plan["co_pad"],
        int(plan["instance"] == "wgmma"), plan["bm"], plan["mt"], plan["bn"], plan["kc"],
        plan["stages"], int(relu), int(odt == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.conv3d_same_error_string(err).decode()
        raise RuntimeError(f"conv3d_same kernel launch failed ({msg}) for x {tuple(x.shape)}, "
                           f"w {tuple(w.shape)}, plan {plan}")
    return y


def _epilogue_vector(t: torch.Tensor, co_pad: int) -> torch.Tensor:
    """A per-channel fp32 vector of K1's epilogue, zero-padded to co_pad."""
    out = torch.zeros((co_pad,), dtype=torch.float32, device=t.device)
    out[:t.shape[0]] = t
    return out


# K1's shared memory: a block may take 227 KB; two blocks an SM fit where
# each takes at most 113 KB (the SM's 228 KB less 1 KB reserved a block).
_K1_SMEM_MAX = 227 * 1024
_K1_SMEM_TWO_BLOCKS = 113 * 1024
_K1_SWIZZLE_ALIGN = 1024  # the wide instance aligns its weight tiles to the swizzle pattern
_H100_SMS = 132
_SMS: dict = {}


def _num_sms(device) -> int:
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _plan_sms(num_sms: Optional[int], device) -> int:
    """The SM count a plan is made for: ``num_sms`` where given, else the
    CUDA ``device``'s (what its wrapper launches with), else an H100's."""
    if num_sms is not None:
        return int(num_sms)
    if device is not None and torch.device(device).type == "cuda":
        return _num_sms(device)
    return _H100_SMS


def _same_packed_dims(ci: int, kw: int):
    """(Ci, kW) of the problem ``_to_multiple_of_8_channels`` hands K1."""
    if ci % 8 and kw > 1 and kw * ci <= 32:
        ci, kw = kw * ci, 1
    return -(-ci // 8) * 8, kw


def _k1_tiles(h: int, wl: int, kw: int, bm: int):
    """(tiles per (n, d) plane, slab positions a stage) of the narrow
    instance's BM-position tile: a row segment when W >= BM, else BM // W
    whole rows."""
    if wl >= bm:
        return h * -(-wl // bm), bm + kw - 1
    rows = bm // wl
    return -(-h // rows), rows * (wl + kw - 1)


def conv3d_same_plan(x_shape, co: int, taps, out_dtype=torch.float32, *,
                     num_sms: Optional[int] = None, device=None) -> dict:
    """The launch K1 makes for x (N,D,H,W,Ci), Co output channels and taps
    (kD,kH,kW), after the wrapper's channel packing (``packed``: Ci, kW).

    instance "wgmma" (packed Ci >= 16, Co >= 32, and H*W >= 128 positions a
    plane; its loads by the tensor memory accelerator): ``bm`` = 64
    positions x warpgroups (2; 1 where W < 16) x ``mt`` m64 tiles a
    warpgroup (where W >= 64: 4 at BN = 32, 2 at BN = 64); BN =
    32, 64 or 128 (Co above 128 in 128-wide tiles). A grid under 3/4 of a
    block an SM (``num_sms``: given, else the CUDA ``device``'s, else 132)
    first halves mt, then BN down to 32, then takes one warpgroup. An m64
    tile is 64 positions of one row where W >=
    64 (at most 128 columns a tile row), else 8 rows x 8 columns. KC input
    channels a stage: 64 where Ci allows and BN <= 64 (then at most 2 m64
    tiles a warpgroup), else 32, else 16, narrowed where a ring of 3 stages
    would not fit; as many stages (3-4) as leave two blocks an SM (113 KB),
    else as fit one block. instance "mma_sync" (the narrow 1-channel and Co
    < 32 convs, planes under 128 positions): BM 128, BN 16/32/64, KC 16/32,
    two stages.
    Also: ci_pad and co_pad (the weights' padded extents), dynamic shared
    bytes, grid and blocks. With a CUDA ``device`` (needs the card) it also
    reads the compiled kernel's registers and local (spill) bytes a thread,
    and checks that the kernel computes the same shared memory and grid.
    """
    n, d, h, wl, ci = (int(v) for v in x_shape)
    kd, kh, kw = (int(v) for v in taps)
    cip, kw = _same_packed_dims(ci, kw)
    co = int(co)
    plan = None
    if cip >= 16 and co >= 32:
        plan = _wide_plan(n, d, h, wl, cip, co, kw, _plan_sms(num_sms, device))
    if plan is None:
        kc = 16 if cip <= 16 else 32
        bn = 16 if co <= 16 else (32 if co <= 32 else 64)
        tiles, slab = _k1_tiles(h, wl, kw, 128)
        plan = dict(instance="mma_sync", bm=128, mt=1, bn=bn, kc=kc, stages=2,
                    smem_bytes=2 * (slab * (kc + 8) * 2 + kw * kc * (bn + 8) * 2),
                    grid=[n * d * tiles, -(-co // bn)])
    plan.update(packed=[cip, kw], ci_pad=-(-cip // plan["kc"]) * plan["kc"],
                co_pad=-(-co // plan["bn"]) * plan["bn"],
                blocks=plan["grid"][0] * plan["grid"][1])
    if device is not None:
        plan.update(_k1_attributes(plan, (n, d, h, wl), co, (kd, kh, kw), out_dtype))
    return plan


def _k1_wide_tiles(h: int, wl: int, kw: int, bm: int, mt: int):
    """(tiles per (n, d) plane, slab positions a stage) of the wide
    instance: rows of a power-of-two multiple of 64 columns where W >= 64
    (each m64 tile one row segment), else 8 rows x 8 columns a warpgroup."""
    if wl >= 64:
        tw = 64
        while tw * 2 <= min(bm, wl, 128):
            tw *= 2
        rows = bm // tw
    else:
        rows, tw = 8, 8 * (bm // (64 * mt))
    return -(-h // rows) * -(-wl // tw), rows * (tw + kw - 1)


def _wide_plan(n, d, h, wl, ci, co, kw, num_sms):
    if h * wl < 128:
        return None  # planes under one 128-position tile (the bottleneck's 8x8)

    def blocks(wgs, mt, bn):
        return n * d * _k1_wide_tiles(h, wl, kw, 64 * wgs * mt, mt)[0] * -(-co // bn)

    bn = 32 if co <= 32 else (64 if co <= 64 else 128)
    wgs = 2 if wl >= 16 else 1
    mt = {32: 4, 64: 2}.get(bn, 1) if wl >= 64 else 1
    while blocks(wgs, mt, bn) < num_sms * 3 // 4:
        if mt > 1:
            mt //= 2
        elif bn > 32:
            bn //= 2
        elif wgs == 2:
            wgs = 1
        else:
            break
    kc = 64 if ci % 64 == 0 and bn <= 64 else (32 if ci >= 32 else 16)
    mt = min(mt, 2) if kc == 64 else mt
    bm = 64 * wgs * mt
    tiles, slab = _k1_wide_tiles(h, wl, kw, bm, mt)

    def stage_bytes(kc):  # each channel chunk of the slab 128-byte aligned
        return kw * bn * kc * 2 + -(-slab // 8) * 8 * kc * 2

    # the widest KC whose ring of 3 stages fits; as many stages (up to 4) as
    # leave two blocks an SM, else as fit one block
    for kc in [k for k in (64, 32, 16) if k <= kc]:
        for room in (_K1_SMEM_TWO_BLOCKS, _K1_SMEM_MAX):
            stages = min(4, (room - _K1_SWIZZLE_ALIGN) // stage_bytes(kc))
            if stages >= 3:
                return dict(instance="wgmma", bm=bm, mt=mt, bn=bn, kc=kc, stages=stages,
                            smem_bytes=stages * stage_bytes(kc) + _K1_SWIZZLE_ALIGN,
                            grid=[n * d * tiles, -(-co // bn)])
    return None  # the slab of a very narrow W: the narrow instance takes it


def _k1_attributes(plan, dhw, co, taps, out_dtype) -> dict:
    """The compiled kernel of ``plan``: registers and local bytes a thread.
    Raises if the kernel's own shared memory or grid differ from the plan's."""
    n, d, h, wl = dhw
    cip, kw = plan["packed"]
    return _compiled_plan("conv3d_same", plan, (
        n, d, h, wl, cip, co, taps[0], taps[1], kw, plan["ci_pad"], plan["co_pad"],
        int(plan["instance"] == "wgmma"), plan["bm"], plan["mt"], plan["bn"], plan["kc"],
        plan["stages"], int(out_dtype == torch.bfloat16)))


def _compiled_plan(name: str, plan: dict, args) -> dict:
    """Registers and local (spill) bytes a thread of the kernel that the C
    ``<name>_plan(*args, out)`` of library ``name`` picks for ``plan``.
    Raises if that kernel's shared memory or grid differ from the plan's."""
    out = (ctypes.c_int * 5)()
    lib = build.load(name)
    err = getattr(lib, f"{name}_plan")(*args, out)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}_plan: {msg} for plan {plan}")
    if [out[0], [out[1], out[2]]] != [plan["smem_bytes"], plan["grid"]]:
        raise RuntimeError(f"{name}_plan: the kernel launches {out[0]} shared bytes on a "
                           f"{out[1]}x{out[2]} grid, the plan says {plan}")
    return {"registers": out[3], "local_bytes": out[4]}


def _k1_weights(w: torch.Tensor, plan: dict) -> torch.Tensor:
    """The packed (kD,kH,kW,Ci,Co) weights in bf16 in the layout of
    ``plan``'s instance, zero-padded: K-major (taps, co_pad, ci_pad) for
    "wgmma", so that each (tap, Ci chunk, Co tile) is one box of whole K
    rows; (taps, ci_pad, co_pad) for "mma_sync". One pass: the copy casts."""
    kd, kh, kw, ci, co = w.shape
    taps = kd * kh * kw
    wt = w.reshape(taps, ci, co)
    if plan["instance"] == "wgmma":
        wp = w.new_zeros((taps, plan["co_pad"], plan["ci_pad"]), dtype=torch.bfloat16)
        wp[:, :co, :ci] = wt.transpose(1, 2)
    else:
        wp = w.new_zeros((taps, plan["ci_pad"], plan["co_pad"]), dtype=torch.bfloat16)
        wp[:, :ci, :co] = wt
    return wp


def _to_multiple_of_8_channels(x: torch.Tensor, w: torch.Tensor):
    """Give the kernel a channel count that is a multiple of 8 (16-byte copies).

    A narrow input (kW*Ci <= 32: the 1-channel input conv) gets its kW taps
    along W packed into channels, x'[..., w, (dx, i)] = x[..., w + dx - pW, i]
    with zeros past the edges, and the kernel becomes (kD, kH, 1) over kW*Ci
    channels: the same products, with 5x fewer zero channels in each MMA.
    Remaining channels are zero-padded (``_same_packed_dims``).
    """
    kd, kh, kw, ci, co = w.shape
    if ci % 8 == 0:
        return x, w
    cip, kw_k = _same_packed_dims(ci, kw)
    if kw_k != kw:
        x = _pack_w_taps(x, kw)
        w = w.reshape(kd, kh, 1, kw * ci, co)
    return F.pad(x, (0, cip - x.shape[-1])), F.pad(w, (0, 0, 0, cip - w.shape[3]))


def _pack_w_taps(x: torch.Tensor, kw: int) -> torch.Tensor:
    """x'[..., w, (dx, i)] = x[..., w + dx - pW, i], zeros past the edges:
    a conv with kW taps along W over x is a conv with one tap over x'."""
    pw, wl = (kw - 1) // 2, x.shape[3]
    xp = F.pad(x, (0, 0, pw, pw))
    return torch.cat([xp[:, :, :, dx:dx + wl] for dx in range(kw)], dim=-1)


# ------------------------------------------------ per-sample kernels (K2-K4)


def conv3d_same_persample_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    transpose_taps: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``conv3d_same_persample``: a grouped conv, groups = N.

    x: (N,D,H,W,C), w: (N,kD,kH,kW,Ci,Co) with odd taps. Forward: C = Ci, out
    (N,D,H,W,Co). transpose_taps: x is a cotangent with C = Co and the result
    is conv(x, flip(w) with i and o swapped), (N,D,H,W,Ci). Output in
    ``out_dtype`` (default: the accumulation dtype, fp32 or fp64).
    """
    n, kd, kh, kw = w.shape[:4]
    xr = _round(x, compute_dtype)
    wr = _round(w, compute_dtype).to(xr.dtype)
    if transpose_taps:
        wr = wr.flip((1, 2, 3)).transpose(4, 5)
    ci, co = wr.shape[4:]
    if x.shape[0] != n or x.shape[-1] != ci:
        raise ValueError(f"conv3d_same_persample: x {tuple(x.shape)} does not fit w "
                         f"{tuple(w.shape)} (transpose_taps={transpose_taps})")
    d, h, wl = x.shape[1:4]
    y = F.conv3d(
        xr.permute(0, 4, 1, 2, 3).reshape(1, n * ci, d, h, wl),
        wr.permute(0, 5, 4, 1, 2, 3).reshape(n * co, ci, kd, kh, kw),
        padding=((kd - 1) // 2, (kh - 1) // 2, (kw - 1) // 2),
        groups=n,
    ).reshape(n, co, d, h, wl).permute(0, 2, 3, 4, 1)
    return y.to(out_dtype or y.dtype).contiguous()


def conv3d_same_persample(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    transpose_taps: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """'same' stride-1 3-D conv with a different kernel per sample (K2), or
    with ``transpose_taps`` its transpose (K3, the dx of the forward).

    x: (N,D,H,W,C), w: (N,kD,kH,kW,Ci,Co) in its forward layout either way
    (see ``conv3d_same_persample_plain``). On a CUDA tensor: one launch of the
    bf16 tensor-core kernel on the current stream, the instance and tiles of
    ``conv3d_same_persample_plan`` (``compute_dtype`` bf16, or None with a
    bf16 ``x``; ``out_dtype`` bf16, the default); both read w in place, the
    transposed conv with its taps reversed, and write no copy of it; a
    refused launch raises with the plan in its message. On a CPU tensor:
    the plain version. ``conv3d_same_persample.launches`` counts launches of
    the forward kernel, ``.transpose_launches`` those of the transposed one.
    """
    if x.device.type == "cpu":
        return conv3d_same_persample_plain(
            x, w, transpose_taps=transpose_taps, compute_dtype=compute_dtype,
            out_dtype=out_dtype,
        )
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_persample: unsupported device {x.device}")
    y = _conv3d_same_persample_cuda(x, w, transpose_taps, compute_dtype, out_dtype)
    if transpose_taps:
        conv3d_same_persample.transpose_launches += 1
    else:
        conv3d_same_persample.launches += 1
    return y


conv3d_same_persample.launches = 0
conv3d_same_persample.transpose_launches = 0


def _bf16_operands(name, tensors, compute_dtype, device):
    cdt = compute_dtype if compute_dtype is not None else tensors[0].dtype
    if cdt != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel computes in bfloat16, got compute_dtype {cdt}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
    return [t.to(torch.bfloat16) for t in tensors]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels copy 16 bytes)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ps_packed_dims(cin: int, kw: int, transpose: bool):
    """(contraction channels, kW) of the problem ``_persample_operands``
    hands K2/K3."""
    if cin % 8 and not transpose and kw > 1 and kw * cin <= 32:
        cin, kw = kw * cin, 1
    return -(-cin // 8) * 8, kw


def _persample_operands(x: torch.Tensor, w: torch.Tensor, transpose: bool):
    """Give K2/K3 a contraction channel count (x's) and, forward, a kernel
    output axis that are multiples of 8 (16-byte copies). Only the narrow
    1-channel input and output convs are touched, so the copies are of 1-8
    channel tensors. A narrow forward input gets its kW taps packed into
    channels (``_pack_w_taps``; w becomes (N,kD,kH,1,kW*Ci,Co)), then zero
    channels; a narrow transposed input (the cotangent of a Co=1 conv) gets
    zero channels, and w zero columns on its output axis to match. The conv's
    value on the original output channels is unchanged.
    """
    n, kd, kh, kw, ci, co = w.shape
    cip, kw_k = _ps_packed_dims(co if transpose else ci, kw, transpose)
    if kw_k != kw:
        x = _pack_w_taps(x, kw)
        w = w.reshape(n, kd, kh, 1, kw * ci, co)
    if x.shape[-1] != cip:
        pad = cip - x.shape[-1]
        x, w = F.pad(x, (0, pad)), F.pad(w, (0, pad) if transpose else (0, 0, 0, pad))
    if not transpose and w.shape[-1] % 8:
        w = F.pad(w, (0, -w.shape[-1] % 8))
    return x, w


def _conv3d_same_persample_cuda(x, w, transpose, compute_dtype, out_dtype) -> torch.Tensor:
    name = "conv3d_same_persample"
    if x.dim() != 5 or w.dim() != 6:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be 5-D and w {tuple(w.shape)} 6-D")
    n, d, h, wl, c = x.shape
    wn, kd, kh, kw, wci, wco = w.shape
    cin, cout = (wco, wci) if transpose else (wci, wco)
    if wn != n or c != cin or kd % 2 == 0 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"{name}: w {tuple(w.shape)} must have odd taps and fit x "
                         f"{tuple(x.shape)} (transpose_taps={transpose})")
    if (out_dtype or torch.bfloat16) != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel writes bfloat16, got out_dtype {out_dtype}")
    xb, wb = _bf16_operands(name, (x, w), compute_dtype, x.device)
    plan = conv3d_same_persample_plan(tuple(x.shape), cout, (kd, kh, kw), transpose,
                                      num_sms=_num_sms(x.device))
    return _k23_launch(xb, wb, transpose, plan)


def _k23_launch(x, w, transpose, plan) -> torch.Tensor:
    """Launch K2 (K3 with ``transpose``) as ``plan`` says (its instance, bm,
    mt, bn, kc, stages) on checked bf16 operands. The wide instance reads w
    in place: only the narrow 1-channel convs' operands are repacked."""
    n, d, h, wl = x.shape[:4]
    cout = w.shape[4] if transpose else w.shape[5]
    xb, wb = _persample_operands(x, w, transpose)
    xb, wb = _aligned(xb), _aligned(wb)
    kd, kh, kw = wb.shape[1:4]
    cin = xb.shape[-1]
    if [cin, kw] != plan["packed"]:
        raise ValueError(f"conv3d_same_persample: operands packed to (Ci, kW) = ({cin}, {kw}), "
                         f"plan {plan}")
    y = torch.empty((n, d, h, wl, cout), dtype=torch.bfloat16, device=x.device)
    lib = build.load("conv3d_persample")
    err = lib.conv3d_persample_bf16(
        xb.data_ptr(), wb.data_ptr(), y.data_ptr(), n, d, h, wl, cin, cout, kd, kh, kw,
        wb.shape[4], wb.shape[5], int(transpose), int(plan["instance"] == "wgmma"), plan["bm"],
        plan["mt"], plan["bn"], plan["kc"], plan["stages"],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.conv3d_persample_error_string(err).decode()
        raise RuntimeError(f"conv3d_same_persample kernel launch failed ({msg}) for x "
                           f"{tuple(x.shape)}, w {tuple(w.shape)}, transpose_taps={transpose}, "
                           f"plan {plan}")
    return y


def conv3d_same_persample_plan(x_shape, co: int, taps, transpose: bool = False, *,
                               num_sms: Optional[int] = None, device=None) -> dict:
    """The launch K2 (K3 with ``transpose``) makes for x (N,D,H,W,C), ``co``
    output channels and taps (kD,kH,kW): C is the contraction axis (Ci
    forward; the forward's Co transposed, x then being the cotangent) and
    ``co`` the output's (Co forward, the forward's Ci transposed). After the
    wrapper's channel packing (``packed``: C, kW).

    instance "wgmma" (packed C >= 16, co >= 32 and H*W >= 128 positions a
    plane): K1's wide tiles, KC, ring and their shrinking rule
    (``conv3d_same_plan``; ``num_sms`` as there), on a 1-D grid of
    ``blocks`` with the sample outermost, then the Co tile, the depth and
    the position tile, so that a
    sample's blocks run together and its kernel stays in L2. instance
    "mma_sync" (the 1-channel input conv, conv_out and its dx, the 2x8x8
    bottleneck): BM 128, BN 16/32/64, KC 16/32, two stages, grid (positions,
    Co tiles). Also: dynamic shared bytes. With a CUDA ``device`` (needs the
    card) it also reads the compiled kernel's registers and local (spill)
    bytes a thread, and checks that the kernel computes the same shared
    memory and grid.
    """
    n, d, h, wl, c = (int(v) for v in x_shape)
    kd, kh, kw = (int(v) for v in taps)
    cin, kw = _ps_packed_dims(c, kw, transpose)
    co = int(co)
    plan = None
    if cin >= 16 and co >= 32:
        plan = _wide_plan(n, d, h, wl, cin, co, kw, _plan_sms(num_sms, device))
    if plan is None:
        kc = 16 if cin <= 16 else 32
        bn = 16 if co <= 16 else (32 if co <= 32 else 64)
        tiles, slab = _k1_tiles(h, wl, kw, 128)
        b_rows, b_stride = (bn, kc + 8) if transpose else (kc, bn + 8)
        plan = dict(instance="mma_sync", bm=128, mt=1, bn=bn, kc=kc, stages=2,
                    smem_bytes=2 * (slab * (kc + 8) * 2 + kw * b_rows * b_stride * 2),
                    grid=[n * d * tiles, -(-co // bn)])
    else:
        plan["grid"] = [plan["grid"][0] * plan["grid"][1], 1]
    plan.update(packed=[cin, kw], transpose=bool(transpose),
                blocks=plan["grid"][0] * plan["grid"][1])
    if device is not None:
        plan.update(_k23_attributes(plan, (n, d, h, wl), co, (kd, kh, kw)))
    return plan


def _k23_attributes(plan, dhw, co, taps) -> dict:
    """The compiled kernel of a K2/K3 ``plan``: registers and local bytes a
    thread. Raises if the kernel's own shared memory or grid differ from the
    plan's."""
    n, d, h, wl = dhw
    cin, kw = plan["packed"]
    # the operands _persample_operands makes: w (N, T, wci, wco)
    wci, wco = (co, cin) if plan["transpose"] else (cin, -(-co // 8) * 8)
    return _compiled_plan("conv3d_persample", plan, (
        n, d, h, wl, cin, co, taps[0], taps[1], kw, wci, wco, int(plan["transpose"]),
        int(plan["instance"] == "wgmma"), plan["bm"], plan["mt"], plan["bn"], plan["kc"],
        plan["stages"]))


def conv3d_dw_persample_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    kd: int,
    kh: int,
    kw: int,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``conv3d_dw_persample``: per tap and sample, one GEMM.

    dW[n,t,i,o] = sum_p x[n, p+t-c, i] * dy[n, p, o] with zero padding.
    x: (N,D,H,W,Ci), dy: (N,D,H,W,Co) -> (N,kD,kH,kW,Ci,Co) in the
    accumulation dtype. x is zero-padded and flattened over (D,H,W); dy is
    placed at the start of a volume of the same padded shape. Position p then
    sits at the same flat index q in both, and tap t reads x at q + off(t):
    each (tap, sample) is one GEMM over a shifted view of x, no copy. The
    positions are cut into chunks that form the GEMM's batch (summed after),
    so that a GEMM with K in the hundreds of thousands still fills a card.
    """
    xr = _round(x, compute_dtype)
    dyr = _round(dy, compute_dtype).to(xr.dtype)
    n, d, h, wl, ci = x.shape
    co = dy.shape[-1]
    pd, ph, pw = (kd - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    hp, wp = h + 2 * ph, wl + 2 * pw
    xf = F.pad(xr, (0, 0, pw, pw, ph, ph, pd, pd)).reshape(n, -1, ci)
    length = xf.shape[1] - ((kd - 1) * hp * wp + (kh - 1) * wp + kw - 1)
    chunk = min(length, 4096)
    chunks = -(-length // chunk)
    extra = chunks * chunk - length  # zeros past the end, in both
    xf = F.pad(xf, (0, 0, 0, extra))
    dyf = F.pad(dyr, (0, 0, 0, 2 * pw, 0, 2 * ph, 0, 2 * pd)).reshape(n, -1, co)[:, :length]
    dyf = F.pad(dyf, (0, 0, 0, extra)).reshape(n, chunks, chunk, co)
    out = torch.empty((n, kd, kh, kw, ci, co), dtype=xr.dtype, device=x.device)
    for a in range(kd):
        for b in range(kh):
            for c in range(kw):
                off = (a * hp + b) * wp + c
                xs = xf[:, off:off + chunks * chunk].reshape(n, chunks, chunk, ci)
                for j in range(n):
                    out[j, a, b, c] = torch.bmm(xs[j].transpose(1, 2), dyf[j]).sum(0)
    return out


def conv3d_dw_persample(
    x: torch.Tensor,
    dy: torch.Tensor,
    kd: int,
    kh: int,
    kw: int,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Per-sample weight gradient of the 'same' conv (K4), fp32 out.

    x: (N,D,H,W,Ci), dy: (N,D,H,W,Co) -> (N,kD,kH,kW,Ci,Co). On a CUDA
    tensor: the bf16 tensor-core kernel on the current stream (one kernel,
    plus a pass that adds its per-split partial sums in a fixed order where
    the positions are split; no atomics). Its instance follows from the
    packed channel counts and the plane (``conv3d_dw_persample_plan``); a
    refused launch raises with the plan in its message. On a CPU tensor:
    the plain version. ``conv3d_dw_persample.launches`` counts launches.
    """
    if x.device.type == "cpu":
        return conv3d_dw_persample_plain(x, dy, kd, kh, kw, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_dw_persample: unsupported device {x.device}")
    out = _conv3d_dw_persample_cuda(x, dy, kd, kh, kw, compute_dtype)
    conv3d_dw_persample.launches += 1
    return out


conv3d_dw_persample.launches = 0


def _conv3d_dw_persample_cuda(x, dy, kd, kh, kw, compute_dtype) -> torch.Tensor:
    name = "conv3d_dw_persample"
    if x.dim() != 5 or dy.shape[:4] != x.shape[:4]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and dy {tuple(dy.shape)} must be 5-D "
                         "with the same (N,D,H,W)")
    if kd % 2 == 0 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"{name}: taps ({kd},{kh},{kw}) must be odd")
    n, d, h, wl, ci = x.shape
    co = dy.shape[-1]
    xb, dyb = _bf16_operands(name, (x, dy), compute_dtype, x.device)
    xb, dyb, kw_k = _dw_operands(xb, dyb, kw)
    xb, dyb = _aligned(xb), _aligned(dyb)
    cip, cop = xb.shape[-1], dyb.shape[-1]
    num_sms = _num_sms(x.device)
    plan = _k4_plan(n, d, h, wl, cip, cop, kd, kh, kw_k, num_sms)  # conv3d_dw_persample_plan's
    splits = plan["splits"]
    out = torch.empty((n, kd, kh, kw_k, cip, cop), dtype=torch.float32, device=x.device)
    work = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = build.load(name)
    err = lib.conv3d_dw_persample_bf16(
        xb.data_ptr(), dyb.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(),
        n, d, h, wl, cip, cop, kd, kh, kw_k, num_sms, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.conv3d_dw_persample_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed ({msg}) for x {tuple(x.shape)}, "
                           f"dy {tuple(dy.shape)}, taps ({kd},{kh},{kw}), plan {plan}")
    return _dw_unpack(out, ci, co, kw)


# K4 (csrc/conv3d_dw_persample.cu: make_plan): positions a chunk of the
# mma.sync instances and of the wgmma one, the alignment of the wgmma ring
_K4_TP = 64
_K4_WTP = 128
_K4_SMEM_ALIGN = 128
_K4_SMEM_MAX = 227 * 1024
_K4_SMEM_TWO_BLOCKS = 113 * 1024


def conv3d_dw_persample_plan(x_shape, co: int, taps, *, num_sms: Optional[int] = None,
                             device=None) -> dict:
    """The launch K4 makes for x (N,D,H,W,Ci), Co channels of dy and taps
    (kD,kH,kW), after the wrapper's channel packing (``packed``: Ci, Co, kW),
    on a card of ``num_sms`` SMs (given, else the CUDA ``device``'s, else
    132). The kernel source's ``make_plan``, in Python.

    instance "wgmma" (packed Ci >= 64, Co >= 32 and H*W >= 128 positions a
    plane): 1 warpgroup of 64 input channels, 2 where Ci >= 128 (``tile_i``
    64 or 128); ``tile_o`` (BN) 64, 32 where Co < 64, and 128 at 1 or 3
    taps a block with two warpgroups and Co >= 128; chunks of 128
    positions, one row segment where W >= 128, else rows of the power of
    two >= W (at least 8), ``a_k_stride`` bytes between the two 8-position
    core matrices of A's k16 step (128, or pitch * 16 where a chunk row has
    8 columns); as many ring stages (3-4) as leave two blocks an SM of one
    warpgroup (113 KB), else as fit one block (227 KB). instance "mma_sync" (Ci
    and Co >= 32, one of them >= 64, where wgmma does not take the shape:
    native enc2.conv1 and the 2x8x8 bottleneck): 64x64 tiles of 64-position
    chunks, 64x32 and 32x64 of two position groups and 128-position chunks,
    3 stages. instance "narrow" (the rest: the 1-channel input conv,
    conv_out, native level 1's 32->32, the s2d entry conv): 32x32 tiles, 2
    stages. Also: taps a block, splits over positions (to about 4 waves of
    blocks where the fp32 dW does not outweigh x and dy; about 16 blocks an
    SM for "narrow"), dynamic shared bytes, blocks, threads a block and fp32
    accumulators a thread. With a CUDA ``device`` (needs the card) it also
    reads the compiled kernel's registers and local (spill) bytes a thread,
    and checks that the kernel's own plan is this one.
    """
    n, d, h, wl, ci = (int(v) for v in x_shape)
    kd, kh, kw = (int(v) for v in taps)
    cip, cop, kw_k = _dw_packed_dims(ci, int(co), kw)
    sms = _plan_sms(num_sms, device)
    plan = dict(packed=[cip, cop, kw_k], **_k4_plan(n, d, h, wl, cip, cop, kd, kh, kw_k, sms))
    if device is not None and torch.device(device).type == "cuda":
        plan.update(_k4_attributes(plan, (n, d, h, wl), (kd, kh), sms))
    return plan


@functools.lru_cache(maxsize=1024)
def _k4_plan(n, d, h, wl, ci, co, kd, kh, kw, num_sms, widest=2) -> dict:
    """``make_plan``; ``widest`` 2: any instance, 1: the mma.sync ones, 0:
    the narrow one. Cached (the wrapper plans every call, and the bottleneck's
    launches take ~0.2 ms): callers copy the dict, never change it."""
    kwb = kw if kw in (1, 3, 5) else 1
    if widest >= 2 and ci >= 64 and co >= 32 and h * wl >= 128:
        instance = "wgmma"
    elif widest >= 1 and ci >= 32 and co >= 32 and (ci >= 64 or co >= 64):
        instance = "mma_sync"
    else:
        instance = "narrow"
    wgs, a_k_stride = 1, 0
    if instance == "wgmma":
        wgs = 2 if ci >= 128 else 1
        bi, groups, tp = 64 * wgs, 1, _K4_WTP
        bo = 128 if kwb != 5 and wgs == 2 and co >= 128 else (64 if co >= 64 else 32)
        tw = tp
        if wl < tp:  # rows of a power-of-two width: a k16 step is one row or two
            tw = 8
            while tw < wl:
                tw *= 2
        pitch = tw + kwb - 1
        a_k_stride = 128 if tw >= 16 else pitch * 16
        acc = kwb * bo // 2
    else:
        wi = 2 if instance == "mma_sync" and ci >= 64 else 1
        wo = 2 if instance == "mma_sync" and co >= 64 else 1
        bi, bo = (32 * wi, 32 * wo) if instance == "mma_sync" else (32, 32)
        groups = 4 // (wi * wo) if instance == "mma_sync" else 1
        tp = _K4_TP * groups
        tw = tp if wl >= tp else wl
        pitch = tw + kwb - 1
        acc = kwb * (32 if instance == "mma_sync" else 8)
    rows, segs = (1, -(-wl // tp)) if wl >= tp else (tp // tw, 1)
    chunks = d * -(-h // rows) * segs
    base = n * kd * kh * (kw // kwb) * -(-ci // bi) * -(-co // bo)
    if instance == "narrow":
        splits = -(-num_sms * 16 // base)
    elif kd * kh * kw * ci * co * 4 > d * h * wl * (ci + co) * 2:
        splits = 1  # the fp32 dW outweighs x and dy: a split-sum pass only adds bytes
    else:
        splits = -(-(num_sms * 8 // wgs) // base)
    splits = max(1, min(splits, chunks))
    per = -(-chunks // splits)
    splits = -(-chunks // per)
    slab_cap = rows * pitch
    if instance == "wgmma":
        stage = _round128(_round128(wgs * 8 * slab_cap * 16) + bo // 8 * tp * 16)
        stages = (_K4_SMEM_TWO_BLOCKS - _K4_SMEM_ALIGN) // stage if wgs == 1 else 0
        if stages < 3:
            stages = (_K4_SMEM_MAX - _K4_SMEM_ALIGN) // stage
        stages = min(4, stages)
        if stages < 3:
            return _k4_plan(n, d, h, wl, ci, co, kd, kh, kw, num_sms, widest=1)
        smem = stages * stage + _K4_SMEM_ALIGN
    elif instance == "mma_sync":
        stages = 3
        smem = max(3 * (slab_cap * (bi + 8) + tp * (bo + 8)) * 2,
                   (groups - 1) * (wi * wo) * kwb * 32 * 32 * 4)
        if smem > _K4_SMEM_MAX:  # a very narrow W makes the slab long
            return _k4_plan(n, d, h, wl, ci, co, kd, kh, kw, num_sms, widest=0)
    else:
        stages = 2
        smem = 2 * (slab_cap * 40 + _K4_TP * 40) * 2
    return dict(instance=instance, wide=instance != "narrow", taps_per_block=kwb, tile_i=bi,
                tile_o=bo, position_groups=groups, chunk_rows=rows, chunk_cols=tw,
                splits=splits, stages=stages, shared_bytes=smem, blocks=base * splits,
                threads=128 * wgs, accumulators=acc, a_k_stride=a_k_stride)


def _round128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


_K4_INSTANCES = ("narrow", "mma_sync", "wgmma")


def _k4_attributes(plan, dhw, taps_dh, num_sms) -> dict:
    """Registers and local (spill) bytes a thread of the K4 kernel that the
    source's own plan picks for these shapes. Raises if that plan differs
    from ``plan``."""
    out = (ctypes.c_int * 13)()
    cip, cop, kw_k = plan["packed"]
    lib = build.load("conv3d_dw_persample")
    err = lib.conv3d_dw_persample_plan(*dhw, cip, cop, *taps_dh, kw_k, num_sms, out)
    if err != 0:
        msg = lib.conv3d_dw_persample_error_string(err).decode()
        raise RuntimeError(f"conv3d_dw_persample_plan: {msg} for plan {plan}")
    keys = ("taps_per_block", "tile_i", "tile_o", "position_groups", "splits")
    c_plan = dict(zip(keys, out[1:6]), instance=_K4_INSTANCES[out[0]], shared_bytes=out[8],
                  stages=out[9], blocks=out[10], threads=out[11], a_k_stride=out[12])
    if any(plan[k] != v for k, v in c_plan.items()):
        raise RuntimeError(f"conv3d_dw_persample_plan: the kernel plans {c_plan}, "
                           f"the host {plan}")
    return {"registers": out[6], "local_bytes": out[7]}


def _dw_packed_dims(ci: int, co: int, kw: int):
    """(Ci, Co, kW) of the problem ``_dw_operands`` hands the kernel."""
    if ci % 8 and kw > 1 and kw * ci <= 32:
        ci, kw = kw * ci, 1
    return -(-ci // 8) * 8, -(-co // 8) * 8, kw


def _dw_operands(x: torch.Tensor, dy: torch.Tensor, kw: int):
    """Give K4 channel counts that are multiples of 8: a narrow input (the
    1-channel input conv) gets its kW taps packed into channels, so its dW
    comes out as (kD,kH,1,kW*Ci) and is unpacked by ``_dw_unpack``; other
    counts are zero-padded. Returns (x, dy, kW of the packed problem)."""
    cip, cop, kw_k = _dw_packed_dims(x.shape[-1], dy.shape[-1], kw)
    if kw_k != kw:
        x = _pack_w_taps(x, kw)
    return F.pad(x, (0, cip - x.shape[-1])), F.pad(dy, (0, cop - dy.shape[-1])), kw_k


def _dw_unpack(out: torch.Tensor, ci: int, co: int, kw: int) -> torch.Tensor:
    """The dW of ``_dw_operands``' problem -> (N,kD,kH,kW,Ci,Co)."""
    n, kd, kh, kw_k = out.shape[:4]
    out = out[..., :(kw // kw_k) * ci, :co]
    return out.reshape(n, kd, kh, kw, ci, co).contiguous()


# ------------------------------------------ D-padded chain kernel (K5)


def conv3d_dpad_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``conv3d_dpad``: the kernel's function in PyTorch ops.

    x: (N, D+kD-1, H, W, Ci) with (kD-1)/2 zero halo rows at each depth
    edge; w: (kD,kH,kW,Ci,Co) with odd taps; bias (Co,). The depth halo is
    physical, so the conv is VALID in D over the padded rows and 'same' in H
    and W. Returns act(conv + bias) as (N, D+kD-1, H, W, Co) with the halo
    rows written as zeros, in ``out_dtype`` (default: the accumulation
    dtype, fp32 or fp64).
    """
    kd, kh, kw = w.shape[:3]
    pd = (kd - 1) // 2
    xr = _round(x, compute_dtype)
    wr = _round(w, compute_dtype).to(xr.dtype)
    y = F.conv3d(
        xr.permute(0, 4, 1, 2, 3),
        wr.permute(4, 3, 0, 1, 2),
        padding=(0, (kh - 1) // 2, (kw - 1) // 2),
    ).permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if relu:
        y = torch.relu(y)
    return F.pad(y, (0, 0, 0, 0, 0, 0, pd, pd)).to(out_dtype or y.dtype).contiguous()


def conv3d_dpad(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Chainable 'same' conv on depth-padded tensors (K5), output in the
    compute dtype (x's dtype when None) with its depth halo rows zero.

    See ``conv3d_dpad_plain`` for the function. On a CUDA tensor: one launch
    of the bf16 tensor-core kernel on the current stream, the instance and
    tiles of ``conv3d_dpad_plan``; a refused launch raises with the plan in
    its message. It takes what the s2d levels of the serving net give it,
    and raises on anything else: x contiguous bf16 NDHWC (``compute_dtype``
    bf16 or None), taps (kD,3,3) with kD in {3,5}, Ci and Co multiples of
    128. It writes the halo rows itself and makes no padded copy of x and
    no repacked copy of w. It has no backward: with grad enabled and an
    input that requires grad it raises. On a CPU tensor: the plain version.
    ``conv3d_dpad.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        odt = compute_dtype or x.dtype
        return conv3d_dpad_plain(x, w, bias, relu=relu, compute_dtype=compute_dtype,
                                 out_dtype=odt)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_dpad: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias)
    ):
        raise RuntimeError(
            "conv3d_dpad: the CUDA kernel has no backward, and an input requires grad; "
            "run this conv under torch.no_grad()"
        )
    y = _conv3d_dpad_cuda(x, w, bias, relu, compute_dtype)
    conv3d_dpad.launches += 1
    return y


conv3d_dpad.launches = 0


def _conv3d_dpad_cuda(x, w, bias, relu, compute_dtype) -> torch.Tensor:
    name = "conv3d_dpad"
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} must be 5-D")
    n, dp, h, wl, ci = x.shape
    kd, kh, kw, wci, co = w.shape
    if kd not in (3, 5) or kh != 3 or kw != 3 or wci != ci:
        raise ValueError(f"{name}: w {tuple(w.shape)} must have taps (3|5, 3, 3) and Ci={ci}")
    if ci % 128 or co % 128:
        raise ValueError(f"{name}: Ci={ci} and Co={co} must be multiples of 128")
    if dp <= kd - 1:
        raise ValueError(f"{name}: padded depth {dp} leaves no interior row for kD={kd}")
    if compute_dtype not in (None, torch.bfloat16) or x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bfloat16 x and computes in "
                         f"bfloat16, got x {x.dtype}, compute_dtype {compute_dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous NDHWC with a 16-byte aligned start")
    for nm, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {nm} on {t.device}, x on {x.device}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} must be ({co},)")
    return _k5_launch(x, w, bias, relu, conv3d_dpad_plan(tuple(x.shape), co, (kd, kh, kw)))


def _k5_launch(x, w, bias, relu, plan) -> torch.Tensor:
    """Launch K5 as ``plan`` says (its instance, bm, mt, bn, kc, stages) on
    checked operands: x contiguous bf16, w (kD,3,3,Ci,Co) cast to bf16 and
    read in place by either instance, bias fp32."""
    n, dp, h, wl, ci = x.shape
    kd, co = w.shape[0], w.shape[-1]
    wb = _aligned(w.to(torch.bfloat16))
    bf = None if bias is None else _aligned(bias.to(torch.float32))
    y = torch.empty((n, dp, h, wl, co), dtype=torch.bfloat16, device=x.device)
    lib = build.load("conv3d_dpad")
    err = lib.conv3d_dpad_bf16(
        x.data_ptr(), wb.data_ptr(), None if bf is None else bf.data_ptr(), y.data_ptr(),
        n, dp, h, wl, ci, co, kd, int(plan["instance"] == "wgmma"), plan["bm"], plan["mt"],
        plan["bn"], plan["kc"], plan["stages"], int(relu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.conv3d_dpad_error_string(err).decode()
        raise RuntimeError(f"conv3d_dpad kernel launch failed ({msg}) for x {tuple(x.shape)}, "
                           f"w {tuple(w.shape)}, plan {plan}")
    return y


def conv3d_dpad_plan(x_shape, co: int, taps, *, device=None) -> dict:
    """The launch K5 makes for the depth-padded x (N,Dp,H,W,Ci), Co output
    channels and taps (kD,3,3).

    instance "wgmma" (H*W >= 128 positions a plane: every s2d shape of the
    net): K1's wide tile (``conv3d_same_plan``) over the Dp planes, halo
    planes included (their blocks write zeros), at its widest: with Ci and
    Co multiples of 128, one m64 tile a warpgroup, 2 warpgroups (1 where W
    < 16), BN 128, KC 32, the one tile the source compiles. K1's rule that
    shrinks the tile of a grid under 3/4 of a wave is not applied: the s2d
    convs give at least 320 blocks even at a batch of one. The grid is 1-D
    with the Co tile fastest. instance "mma_sync" (planes under 128
    positions): BM 128, BN 128, KC 32, two stages, the Co tile on grid y.
    Also: dynamic shared bytes, grid and blocks. With a CUDA ``device``
    (needs the card) it also reads the compiled kernel's registers and local
    (spill) bytes a thread, and checks that the kernel computes the same
    shared memory and grid.
    """
    n, dp, h, wl, ci = (int(v) for v in x_shape)
    kd, co = int(taps[0]), int(co)
    plan = _wide_plan(n, dp, h, wl, ci, co, 3, num_sms=0)  # 0: never shrink
    if plan is None:
        tiles, slab = _k1_tiles(h, wl, 3, 128)
        plan = dict(instance="mma_sync", bm=128, mt=1, bn=128, kc=32, stages=2,
                    smem_bytes=2 * (slab * 40 * 2 + 3 * 32 * 136 * 2),
                    grid=[n * dp * tiles, co // 128])
    else:
        plan["grid"] = [plan["grid"][0] * plan["grid"][1], 1]
    plan["blocks"] = plan["grid"][0] * plan["grid"][1]
    if device is not None:
        plan.update(_k5_attributes(plan, (n, dp, h, wl, ci), co, kd))
    return plan


def _k5_attributes(plan, shape, co, kd) -> dict:
    """The compiled kernel of a K5 ``plan``: registers and local bytes a
    thread. Raises if the kernel's own shared memory or grid differ from the
    plan's."""
    return _compiled_plan("conv3d_dpad", plan, (
        *shape, co, kd, int(plan["instance"] == "wgmma"), plan["bm"], plan["mt"], plan["bn"],
        plan["kc"], plan["stages"]))


# ------------------------------------------------ tap-concat entry conv (K6)

TAPCONCAT_TAPS = (5, 3, 3)
TAPCONCAT_CI = 4


def _tapconcat_patches(x: torch.Tensor) -> torch.Tensor:
    """(N,D,H,W,4) -> (N, D*H*W, 180): the 45 shifted 4-lane slices of the
    zero-padded x, taps (dz,dy,dx) lexicographic, lanes minor."""
    kd, kh, kw = TAPCONCAT_TAPS
    n, d, h, wl, ci = x.shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2, kd // 2, kd // 2))
    parts = [xp[:, a:a + d, b:b + h, c:c + wl]
             for a in range(kd) for b in range(kh) for c in range(kw)]
    return torch.cat(parts, dim=-1).reshape(n, d * h * wl, kd * kh * kw * ci)


def conv3d_tapconcat_persample_plain(
    x: torch.Tensor,
    wn: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``conv3d_tapconcat_persample``: the patch matrix of
    each sample times its weights, one ``bmm``.

    x: (N,D,H,W,4), wn: (N,180,Co) with rows tap-major ((dz,dy,dx) over taps
    (5,3,3), lexicographic) times the 4 lanes, 'same' zero padding. Inputs
    rounded to the compute dtype, sums in the accumulation dtype; output
    (N,D,H,W,Co) in ``out_dtype`` (default: the accumulation dtype).
    """
    n, d, h, wl, ci = x.shape
    if ci != TAPCONCAT_CI or wn.shape[:2] != (n, 45 * ci):
        raise ValueError(f"conv3d_tapconcat_persample: x {tuple(x.shape)} and wn "
                         f"{tuple(wn.shape)} must be (N,D,H,W,4) and (N,180,Co)")
    xr = _round(x, compute_dtype)
    wr = _round(wn, compute_dtype).to(xr.dtype)
    y = torch.bmm(_tapconcat_patches(xr), wr).reshape(n, d, h, wl, wn.shape[-1])
    return y.to(out_dtype or y.dtype)


def conv3d_tapconcat_persample(
    x: torch.Tensor,
    wn: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Per-sample 'same' conv of a 4-lane input as one K=180 GEMM per tile
    (K6): the space-to-depth entry conv of training (``encoder_block1.conv1``).

    See ``conv3d_tapconcat_persample_plain`` for the function. On a CUDA
    tensor: one launch of the bf16 tensor-core kernel on the current stream,
    the instance ``conv3d_tapconcat_persample_plan`` picks (``compute_dtype``
    bf16, or None with a bf16 x; ``out_dtype`` bf16, the default); w is read
    in place, copied only to pad Co to a multiple of 8. It raises on another
    compute or output dtype, on an input with other than 4 channels, on
    weights for taps other than (5,3,3) and on a launch that fails. On a
    CPU tensor: the plain version. ``conv3d_tapconcat_persample.launches``
    counts kernel launches.
    """
    if x.device.type == "cpu":
        return conv3d_tapconcat_persample_plain(x, wn, compute_dtype=compute_dtype,
                                                out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_tapconcat_persample: unsupported device {x.device}")
    y = _conv3d_tapconcat_cuda(x, wn, compute_dtype, out_dtype)
    conv3d_tapconcat_persample.launches += 1
    return y


conv3d_tapconcat_persample.launches = 0


def _conv3d_tapconcat_cuda(x, wn, compute_dtype, out_dtype) -> torch.Tensor:
    name = "conv3d_tapconcat_persample"
    if x.dim() != 5 or wn.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be 5-D and wn {tuple(wn.shape)} 3-D")
    n, d, h, wl, ci = x.shape
    taps = TAPCONCAT_TAPS[0] * TAPCONCAT_TAPS[1] * TAPCONCAT_TAPS[2]
    if ci != TAPCONCAT_CI:
        raise ValueError(f"{name}: the CUDA kernel takes a {TAPCONCAT_CI}-channel input, got "
                         f"x {tuple(x.shape)}")
    if wn.shape[0] != n or wn.shape[1] != taps * ci:
        raise ValueError(f"{name}: wn {tuple(wn.shape)} must be (N, {taps * ci}, Co): taps "
                         f"{TAPCONCAT_TAPS} x {ci} lanes for x {tuple(x.shape)}")
    if (out_dtype or torch.bfloat16) != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel writes bfloat16, got out_dtype {out_dtype}")
    xb, wb = _bf16_operands(name, (x, wn), compute_dtype, x.device)
    co = wb.shape[-1]
    if co % 8:
        wb = F.pad(wb, (0, -co % 8))  # 16-byte weight rows
    plan = conv3d_tapconcat_persample_plan(tuple(x.shape), co, num_sms=_num_sms(x.device))
    return _k6_launch(_aligned(xb), _aligned(wb), co, plan)


def _k6_launch(xb, wb, co, plan) -> torch.Tensor:
    """Launch K6 as ``plan`` says (its instance, on its SM count) on checked
    operands: x contiguous bf16, w (N,180,wco) bf16 with 16-byte rows, read
    in place by either instance."""
    n, d, h, wl, _ = xb.shape
    y = torch.empty((n, d, h, wl, co), dtype=torch.bfloat16, device=xb.device)
    lib = build.load("conv3d_tapconcat")
    err = lib.conv3d_tapconcat_bf16(
        xb.data_ptr(), wb.data_ptr(), y.data_ptr(), n, d, h, wl, co, wb.shape[-1],
        _K6_INSTANCES.index(plan["instance"]), plan["num_sms"],
        torch.cuda.current_stream(xb.device).cuda_stream,
    )
    if err != 0:
        msg = lib.conv3d_tapconcat_error_string(err).decode()
        raise RuntimeError(f"conv3d_tapconcat_persample kernel launch failed ({msg}) for x "
                           f"{tuple(xb.shape)}, wn {tuple(wb.shape)}, plan {plan}")
    return y


_K6_INSTANCES = ("mma_sync", "wgmma")
_K6_SMEM_TWO_BLOCKS = 113 * 1024


def conv3d_tapconcat_persample_plan(x_shape, co: int, *, num_sms: Optional[int] = None,
                                    device=None) -> dict:
    """The launch K6 makes for x (N,D,H,W,4) and Co output channels, on a
    card of ``num_sms`` SMs (given, else the CUDA ``device``'s, else 132).
    The kernel source's ``plan_launch``, in Python.

    instance "wgmma" (Co a multiple of 32, W even and >= 8, H*W >= 128
    positions a plane: the s2d entry conv of the net): ``tile`` [rows, columns] of 128
    output positions, [2, 64] for W in 64..127, [1, 128] for W >= 128,
    [16, 8] (8x8 patches) below 64; ``bn`` the Co tile, 128, 64 or 32 (the
    narrowest that covers Co up to 128), ``co_tiles`` of them; ``tiles``
    over every (sample, Co tile), in (sample, Co tile, depth, row, column)
    order; persistent ``blocks``: the SM count times ``blocks_per_sm``
    (2 where a block's shared memory is at most 113 KB, else 1), at most
    one a tile, block c taking tiles [c*tiles//blocks, (c+1)*tiles//blocks);
    ``weight_loads``, the most (sample, Co tile) weight sets a block loads.
    instance "mma_sync" (the rest; the first design): tiles of 128 positions
    (a row segment where W >= 128, else whole rows), 4 a block, BN 128, one
    block per 4 tiles of a sample and Co tile, one weight load each. Also:
    dynamic shared bytes, grid and blocks. With a CUDA ``device`` (needs the
    card) it also reads the compiled kernel's registers and local (spill)
    bytes a thread, and checks that the kernel computes the same shared
    memory and grid.
    """
    n, d, h, wl, _ = (int(v) for v in x_shape)
    sms = _plan_sms(num_sms, device)
    plan = dict(_k6_plan(n, d, h, wl, int(co), sms))
    if device is not None and torch.device(device).type == "cuda":
        plan.update(_compiled_plan("conv3d_tapconcat", plan, (
            n, d, h, wl, int(co), -(-int(co) // 8) * 8, _K6_INSTANCES.index(plan["instance"]),
            sms)))
    return plan


@functools.lru_cache(maxsize=256)
def _k6_plan(n, d, h, wl, co, num_sms) -> dict:
    """``plan_launch``. Cached (the wrapper plans every call): callers copy
    the dict, never change it."""
    tw = 128 if wl >= 128 else (64 if wl >= 64 else 8)
    rows = 128 // tw
    per_key = d * -(-h // rows) * -(-wl // tw)  # tiles of one (sample, Co tile)
    bn = 128 if co >= 128 else (64 if co >= 64 else 32)
    co_tiles = -(-co // bn)
    tiles = n * co_tiles * per_key
    if co % 32 == 0 and wl >= 8 and wl % 2 == 0 and h * wl >= 128 and tiles < 2**31:
        s2 = _round128(5 * (rows + 2) * (tw + 2) * 16)  # a paired slab
        slab = _round128(5 * (rows + 2) * (tw + 4) * 8)  # a plain slab: columns w0-2..w0+tw+1
        smem = _K1_SWIZZLE_ALIGN + 240 * bn * 2 + 2 * 128 * bn * 2 + 2 * s2 + 2 * slab
        per_sm = 2 if smem <= _K6_SMEM_TWO_BLOCKS else 1
        ctas = min(num_sms * per_sm, tiles)
        loads = max(((c + 1) * tiles // ctas - 1) // per_key - c * tiles // ctas // per_key + 1
                    for c in range(ctas))
        return dict(instance="wgmma", tile=[rows, tw], bn=bn, co_tiles=co_tiles, tiles=tiles,
                    blocks_per_sm=per_sm, weight_loads=loads, smem_bytes=smem, grid=[ctas, 1],
                    blocks=ctas, num_sms=num_sms)
    rows, tw = (1, 128) if wl >= 128 else (128 // wl, wl)
    per_key = d * (h * -(-wl // 128) if wl >= 128 else -(-h // rows))
    blocks_per_key = -(-per_key // 4)
    co_tiles = -(-co // 128)
    smem = 128 * 200 * 2 + 192 * 136 * 2 + 5 * (rows + 2) * (tw + 2) * 4 * 2
    return dict(instance="mma_sync", tile=[rows, tw], bn=128, co_tiles=co_tiles,
                tiles=n * co_tiles * per_key, blocks_per_sm=2, weight_loads=1, smem_bytes=smem,
                grid=[n * blocks_per_key, co_tiles], blocks=n * blocks_per_key * co_tiles,
                num_sms=num_sms)


def conv3d_same_tapmajor(
    x: torch.Tensor, w: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """'same' conv for a small output channel count, tap-major (the s2d
    ``conv_out``, Co=4; the JAX package's XLA formulation, no kernel):

        z[p, t*Co+o] = sum_i x[p, i] * w[t, i, o]      (one matmul, N = T*Co)
        y[p, o]      = sum_t z[p + offset_t, t*Co+o]   (T shifted adds)

    z is in the compute dtype when one is given (fp32 or wider in exact
    mode); the shifted adds and the output are fp32 (fp64 stays fp64).
    """
    kd, kh, kw, ci, co = w.shape
    n, d, h, wl, _ = x.shape
    t = kd * kh * kw
    xc = _acc_or_compute(x, compute_dtype)
    w2 = w.reshape(t, ci, co).permute(1, 0, 2).reshape(ci, t * co)
    z = torch.matmul(xc, w2.to(xc.dtype))
    zp = F.pad(z, (0, 0, (kw - 1) // 2, (kw - 1) // 2, (kh - 1) // 2, (kh - 1) // 2,
                   (kd - 1) // 2, (kd - 1) // 2))
    y = torch.zeros((n, d, h, wl, co), dtype=_acc_dtype(z.dtype), device=x.device)
    ti = 0
    for dz in range(kd):
        for dy in range(kh):
            for dx in range(kw):
                y += zp[:, dz:dz + d, dy:dy + h, dx:dx + wl, ti * co:(ti + 1) * co]
                ti += 1
    return y


def downsample2x_conv(
    x: torch.Tensor, w: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Stride-2 kernel-2 conv (reference Conv3d(k=2, s=2, bias=False)).

    out[n,d,h,w,o] = sum_{abci} x[n,2d+a,2h+b,2w+c,i] * w[a,b,c,i,o].
    x: (N,2D,2H,2W,Ci), w: (2,2,2,Ci,Co) -> (N,D,H,W,Co) in the
    accumulation dtype.
    """
    n, d2, h2, w2, ci = x.shape
    d, h, wi = d2 // 2, h2 // 2, w2 // 2
    co = w.shape[-1]
    xr = _round(x, compute_dtype)
    wr = _round(w, compute_dtype).to(xr.dtype)
    xb = xr.reshape(n, d, 2, h, 2, wi, 2, ci).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return torch.matmul(xb.reshape(n, d, h, wi, 8 * ci), wr.reshape(8 * ci, co))


def upsample2x_convt(
    x: torch.Tensor, w: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Stride-2 kernel-2 transposed conv (reference ConvTranspose3d(k=2, s=2)).

    out[n,2d+a,2h+b,2w+c,o] = sum_i x[n,d,h,w,i] * w[a,b,c,i,o].
    x: (N,D,H,W,Ci), w: (2,2,2,Ci,Co) -> (N,2D,2H,2W,Co) in the
    accumulation dtype.
    """
    n, d, h, wi, ci = x.shape
    co = w.shape[-1]
    xr = _round(x, compute_dtype)
    wr = _round(w, compute_dtype).to(xr.dtype)
    wm = wr.reshape(8, ci, co).permute(1, 0, 2).reshape(ci, 8 * co)
    y = torch.matmul(xr, wm).reshape(n, d, h, wi, 2, 2, 2, co)
    return y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, 2 * d, 2 * h, 2 * wi, co)


def _box1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sum over a length-k window along ``dim`` with zero 'same' padding."""
    lo = (k - 1) // 2
    pad = [0, 0] * x.dim()
    # F.pad lists pads from the last dim backwards
    pad[2 * (x.dim() - 1 - dim)] = lo
    pad[2 * (x.dim() - 1 - dim) + 1] = k - 1 - lo
    xp = F.pad(x, pad)
    n = x.shape[dim]
    out = xp.narrow(dim, 0, n)
    for i in range(1, k):
        out = out + xp.narrow(dim, i, n)
    return out


def avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k^3 average pool, stride 1, zero padding, count_include_pad.

    Border windows divide by k^3 including the padding, as the reference's
    fixed 1/k^3 pool kernel does. x: (N,D,H,W,C).
    """
    s = _box1d(_box1d(_box1d(x, k, 1), k, 2), k, 3)
    return s * (1.0 / k**3)
