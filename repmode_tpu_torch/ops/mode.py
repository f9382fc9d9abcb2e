"""Mixture-of-Diverse-Experts (MoDE) convolution math.

A MoDE unit (reference fnet/nn_modules/RepMode.py:123-214) holds five
experts: learnable 5^3, 3^3 and 1^3 convs, and two fixed average pools (3^3,
5^3) each followed by a learnable 1^3 conv. A task-conditioned gate gives
per-(sample, expert, out-channel) weights, softmaxed over the expert axis.
Expert order is the reference's: [conv5, conv3, conv1, avg3 o conv1,
avg5 o conv1] (RepMode.py:184-188).

Convolution is linear in its weights and the gate scales output channels,
so the gated sum of the five expert convs equals one conv with the merged
kernel (``merge_kernels``). Three executions of that one function:

  mode_conv_merged_persample  the training route: the gate merges the experts
                 into one 5^3 kernel per sample (``GateMergePerSample``: on
                 the card a hand-written forward and backward, no bank; on
                 the CPU the bank and an einsum), then ``MergedConvPerSample``
                 runs the conv with a hand-written forward (K2), dx (K3) and
                 dW (K4) on the card, their plain versions on the CPU;
  mode_conv_expert_sum  the reference: five shared-kernel convs, combined
                 (``_expert_conv``: K1 without grad, ``conv3d_same_autograd``
                 under it);
  mode_conv_single      one merged kernel for a task-uniform batch; the
                 re-parameterized serving net (models/reparam.py) merges once
                 per task and runs this.

The space-to-depth (s2d) training levels run the same three in the s2d
domain (``ops/s2d.py``), on tensors (N,D,h',w',4C) and kernels transformed
to taps (5,3,3) over 4Ci x 4Co phase blocks: ``mode_conv_merged_s2d`` (K2-K4,
and K6 + K4 for the 4-lane entry conv), ``mode_conv_expert_sum_s2d_domain``
and, for the Co <= 4 ``conv_out``, ``mode_conv_tapmajor_merged_s2d``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repmode_tpu_torch.ops.conv3d import (
    TAPCONCAT_TAPS,
    avg_pool_same,
    conv3d_dw_persample,
    conv3d_same,
    conv3d_same_autograd,
    conv3d_same_persample,
    conv3d_tapconcat_persample,
)
from repmode_tpu_torch.ops.kernels import build
from repmode_tpu_torch.ops.s2d import box_pool_s2d, s2d_conv1_kernel, s2d_conv_kernel
from repmode_tpu_torch.utils.timing import span


class ExpertKernels(NamedTuple):
    """Learnable expert kernels, DHWIO layout.

    w5: (5,5,5,Ci,Co); w3: (3,3,3,Ci,Co); w1, wa3, wa5: (1,1,1,Ci,Co). The
    fixed pool factors 1/27 and 1/125 are constants.
    """

    w5: torch.Tensor
    w3: torch.Tensor
    w1: torch.Tensor
    wa3: torch.Tensor
    wa5: torch.Tensor


def gate_logits_to_weights(logits: torch.Tensor, num_experts: int, out_chan: int) -> torch.Tensor:
    """(N, E*Co) gate logits -> (N, E, Co), softmax over the expert axis in fp32
    (fp64 stays fp64); reference g.view(N, E, Co) + Softmax(dim=1)."""
    dt = torch.promote_types(logits.dtype, torch.float32)
    g = logits.reshape(logits.shape[0], num_experts, out_chan).to(dt)
    return torch.softmax(g, dim=1)


def _pad_to(k: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad a DHWIO kernel spatially to size^3 (reference trans_kernel)."""
    pd, ph, pw = ((size - s) // 2 for s in k.shape[:3])
    return F.pad(k, (0, 0, 0, 0, pw, pw, ph, ph, pd, pd))


def expert_bank(ek: ExpertKernels, kernel_size: int = 5) -> torch.Tensor:
    """The five experts as full-size kernels: (E, k,k,k, Ci, Co).

    The pool branches become dense kernels as the reference's routing()
    composes them (RepMode.py:176-180): the 1^3 conv spread over the pool's
    support with the pool's 1/27 or 1/125 factor.
    """
    ones3 = torch.full((3, 3, 3, 1, 1), 1.0 / 27.0, dtype=ek.wa3.dtype, device=ek.wa3.device)
    ones5 = torch.full((5, 5, 5, 1, 1), 1.0 / 125.0, dtype=ek.wa5.dtype, device=ek.wa5.device)
    return torch.stack(
        [
            _pad_to(ek.w5, kernel_size),
            _pad_to(ek.w3, kernel_size),
            _pad_to(ek.w1, kernel_size),
            _pad_to(ones3 * ek.wa3, kernel_size),
            _pad_to(ones5 * ek.wa5, kernel_size),
        ],
        dim=0,
    )


def merge_kernels(ek: ExpertKernels, g: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Per-sample merged kernels: g (N, E, Co) -> (N, k,k,k, Ci, Co)."""
    bank = expert_bank(ek, kernel_size)
    return torch.einsum("neo,edhwio->ndhwio", g.to(bank.dtype), bank)


# ------------------------------------------- the training route's gate merge


def gate_merge_persample_plain(ek: ExpertKernels, g: torch.Tensor, compute_dtype=None,
                               kernel_size: int = 5) -> torch.Tensor:
    """Plain version of ``gate_merge_persample``: ``merge_kernels`` (the bank
    and the einsum, in the experts' dtype), then a cast to ``compute_dtype``.
    Its gradient is autograd's through the same ops."""
    wn = merge_kernels(ek, g, kernel_size)
    return wn if compute_dtype is None else wn.to(compute_dtype)


class GateMergePerSample(torch.autograd.Function):
    """The per-sample merged kernels of the training route, with a
    hand-written backward: the five expert kernels (DHWIO views) and the gate
    g (N,E,Co) -> wn (N,k,k,k,Ci,Co) in ``compute_dtype``.

    On a CUDA tensor: two hand-written kernels (``csrc/gate_merge.cu``). The
    forward reads the experts in the parameters' (Co,Ci,kD,kH,kW) layout and
    writes bf16 ``wn`` in K2's layout, contiguous; no bank is formed. The
    backward reads the bf16 per-sample dW once and writes the five weight
    gradients in the parameters' layout (fp32, returned as DHWIO views of
    it, so accumulating them copies nothing) and the gate's. Both sum in
    fp32 in a fixed order. bf16 compute and kernel size 5 only. On any
    other device (the CPU; the meta device of the plan tests):
    ``gate_merge_persample_plain`` and autograd through it.
    """

    @staticmethod
    def forward(ctx, w5, w3, w1, wa3, wa5, g, compute_dtype, kernel_size):
        ctx.save_for_backward(w5, w3, w1, wa3, wa5, g)
        ctx.kernel_size = kernel_size
        if g.device.type != "cuda":
            return gate_merge_persample_plain(ExpertKernels(w5, w3, w1, wa3, wa5), g,
                                              compute_dtype, kernel_size)
        return _gate_merge_cuda(ExpertKernels(w5, w3, w1, wa3, wa5), g, compute_dtype,
                                kernel_size)

    @staticmethod
    def backward(ctx, dwn):
        saved = ctx.saved_tensors
        with span("mode.merge_bwd"):
            if dwn.device.type != "cuda":
                with torch.enable_grad():
                    leaves = [t.detach().requires_grad_() for t in saved]
                    wn = gate_merge_persample_plain(ExpertKernels(*leaves[:5]), leaves[5],
                                                    None, ctx.kernel_size)
                grads = torch.autograd.grad(wn, leaves, dwn.to(wn.dtype))
            else:
                grads = _gate_merge_backward_cuda(saved, dwn)
        return (*grads, None, None)


def gate_merge_persample(ek: ExpertKernels, g: torch.Tensor, compute_dtype: torch.dtype,
                         kernel_size: int = 5) -> torch.Tensor:
    """``GateMergePerSample``: the per-sample merged kernels (N,k,k,k,Ci,Co)
    in ``compute_dtype``. ``gate_merge_persample.launches`` counts launches
    of the forward kernel, ``.backward_launches`` those of the backward."""
    return GateMergePerSample.apply(*ek, g, compute_dtype, kernel_size)


gate_merge_persample.launches = 0
gate_merge_persample.backward_launches = 0

_MERGE_PAIRS = 64    # (i, o) pairs a tile at most (csrc/gate_merge.cu: ELEMS)
_MERGE_SLOTS = 264   # two blocks an SM of an H100: the grid the plan aims at, whatever the card


@functools.lru_cache(maxsize=256)
def gate_merge_plan(n: int, ci: int, co: int) -> dict:
    """The tiles of ``csrc/gate_merge.cu`` for N samples and Ci x Co: ``bo``
    output channels (Co, or 64 above it) by ``bi`` input channels a tile (at
    most 64 pairs; fewer input channels where the tiles would not give
    ``_MERGE_SLOTS`` blocks), ``otiles`` x ``itiles`` tiles. The forward
    splits the samples over blocks, ``samples_per_block`` each, where the
    tiles alone are too few; the backward's blocks walk ``tiles_per_group``
    input tiles each, ``groups`` of them along Ci (about ``2 *
    _MERGE_SLOTS`` blocks in all). From
    the shapes alone, so that the sums' order, and the bits, are the same
    on every card. Cached: callers copy the dict, never change it."""
    bo = min(co, _MERGE_PAIRS)
    bi = max(1, min(ci, _MERGE_PAIRS // bo))
    otiles = -(-co // bo)
    while bi > 1 and otiles * -(-ci // bi) < _MERGE_SLOTS:
        bi //= 2
    itiles = -(-ci // bi)
    splits = min(n, max(1, _MERGE_SLOTS // (otiles * itiles)))
    groups = min(itiles, -(-2 * _MERGE_SLOTS // otiles))
    per = -(-itiles // groups)
    return dict(bo=bo, bi=bi, otiles=otiles, itiles=itiles, samples_per_block=-(-n // splits),
                tiles_per_group=per, groups=-(-itiles // per))


def _expert_layouts(ek: ExpertKernels, kernel_size: int):
    """The experts as the kernels read them: (Co,Ci,kD,kH,kW) fp32,
    contiguous (the parameters themselves, viewed back; a copy only for
    another layout). Raises on what the kernels do not take."""
    ci, co = ek.w5.shape[3:]
    want = [(5, 5, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1)]
    if kernel_size != 5 or [tuple(w.shape) for w in ek] != [s + (ci, co) for s in want]:
        raise ValueError(f"gate_merge_persample: the CUDA kernels take kernel_size 5 and experts "
                         f"{[s + (ci, co) for s in want]}, got kernel_size {kernel_size} and "
                         f"{[tuple(w.shape) for w in ek]}")
    if any(w.dtype != torch.float32 for w in ek):
        raise ValueError(f"gate_merge_persample: the CUDA kernels read float32 experts, got "
                         f"{[w.dtype for w in ek]}")
    return [w.permute(4, 3, 0, 1, 2).contiguous() for w in ek]


def _gate_operand(g: torch.Tensor, device, co: int) -> torch.Tensor:
    if g.dtype != torch.float32 or g.dim() != 3 or g.shape[1:] != (5, co):
        raise ValueError(f"gate_merge_persample: the gate must be float32 (N, 5, {co}), got "
                         f"{g.dtype} {tuple(g.shape)}")
    if g.device != device:
        raise ValueError(f"gate_merge_persample: gate on {g.device}, experts on {device}")
    return g.contiguous()


def _gate_merge_cuda(ek: ExpertKernels, g: torch.Tensor, compute_dtype, kernel_size):
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"gate_merge_persample: the CUDA kernel writes bfloat16, got "
                         f"compute_dtype {compute_dtype}")
    ws = _expert_layouts(ek, kernel_size)
    co, ci = ws[0].shape[:2]
    gc = _gate_operand(g, ws[0].device, co)
    n = gc.shape[0]
    plan = gate_merge_plan(n, ci, co)
    wn = torch.empty((n, 5, 5, 5, ci, co), dtype=torch.bfloat16, device=gc.device)
    lib = build.load("gate_merge")
    err = lib.gate_merge_fwd_bf16(*(w.data_ptr() for w in ws), gc.data_ptr(), wn.data_ptr(),
                                  n, ci, co, plan["bo"], plan["bi"], plan["samples_per_block"],
                                  torch.cuda.current_stream(gc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gate_merge_persample forward launch failed "
                           f"({lib.gate_merge_error_string(err).decode()}) for N={n}, Ci={ci}, "
                           f"Co={co}, plan {plan}")
    gate_merge_persample.launches += 1
    return wn


def _gate_merge_backward_cuda(saved, dwn: torch.Tensor):
    ek, g = ExpertKernels(*saved[:5]), saved[5]
    ws = _expert_layouts(ek, 5)
    co, ci = ws[0].shape[:2]
    gc = _gate_operand(g, ws[0].device, co)
    n = gc.shape[0]
    if dwn.dtype != torch.bfloat16 or tuple(dwn.shape) != (n, 5, 5, 5, ci, co):
        raise ValueError(f"gate_merge_persample: the backward reads a bfloat16 dW "
                         f"{(n, 5, 5, 5, ci, co)}, got {dwn.dtype} {tuple(dwn.shape)}")
    dwn = dwn.contiguous()
    plan = gate_merge_plan(n, ci, co)
    grads = [torch.empty_like(w) for w in ws]
    dg = torch.empty_like(gc)
    work = (torch.empty((plan["groups"],) + tuple(gc.shape), dtype=torch.float32,
                        device=gc.device) if plan["groups"] > 1 else None)
    lib = build.load("gate_merge")
    err = lib.gate_merge_bwd_bf16(
        *(w.data_ptr() for w in ws), gc.data_ptr(), dwn.data_ptr(),
        *(d.data_ptr() for d in grads), dg.data_ptr(), None if work is None else work.data_ptr(),
        n, ci, co, plan["bo"], plan["bi"], plan["tiles_per_group"], plan["groups"],
        torch.cuda.current_stream(gc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gate_merge_persample backward launch failed "
                           f"({lib.gate_merge_error_string(err).decode()}) for N={n}, Ci={ci}, "
                           f"Co={co}, plan {plan}; its shared memory holds the gate's gradient "
                           f"of every sample, N x 5 x bo floats")
    gate_merge_persample.backward_launches += 1
    return [d.permute(2, 3, 4, 1, 0) for d in grads] + [dg]


def _expert_conv(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """One shared-kernel expert conv, fp32 sums out (fp64 stays fp64).

    Where autograd records it (grad enabled, x or w requiring grad):
    ``conv3d_same_autograd``, its output widened; otherwise ``conv3d_same``
    (K1 on the card). A choice by what the call needs, not a fallback.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = conv3d_same_autograd(x, w, compute_dtype=compute_dtype)
        return y.to(torch.promote_types(y.dtype, torch.float32))
    return conv3d_same(x, w, compute_dtype=compute_dtype)


def mode_conv_expert_sum(
    x: torch.Tensor,
    ek: ExpertKernels,
    g: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Gated sum of the five expert convs. x: (N,D,H,W,Ci), g: (N,E,Co) ->
    (N,D,H,W,Co) in the accumulation dtype (fp32, or fp64 for fp64 inputs).

    Equals conv(x_n, merge_kernels(ek, g)[n]) by linearity. The pools run in
    the accumulation dtype; each expert conv (``_expert_conv``) rounds its
    inputs to ``compute_dtype``; the combine runs in fp32 (the JAX package
    combines in the compute dtype; this is the more exact of the two).
    Under autograd the convs run through ``conv3d_same_autograd`` and, as
    in JAX, round their outputs to the compute dtype; without it they run
    K1 on the card.
    """
    with span("mode.conv"):
        xa = x.to(torch.promote_types(x.dtype, torch.float32))
        pooled3 = avg_pool_same(xa, 3)
        pooled5 = avg_pool_same(xa, 5)
        ys = [
            _expert_conv(inp, w, compute_dtype)
            for inp, w in (
                (x, ek.w5), (x, ek.w3), (x, ek.w1), (pooled3, ek.wa3), (pooled5, ek.wa5)
            )
        ]
        gf = g.to(ys[0].dtype)
        out = gf[:, 0, None, None, None, :] * ys[0]
        for e in range(1, 5):
            out = out + gf[:, e, None, None, None, :] * ys[e]
        return out


class MergedConvPerSample(torch.autograd.Function):
    """'same' conv with one kernel per sample and a hand-written backward.

    The port of ``repmode_tpu/ops/mode.py:merged_conv_persample`` (a
    ``jax.custom_vjp``). x: (N,D,H,W,Ci), wn: (N,kD,kH,kW,Ci,Co), both in the
    compute dtype. Forward K2, dx K3 (the transposed conv on the forward's
    kernels, skipped when x needs no grad), dW K4; each a hand-written kernel
    on the card and its plain version on the CPU. Dtypes as in JAX: y and dx
    in x's dtype, dW summed in fp32 and returned in wn's dtype.
    """

    @staticmethod
    def forward(ctx, x, wn):
        ctx.save_for_backward(x, wn)
        return conv3d_same_persample(x, wn, compute_dtype=x.dtype, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, wn = ctx.saved_tensors
        with span("mode.conv"):
            dyc = dy.to(x.dtype)
            dx = dwn = None
            if ctx.needs_input_grad[0]:
                dx = conv3d_same_persample(dyc, wn, transpose_taps=True, compute_dtype=x.dtype,
                                           out_dtype=x.dtype)
            if ctx.needs_input_grad[1]:
                kd, kh, kw = wn.shape[1:4]
                dwn = conv3d_dw_persample(x, dyc, kd, kh, kw, compute_dtype=x.dtype).to(wn.dtype)
        return dx, dwn


def mode_conv_merged_persample(
    x: torch.Tensor,
    ek: ExpertKernels,
    g: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    kernel_size: int = 5,
) -> torch.Tensor:
    """Per-sample merged-kernel MoDE conv: the reference's routing() merge
    (RepMode.py:171-208) at merged-kernel operations.

    The native-layout counterpart of ``mode_conv_merged_s2d_pallas``: the
    gate merge ``gate_merge_persample`` (on the card two hand-written
    kernels; on the CPU the bank and the fp32 einsum) straight into the
    compute dtype (fp32 floor when None), a cast of x, then
    ``MergedConvPerSample``. x: (N,D,H,W,Ci), g: (N,E,Co) -> (N,D,H,W,Co)
    in the compute dtype.
    """
    cdt = compute_dtype or torch.promote_types(x.dtype, torch.float32)
    with span("mode.merge"):
        wn = gate_merge_persample(ek, g, cdt, kernel_size)
    with span("mode.conv"):
        return MergedConvPerSample.apply(x.to(cdt), wn)


def mode_conv_single(
    x: torch.Tensor, w: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Task-uniform batch: one merged kernel for every sample (RepMode.py:210)."""
    return conv3d_same(x, w, compute_dtype=compute_dtype)


# ------------------------------------------------- space-to-depth training


def _split_s2d_kernel(build, w: torch.Tensor, channel_sizes) -> torch.Tensor:
    """s2d-transform a kernel whose input is a concat of s2d segments.

    s2d(concat(a, b)) is not concat(s2d(a), s2d(b)) channel-wise, so the
    kernel is built per native segment and the parts are concatenated on the
    input-channel axis (JAX ``repmode_tpu/ops/mode.py:_split_s2d_kernel``)."""
    if len(channel_sizes) == 1:
        return build(w)
    parts, off = [], 0
    for c in channel_sizes:
        parts.append(build(w[:, :, :, off:off + c]))
        off += c
    return torch.cat(parts, dim=3)


def _pool_ones(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((k, k, k, 1, 1), 1.0 / k**3, dtype=like.dtype, device=like.device)


def s2d_expert_bank(ek: ExpertKernels, channel_sizes=None) -> torch.Tensor:
    """The five experts as s2d kernels on the 5^3 tap grid: (E,5,3,3,4Ci,4Co).

    Every expert is transformed to the s2d domain (the pool branches composed
    dense) and zero-padded to taps (5,3,3), so that the gate merges the bank
    into one per-sample kernel (JAX ``s2d_expert_bank``).
    """
    cs = tuple(channel_sizes) if channel_sizes else (ek.w5.shape[3],)

    def pad_d(k):  # depth taps to 5 (centred), H/W taps to 3
        pd, ph, pw = (5 - k.shape[0]) // 2, (3 - k.shape[1]) // 2, (3 - k.shape[2]) // 2
        return F.pad(k, (0, 0, 0, 0, pw, pw, ph, ph, pd, pd))

    ones3, ones5 = _pool_ones(3, ek.wa3), _pool_ones(5, ek.wa5)
    return torch.stack([
        _split_s2d_kernel(s2d_conv_kernel, ek.w5, cs),
        pad_d(_split_s2d_kernel(s2d_conv_kernel, ek.w3, cs)),
        pad_d(_split_s2d_kernel(s2d_conv1_kernel, ek.w1, cs)),
        pad_d(_split_s2d_kernel(lambda w: s2d_conv_kernel(ones3 * w), ek.wa3, cs)),
        _split_s2d_kernel(lambda w: s2d_conv_kernel(ones5 * w), ek.wa5, cs),
    ], dim=0)


def _gate4(g: torch.Tensor) -> torch.Tensor:
    """(N,E,Co) -> (N,E,4Co) in fp32 (fp64 stays): the gate of every output
    phase, phase-major."""
    return g.to(torch.promote_types(g.dtype, torch.float32)).repeat(1, 1, 4)


def mode_conv_expert_sum_s2d_domain(
    x2: torch.Tensor,
    ek: ExpertKernels,
    g: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    channel_sizes=None,
) -> torch.Tensor:
    """The gated sum of the five expert convs in the s2d domain (JAX
    ``mode_conv_expert_sum_s2d_domain``): the reference of the s2d training
    route, and the eval-mode MoDE conv of the s2d levels.

    x2: (N,D,h',w',4*sum(channel_sizes)), a concat of s2d segments where
    ``channel_sizes`` names their native widths; g: (N,E,Co) ->
    (N,D,h',w',4Co) in the accumulation dtype. The pool branches take the
    JAX package's two exact forms: composed into dense s2d kernels where a
    segment has fewer than 64 native channels (4*min(channel_sizes) < 256),
    else ``box_pool_s2d`` per segment and a pointwise conv. As in the native
    expert sum, the pools run in the accumulation dtype, each conv is an
    ``_expert_conv``, and the combine is fp32.
    """
    with span("mode.conv"):
        cs = tuple(channel_sizes) if channel_sizes else (ek.w5.shape[3],)
        ones3, ones5 = _pool_ones(3, ek.wa3), _pool_ones(5, ek.wa5)

        def cv(inp, w):
            return _expert_conv(inp, w, compute_dtype)

        ys = [cv(x2, _split_s2d_kernel(s2d_conv_kernel, ek.w5, cs)),
              cv(x2, _split_s2d_kernel(s2d_conv_kernel, ek.w3, cs)),
              cv(x2, _split_s2d_kernel(s2d_conv1_kernel, ek.w1, cs))]
        if 4 * min(cs) >= 256:
            xa = x2.to(torch.promote_types(x2.dtype, torch.float32))

            def box(k):  # the phase-major layout is per s2d segment
                parts, off = [], 0
                for c in cs:
                    parts.append(box_pool_s2d(xa[..., off:off + 4 * c], k))
                    off += 4 * c
                return torch.cat(parts, dim=-1)

            for k, w in ((3, ek.wa3), (5, ek.wa5)):
                ys.append(cv(box(k), _split_s2d_kernel(
                    lambda v, k=k: s2d_conv1_kernel(v * (1.0 / k**3)), w, cs)))
        else:
            ys.append(cv(x2, _split_s2d_kernel(lambda w: s2d_conv_kernel(ones3 * w), ek.wa3, cs)))
            ys.append(cv(x2, _split_s2d_kernel(lambda w: s2d_conv_kernel(ones5 * w), ek.wa5, cs)))
        g4 = _gate4(g).to(ys[0].dtype)
        out = g4[:, 0, None, None, None, :] * ys[0]
        for e in range(1, 5):
            out = out + g4[:, e, None, None, None, :] * ys[e]
        return out


class TapConcatConvPerSample(torch.autograd.Function):
    """The s2d entry conv (a 4-lane input, taps (5,3,3)) with one kernel per
    sample: forward K6, dW K4, dx K3.

    x: (N,D,h',w',4), wn: (N,5,3,3,4,Co), both in the compute dtype. The
    forward hands K6 the kernels as (N,180,Co), tap-major rows; the backward
    computes dW (fp32 sums, returned in wn's dtype) with K4 at taps (5,3,3),
    and dx with K3 only when x needs a gradient, which on the training path
    it never does: its input is the data.
    """

    @staticmethod
    def forward(ctx, x, wn):
        ctx.save_for_backward(x, wn)
        n, co = wn.shape[0], wn.shape[-1]
        return conv3d_tapconcat_persample(x, wn.reshape(n, -1, co), compute_dtype=x.dtype,
                                          out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, wn = ctx.saved_tensors
        with span("mode.conv"):
            dyc = dy.to(x.dtype)
            dx = dwn = None
            if ctx.needs_input_grad[0]:
                dx = conv3d_same_persample(dyc, wn, transpose_taps=True, compute_dtype=x.dtype,
                                           out_dtype=x.dtype)
            if ctx.needs_input_grad[1]:
                dwn = conv3d_dw_persample(x, dyc, *TAPCONCAT_TAPS,
                                          compute_dtype=x.dtype).to(wn.dtype)
        return dx, dwn


def mode_conv_merged_s2d(
    x2: torch.Tensor,
    ek: ExpertKernels,
    g: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    channel_sizes=None,
) -> torch.Tensor:
    """Per-sample merged-kernel MoDE conv in the s2d domain: the s2d training
    route. The counterpart of JAX's ``mode_conv_merged_s2d_pallas`` (and of
    ``mode_conv_merged_s2d_domain``, the same function run by XLA).

    The fp32 gate merge of ``s2d_expert_bank`` (autograd through bank and
    gate), a cast to the compute dtype (fp32 floor when None), then the
    per-sample conv: ``TapConcatConvPerSample`` (K6 forward, K4 dW) for the
    4-lane entry conv, ``MergedConvPerSample`` (K2, K3, K4 at 45 taps) for
    every other. Unlike JAX, no channel width takes the expert sum instead:
    its 128-lane guard is the TPU's. x2: (N,D,h',w',4*sum(channel_sizes)),
    g: (N,E,Co) -> (N,D,h',w',4Co) in the compute dtype.
    """
    with span("mode.merge"):
        bank = s2d_expert_bank(ek, channel_sizes)
        g4 = _gate4(g)
        wn = torch.einsum("neo,edhwio->ndhwio", g4, bank.to(g4.dtype))
    cdt = compute_dtype or torch.promote_types(x2.dtype, torch.float32)
    conv = TapConcatConvPerSample if x2.shape[-1] == 4 else MergedConvPerSample
    with span("mode.conv"):
        return conv.apply(x2.to(cdt), wn.to(cdt))


def _tap_sum(z: torch.Tensor, kh: int, kw: int, co: int) -> torch.Tensor:
    """y[p, o] = sum_t z[p + off_t, t*co + o] over the kh x kw H/W taps,
    'same' zero padding, in the accumulation dtype (JAX ``_tap_sum`` with
    the depth taps folded into the GEMMs)."""
    n, d, h, wl, _ = z.shape
    zp = F.pad(z.to(torch.promote_types(z.dtype, torch.float32)),
               (0, 0, (kw - 1) // 2, (kw - 1) // 2, (kh - 1) // 2, (kh - 1) // 2))
    y, ti = None, 0
    for dy in range(kh):
        for dx in range(kw):
            part = zp[:, :, dy:dy + h, dx:dx + wl, ti * co:(ti + 1) * co]
            y = part if y is None else y + part
            ti += 1
    return y


def mode_conv_tapmajor_merged_s2d(
    x2: torch.Tensor,
    ek: ExpertKernels,
    g: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    channel_sizes=None,
) -> torch.Tensor:
    """MoDE conv for a small output (Co <= 4, the s2d ``conv_out``): the
    per-sample gate-merged kernel, tap-major, depth-folded (JAX
    ``mode_conv_tapmajor_merged_s2d``, its default branch). Plain PyTorch
    ops with autograd; the JAX package computes it outside Pallas too.

    For each depth tap dz, one batched matmul of the depth-shifted x2 with
    the sample's (4Ci, 3*3*4Co) kernel slice, summed over dz in the
    accumulation dtype; then the 3x3 H/W shifted adds of ``_tap_sum``.
    x2: (N,D,h',w',4Ci), g: (N,E,Co) -> (N,D,h',w',4Co) fp32 (fp64 stays).
    """
    with span("mode.merge"):
        bank = s2d_expert_bank(ek, channel_sizes)
        g4 = _gate4(g)
        wt = torch.einsum("neo,edhwio->ndhwio", g4, bank.to(g4.dtype))
    _, kd, kh, kw, ci4, co4 = bank.shape
    n, d = x2.shape[:2]
    cdt = compute_dtype or torch.promote_types(x2.dtype, torch.float32)
    with span("mode.conv"):
        xp = F.pad(x2.to(cdt), (0, 0, 0, 0, 0, 0, (kd - 1) // 2, (kd - 1) // 2))
        z = None
        for dz in range(kd):
            wdz = wt[:, dz].permute(0, 3, 1, 2, 4).reshape(n, 1, ci4, kh * kw * co4).to(cdt)
            zd = torch.matmul(xp[:, dz:dz + d].flatten(2, 3), wdz)
            zd = zd.to(torch.promote_types(zd.dtype, torch.float32))
            z = zd if z is None else z + zd
        return _tap_sum(z.reshape(*x2.shape[:4], kh * kw * co4), kh, kw, co4)
