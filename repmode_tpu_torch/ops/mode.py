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
                 into one 5^3 kernel per sample (an einsum, autograd through
                 bank and gate), then ``MergedConvPerSample`` runs the conv
                 with a hand-written forward (K2), dx (K3) and dW (K4) on the
                 card, their plain versions on the CPU;
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
from repmode_tpu_torch.ops.s2d import box_pool_s2d, s2d_conv1_kernel, s2d_conv_kernel


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
    bank and the fp32 gate merge ``einsum("neo,edhwio->ndhwio")`` (autograd
    through both), a cast of x and the merged kernels to the compute dtype
    (fp32 floor when None), then ``MergedConvPerSample``. x: (N,D,H,W,Ci),
    g: (N,E,Co) -> (N,D,H,W,Co) in the compute dtype.
    """
    bank = expert_bank(ek, kernel_size)
    gdt = torch.promote_types(g.dtype, torch.float32)
    wn = torch.einsum("neo,edhwio->ndhwio", g.to(gdt), bank.to(gdt))
    cdt = compute_dtype or torch.promote_types(x.dtype, torch.float32)
    return MergedConvPerSample.apply(x.to(cdt), wn.to(cdt))


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
        dyc = dy.to(x.dtype)
        dx = dwn = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_same_persample(dyc, wn, transpose_taps=True, compute_dtype=x.dtype,
                                       out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dwn = conv3d_dw_persample(x, dyc, *TAPCONCAT_TAPS, compute_dtype=x.dtype).to(wn.dtype)
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
    bank = s2d_expert_bank(ek, channel_sizes)
    g4 = _gate4(g)
    wn = torch.einsum("neo,edhwio->ndhwio", g4, bank.to(g4.dtype))
    cdt = compute_dtype or torch.promote_types(x2.dtype, torch.float32)
    conv = TapConcatConvPerSample if x2.shape[-1] == 4 else MergedConvPerSample
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
    bank = s2d_expert_bank(ek, channel_sizes)
    _, kd, kh, kw, ci4, co4 = bank.shape
    n, d = x2.shape[:2]
    g4 = _gate4(g)
    wt = torch.einsum("neo,edhwio->ndhwio", g4, bank.to(g4.dtype))
    cdt = compute_dtype or torch.promote_types(x2.dtype, torch.float32)
    xp = F.pad(x2.to(cdt), (0, 0, 0, 0, 0, 0, (kd - 1) // 2, (kd - 1) // 2))
    z = None
    for dz in range(kd):
        wdz = wt[:, dz].permute(0, 3, 1, 2, 4).reshape(n, 1, ci4, kh * kw * co4).to(cdt)
        zd = torch.matmul(xp[:, dz:dz + d].flatten(2, 3), wdz)
        zd = zd.to(torch.promote_types(zd.dtype, torch.float32))
        z = zd if z is None else z + zd
    return _tap_sum(z.reshape(*x2.shape[:4], kh * kw * co4), kh, kw, co4)
