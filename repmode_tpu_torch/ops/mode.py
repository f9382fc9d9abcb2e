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
  mode_conv_expert_sum  the reference: five shared-kernel convs, combined;
  mode_conv_single      one merged kernel for a task-uniform batch; the
                 re-parameterized serving net (models/reparam.py) merges once
                 per task and runs this.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repmode_tpu_torch.ops.conv3d import (
    avg_pool_same,
    conv3d_dw_persample,
    conv3d_same,
    conv3d_same_persample,
)


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
    the accumulation dtype; each expert conv rounds its inputs to
    ``compute_dtype`` and returns fp32 sums; the combine runs in fp32 (the
    JAX package combines in the compute dtype; this is the more exact of
    the two). Autograd runs through it where the convs have a backward: the
    plain convs on the CPU; on the card the shared-kernel conv raises under
    grad (its kernel has no backward).
    """
    xa = x.to(torch.promote_types(x.dtype, torch.float32))
    pooled3 = avg_pool_same(xa, 3)
    pooled5 = avg_pool_same(xa, 5)
    ys = [
        conv3d_same(inp, w, compute_dtype=compute_dtype)
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
