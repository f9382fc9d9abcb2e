"""The arithmetic the reference runs in, and the control's lower precision.

``FP32`` is the reference: float32 with TF32 off (``exact``), every conv
as it is. ``FP8`` is the control that the comparison must reject: the same
reference with every conv computed as float8 training computes it
(Micikevicius et al., 2022, arXiv:2209.05433): the forward's operands (input
and weight) rounded to e4m3, the backward's incoming gradient to e5m2, each
under a per-tensor scale (the tensor's largest magnitude mapped to the
format's largest value), the products summed in float32. It is the step below
bfloat16 that a faster program might be tempted to take.
"""

from __future__ import annotations

import contextlib

import torch

FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


class Precision:
    def conv(self, fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``fn(x, w)``, a convolution, in this arithmetic."""
        return fn(x, w)


def rounded(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """``t`` rounded to a float8 format under a per-tensor scale."""
    dtype, top = FORMATS[fmt]
    scale = top / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Float8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, x, w):
        xq, wq = rounded(x.detach(), "e4m3"), rounded(w.detach(), "e4m3")
        ctx.fn = fn
        ctx.save_for_backward(xq, wq)
        return fn(xq, wq)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        with torch.enable_grad():
            xg, wg = xq.detach().requires_grad_(True), wq.detach().requires_grad_(True)
            gx, gw = torch.autograd.grad(ctx.fn(xg, wg), (xg, wg), rounded(dy, "e5m2"))
        return None, gx, gw


class Float8(Precision):
    def conv(self, fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _Float8Conv.apply(fn, x, w)
        with torch.no_grad():
            return fn(rounded(x, "e4m3"), rounded(w, "e4m3"))


class Bfloat16(Precision):
    """Conv operands rounded to bfloat16, float32 sums: the configurations'
    stated precision, computed plainly (forward only)."""

    def conv(self, fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return fn(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())


FP32 = Precision()
FP8 = Float8()
BF16 = Bfloat16()


@contextlib.contextmanager
def exact():
    """float32 matmuls and convs with TF32 off, restored on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
