"""3-D conv primitives on NDHWC activations and DHWIO kernels.

``conv3d_same`` is the port of the TPU kernel
``repmode_tpu/ops/pallas/conv3d.py:pallas_conv3d_same``: on a CUDA tensor it
launches the hand-written kernel in ``csrc/conv3d_same.cu``; on a CPU tensor
it runs ``conv3d_same_plain``, the plain PyTorch version that defines the
same arithmetic (inputs rounded to the compute dtype, sums in fp32, fp32
epilogue).

The k=2, s=2 down/upsample convs have non-overlapping windows, so they are
reshapes around one matrix product, as in the JAX package.
"""

from __future__ import annotations

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


def conv3d_same_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of ``conv3d_same``: the kernel's function in PyTorch ops.

    x: (N,D,H,W,Ci), w: (kD,kH,kW,Ci,Co) with odd taps, bias: (Co,).
    Returns act(conv(x, w) + bias) as (N,D,H,W,Co) in ``out_dtype``
    (default: the accumulation dtype, fp32 or fp64).
    """
    kd, kh, kw = w.shape[:3]
    xr = _round(x, compute_dtype)
    wr = _round(w, compute_dtype).to(xr.dtype)
    y = F.conv3d(
        xr.permute(0, 4, 1, 2, 3),
        wr.permute(4, 3, 0, 1, 2),
        padding=((kd - 1) // 2, (kh - 1) // 2, (kw - 1) // 2),
    ).permute(0, 2, 3, 4, 1)
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
    relu: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """'same' stride-1 3-D conv with an optional fused bias(+ReLU) epilogue.

    On a CUDA tensor: one launch of the bf16 tensor-core kernel on the
    current stream (``compute_dtype`` must be bf16, or None with a bf16
    ``x``; ``out_dtype`` fp32 (default) or bf16). On a CPU tensor: the plain
    version. ``conv3d_same.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return conv3d_same_plain(
            x, w, bias, relu=relu, compute_dtype=compute_dtype, out_dtype=out_dtype
        )
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same: unsupported device {x.device}")
    y = _conv3d_same_cuda(x, w, bias, relu, compute_dtype, out_dtype)
    conv3d_same.launches += 1
    return y


conv3d_same.launches = 0


def _conv3d_same_cuda(x, w, bias, relu, compute_dtype, out_dtype) -> torch.Tensor:
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
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3d_same: {name} on {t.device}, x on {x.device}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"conv3d_same: bias {tuple(bias.shape)} must be ({co},)")

    xb, w = _to_multiple_of_8_channels(x.to(torch.bfloat16), w)
    kd, kh, kw, ci, co = w.shape
    kc = 16 if ci <= 16 else 32
    bn = 16 if co <= 16 else (32 if co <= 32 else 64)
    ci_pad = -(-ci // kc) * kc
    co_pad = -(-co // bn) * bn
    taps = kd * kh * kw

    xb = xb.contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    wp = torch.zeros((taps, ci_pad, co_pad), dtype=torch.bfloat16, device=x.device)
    wp[:, :ci, :co] = w.reshape(taps, ci, co)
    bp = None
    if bias is not None:
        bp = torch.zeros((co_pad,), dtype=torch.float32, device=x.device)
        bp[:co] = bias
    y = torch.empty((n, d, h, wl, co), dtype=odt, device=x.device)

    lib = build.load("conv3d_same")
    err = lib.conv3d_same_bf16(
        xb.data_ptr(), wp.data_ptr(), None if bp is None else bp.data_ptr(), y.data_ptr(),
        n, d, h, wl, ci, co, kd, kh, kw, ci_pad, co_pad, kc, bn, int(relu),
        int(odt == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.conv3d_same_error_string(err).decode()
        raise RuntimeError(
            f"conv3d_same kernel launch failed ({msg}) for x {tuple(x.shape)}, w {tuple(w.shape)}"
        )
    return y


def _to_multiple_of_8_channels(x: torch.Tensor, w: torch.Tensor):
    """Give the kernel a channel count that is a multiple of 8 (16-byte copies).

    A narrow input (kW*Ci <= 32: the 1-channel input conv) gets its kW taps
    along W packed into channels, x'[..., w, (dx, i)] = x[..., w + dx - pW, i]
    with zeros past the edges, and the kernel becomes (kD, kH, 1) over kW*Ci
    channels: the same products, with 5x fewer zero channels in each MMA.
    Remaining channels are zero-padded.
    """
    ci = x.shape[-1]
    if ci % 8 == 0:
        return x, w
    kd, kh, kw, _, co = w.shape
    if kw > 1 and kw * ci <= 32:
        pw, wl = (kw - 1) // 2, x.shape[3]
        xp = F.pad(x, (0, 0, pw, pw))
        x = torch.cat([xp[:, :, :, dx:dx + wl] for dx in range(kw)], dim=-1)
        w = w.reshape(kd, kh, 1, kw * ci, co)
        ci = kw * ci
    pad = -ci % 8
    return F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad))


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
    fixed 1/k^3 pool kernel does. x: (N,D,H,W,C). Eval only.
    """
    s = _box1d(_box1d(_box1d(x, k, 1), k, 2), k, 3)
    return s * (1.0 / k**3)
