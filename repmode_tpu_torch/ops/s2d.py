"""Space-to-depth (s2d) execution of the 'same' convs, NDHWC, phase-major.

The port's copy of ``repmode_tpu.ops.s2d``. s2d packs each 2x2 H,W
neighbourhood into channels:

    x2[n,d,h',w',(py,px,c)] = x[n,d,2h'+py,2w'+px,c]

A K-tap 'same' conv along H (K in {3,5}) becomes a 3-tap 'same' conv along
h' with phase-block weights

    W2[t, (p,i), (q,o)] = W[2(t-1) + ctr + p - q, i, o]   where in range, else 0

(``ctr = (K-1)//2``), and the same along W; depth is left untransformed. The
transform is exact: the s2d conv computes the same contractions, with
structured zeros, over a quarter of the positions. On an H100 it does
5*3*3*(4Ci)*(4Co)/4 = 180*Ci*Co products per native position against
125*Ci*Co for the native 5^3 conv (1.44x).

The kernel and bias transforms run once per task at re-parameterization
time. The k=2, s=2 resamples between levels are reshapes around one matrix
product, as in the JAX package, outside any kernel; with a compute dtype
they compute in it and convert before the interleave transpose, so the
relayout moves the compute dtype and not fp32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repmode_tpu_torch.ops.conv3d import _acc_or_compute


def space_to_depth_hw(x: torch.Tensor) -> torch.Tensor:
    """(N,D,H,W,C) -> (N,D,H/2,W/2,4C), phase-major: c' = (py*2+px)*C + c."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(n, d, h // 2, w // 2, 4 * c)


def depth_to_space_hw(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``space_to_depth_hw``."""
    n, d, hh, ww, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, d, hh, ww, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(n, d, hh * 2, ww * 2, c)


def _phase_gather(k: int) -> np.ndarray:
    """G[t,p,q,dy] = 1 iff dy == 2*(t-1) + (k-1)//2 + p - q, dy in [0,k)."""
    ctr = (k - 1) // 2
    g = np.zeros((3, 2, 2, k), np.float32)
    for t in range(3):
        for p in range(2):
            for q in range(2):
                dy = 2 * (t - 1) + ctr + p - q
                if 0 <= dy < k:
                    g[t, p, q, dy] = 1.0
    return g


@functools.lru_cache(maxsize=None)
def _phase_gather_on(k: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_phase_gather(k)`` as a tensor, made once per dtype and device: the
    training step transforms its kernels every step, and a host-to-device
    copy there would stall the host until the card's queue drains."""
    return torch.from_numpy(_phase_gather(k)).to(device=device, dtype=dtype)


def s2d_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(kD,K,K,Ci,Co) 'same' kernel -> s2d form (kD,3,3,4Ci,4Co), K in {3,5}."""
    kd, kh, kw, ci, co = w.shape
    gh = _phase_gather_on(kh, w.dtype, w.device)
    gw = _phase_gather_on(kw, w.dtype, w.device)
    # output memory order z,t,s,(p,x,ci),(q,y,co): phase-major blocks
    w2 = torch.einsum("tpqd,sxye,zdeio->ztspxiqyo", gh, gw, w)
    return w2.reshape(kd, 3, 3, 4 * ci, 4 * co)


def s2d_down_kernel(w: torch.Tensor) -> torch.Tensor:
    """k2s2 downsample kernel (2,2,2,Ci,Co) -> s2d-domain (2,1,1,4Ci,Co).

    The 2x2 H,W window of the native op is one s2d position's phase block,
    so the downsample is a (2,1,1) conv with stride (2,1,1) in the s2d
    domain; (b,c,i) flattened row-major is the phase-major channel order.
    """
    ci, co = w.shape[3], w.shape[4]
    return w.reshape(2, 4 * ci, co)[:, None, None]


def s2d_bias(b: torch.Tensor) -> torch.Tensor:
    """(Co,) -> (4Co,), one copy per output phase."""
    return torch.cat([b, b, b, b])


def s2d_conv1_kernel(w: torch.Tensor) -> torch.Tensor:
    """1^3 conv kernel (1,1,1,Ci,Co) -> s2d block diagonal (1,1,1,4Ci,4Co)."""
    ci, co = w.shape[3], w.shape[4]
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    w2 = torch.einsum("pq,io->piqo", eye, w.reshape(ci, co)).reshape(4 * ci, 4 * co)
    return w2[None, None, None]


def _shift(t: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """t shifted by d pair positions along ``dim`` with zero fill:
    out[m] = t[m - d]."""
    if d == 0:
        return t
    n = t.shape[dim]
    z = torch.zeros_like(t.narrow(dim, 0, abs(d)))
    if d > 0:
        return torch.cat([z, t.narrow(dim, 0, n - d)], dim)
    return torch.cat([t.narrow(dim, -d, n + d), z], dim)


def _box1d_pair(x0: torch.Tensor, x1: torch.Tensor, k: int, dim: int):
    """k-tap box sum along a native axis split into its even (x0) and odd
    (x1) positions: y_q[m] = sum_{d=-r..r} nat[2m+q+d], zero padded."""
    a = x0 + x1  # nat[2m] + nat[2m+1]
    if k == 5:
        return _shift(a, 1, dim) + a + _shift(x0, -1, dim), _shift(x1, 1, dim) + a + _shift(a, -1, dim)
    if k == 3:
        return _shift(x1, 1, dim) + x0 + x1, x0 + x1 + _shift(x0, -1, dim)
    raise ValueError(f"box pair supports k in {{3,5}}, got {k}")


def box_pool_s2d(x2: torch.Tensor, k: int) -> torch.Tensor:
    """k^3 box SUM (times 1/k^3 for the avg pool) of an s2d-domain tensor,
    'same' zero padding. x2: (N,D,h',w',4C) phase-major -> same shape."""
    d, c = x2.shape[1], x2.shape[-1] // 4
    r = (k - 1) // 2
    xp = F.pad(x2, (0, 0, 0, 0, 0, 0, r, r))
    y = xp[:, 0:d]
    for i in range(1, k):
        y = y + xp[:, i:i + d]
    # H: native phase py is the channel block [0:2C] or [2C:4C]
    y = torch.cat(_box1d_pair(y[..., :2 * c], y[..., 2 * c:], k, 2), dim=-1)
    # W: native phase px is [0:C] or [C:2C] inside each py block
    parts = []
    for py in range(2):
        b = y[..., py * 2 * c:(py + 1) * 2 * c]
        parts.extend(_box1d_pair(b[..., :c], b[..., c:], k, 3))
    return torch.cat(parts, dim=-1)


def downsample_s2d_domain(
    x2: torch.Tensor, w2: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None,
    trim_d_halo: int = 0,
) -> torch.Tensor:
    """s2d-domain downsample: (N,D,h',w',4C) -> native next level (N,D/2,h',w',Co).

    One matmul contracting (depth phase, channel) over a free reshape:
    out[n,d,h,w,o] = sum_{a,c} x2[n,2d+a,h,w,c] W[a,c,o]. ``trim_d_halo``
    drops that many zero halo rows at each depth edge first (a view).
    """
    if trim_d_halo:
        x2 = x2[:, trim_d_halo:-trim_d_halo]
    x2 = _acc_or_compute(x2, compute_dtype)
    n, d, hh, ww, c4 = x2.shape
    wm = w2.to(x2.dtype).reshape(2, c4, w2.shape[-1])
    return torch.einsum("ndahwc,aco->ndhwo", x2.reshape(n, d // 2, 2, hh, ww, c4), wm)


def downsample_s2d_to_s2d(
    x2: torch.Tensor, w2: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None,
    trim_d_halo: int = 0,
) -> torch.Tensor:
    """s2d-domain downsample emitting the next level's s2d domain directly.

    x2: (N,D,h',w',4C) phase-major -> (N,D/2,h'/2,w'/2,4Co) phase-major. The
    downsample is pointwise over (h',w'), so regrouping its output phases is
    a re-view of its input. Bias: ``s2d_bias(down_b)``.
    """
    if trim_d_halo:
        x2 = x2[:, trim_d_halo:-trim_d_halo]
    x2 = _acc_or_compute(x2, compute_dtype)
    n, d, hh, ww, c4 = x2.shape
    co = w2.shape[-1]
    wm = w2.to(x2.dtype).reshape(2, c4, co)
    xv = x2.reshape(n, d // 2, 2, hh // 2, 2, ww // 2, 2, c4)
    y = torch.einsum("ndahpwxc,aco->ndhwpxo", xv, wm)
    return y.reshape(n, d // 2, hh // 2, ww // 2, 4 * co)


def upsample_to_s2d(
    x: torch.Tensor, w: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """k2s2 transposed conv producing an s2d-domain output directly.

    out[n,2d+a,2h'+b,2w'+c,o] = sum_i x[n,d,h',w',i] W[a,b,c,i,o]: the (b,c)
    phases are the s2d phase block, so this is one matmul into (2, 4Co)
    channels and a depth interleave. x: (N,D,h',w',Ci), w: (2,2,2,Ci,Co)
    -> (N,2D,h',w',4Co).
    """
    x = _acc_or_compute(x, compute_dtype)
    w = w.to(x.dtype)
    n, d, hh, ww, ci = x.shape
    co = w.shape[-1]
    wm = w.permute(3, 0, 1, 2, 4).reshape(ci, 2 * 4 * co)  # (i, (a, b, c, o))
    y = torch.matmul(x, wm).reshape(n, d, hh, ww, 2, 4 * co)
    return y.permute(0, 1, 4, 2, 3, 5).reshape(n, 2 * d, hh, ww, 4 * co)


def upsample_s2d_to_s2d(
    x2: torch.Tensor, w: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """k2s2 transposed conv with s2d-domain input and output.

    x2: (N,D,h',w',4Ci) phase-major, w: (2,2,2,Ci,Co) native ->
    (N,2D,2h',2w',4Co) phase-major: the same matmul for every input phase,
    then d/h'/w' interleaves.
    """
    x2 = _acc_or_compute(x2, compute_dtype)
    w = w.to(x2.dtype)
    n, d, hh, ww, c4 = x2.shape
    ci = c4 // 4
    co = w.shape[-1]
    wm = w.permute(3, 0, 1, 2, 4).reshape(ci, 2 * 4 * co)  # (i, (a, k))
    y = torch.matmul(x2.reshape(n, d, hh, ww, 2, 2, ci), wm).reshape(n, d, hh, ww, 2, 2, 2, 4 * co)
    # (n,d,h',w',p,x,a,k) -> (n, d,a, h',p, w',x, k)
    y = y.permute(0, 1, 6, 2, 4, 3, 5, 7)
    return y.reshape(n, 2 * d, 2 * hh, 2 * ww, 4 * co)
