"""The work a cell needs, counted from its configuration's shapes.

The convs are the net's as its reference model file lists them
(``reference/models/<model>.py``: ``convs``), each 2 FLOPs a multiply-add.
A count depends on the configuration and the mix alone, never on the kernels
that do the work.

``same_convs`` lists the k^3 'same' convs of one patch; ``conv_bound_s``
is the least time the chip could take for them: per conv, the larger of
its FLOPs over the peak and its bytes over the bandwidth (``chip_smoke.py``'s
``bound_ms``), each input, weight and output byte counted once, in the dtype
the configuration states for the path (``conv_dtypes``).

Published peaks (NVIDIA's data sheets, dense, no sparsity; the SXM part's
at its full 700 W): ``PEAKS``.
"""

from __future__ import annotations

from math import ceil
from typing import List, Optional, Tuple

from benchmark.reference import nets
from benchmark.reference.nets import Conv

# (substring of torch.cuda.get_device_name, bf16 FLOP/s, HBM bytes/s)
PEAKS = (
    ("H100 80GB HBM3", 989e12, 3.35e12),  # H100 SXM
    ("H100 PCIe", 756e12, 2.0e12),
)

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float8": 1}


def peaks(kind: str) -> Optional[Tuple[float, float]]:
    return next(((f, b) for name, f, b in PEAKS if name in kind), None)


def conv_flops(voxels: int, ci: int, co: int, taps: int) -> int:
    return 2 * voxels * ci * co * taps


def inference_flops_per_patch(cfg: dict, patch) -> int:
    """FLOPs of one forward of the net on one patch (batch 1)."""
    return sum(conv_flops(c.voxels, c.ci, c.co, c.taps) for c in nets.model(cfg).convs(cfg, patch))


def tiling_patch_count(vol_shape, patch_size, overlap: float = 0.5) -> int:
    n = 1
    for v, p in zip(vol_shape, patch_size):
        stride = int(ceil(p * (1 - overlap)))
        n *= 1 if v <= p else -((v - p) // -stride) + 1
    return n


def tiled_inference_flops(cfg: dict, vol_shape, patch_size, overlap: float = 0.5) -> int:
    """FLOPs to predict one whole volume with overlapping patches."""
    return inference_flops_per_patch(cfg, patch_size) * tiling_patch_count(
        vol_shape, patch_size, overlap)


def train_step_flops(cfg: dict, batch: int, patch) -> int:
    """3 x the forward of the batch (forward, dX, dW)."""
    return 3 * batch * inference_flops_per_patch(cfg, patch)


def same_convs(cfg: dict, patch) -> List[Conv]:
    """The k^3 'same' convs of one patch, in the order the net runs them."""
    return [c for c in nets.model(cfg).convs(cfg, patch) if c.same]


def _bound(flops: float, nbytes: float, peak: Tuple[float, float]) -> float:
    return max(flops / peak[0], nbytes / peak[1])


def serve_conv_bound_s(cfg: dict, mix: dict, peak: Tuple[float, float]) -> float:
    """Least seconds of the 'same' convs of one whole volume: every patch the
    grid needs, in calls of ``batch_size_eval`` patches (a call reads its
    weights once)."""
    dt = cfg["conv_dtypes"]
    b_in, b_w = DTYPE_BYTES[dt["input"]], DTYPE_BYTES[dt["weight"]]
    patches = tiling_patch_count(mix["volume_shape"], mix["patch_size"], mix["overlap"])
    calls = -(-patches // mix["batch_size_eval"])
    total = 0.0
    for c in same_convs(cfg, mix["patch_size"]):
        b_out = DTYPE_BYTES[dt["final_output" if c.final else "output"]]
        flops = conv_flops(c.voxels, c.ci, c.co, c.taps) * patches
        nbytes = (patches * c.voxels * (c.ci * b_in + c.co * b_out)
                  + calls * (c.taps * c.ci * c.co * b_w + (0 if c.final else 4 * c.co)))
        total += _bound(flops, nbytes, peak)
    return total


def train_conv_bound_s(cfg: dict, mix: dict, peak: Tuple[float, float]) -> float:
    """Least seconds of one step's 'same' convs: forward, dX (none for the
    first conv, whose input needs no gradient) and dW, each its own pass.
    With ``per_sample_weights`` every sample has its own kernel (the MoDE
    gate merge), read by the forward and dX and written by dW."""
    dt = cfg["conv_dtypes"]
    b_in, b_w = DTYPE_BYTES[dt["input"]], DTYPE_BYTES[dt["weight"]]
    b_dw = DTYPE_BYTES[dt["weight_grad"]]
    n = mix["batch_size"]
    kernels = n if dt.get("per_sample_weights") else 1
    total = 0.0
    for i, c in enumerate(same_convs(cfg, mix["patch_size"])):
        b_out = DTYPE_BYTES[dt["final_output" if c.final else "output"]]
        flops = conv_flops(c.voxels, c.ci, c.co, c.taps) * n
        x, y = n * c.voxels * c.ci, n * c.voxels * c.co
        w = kernels * c.taps * c.ci * c.co
        total += _bound(flops, x * b_in + w * b_w + y * b_out, peak)          # forward
        if i > 0:
            total += _bound(flops, y * b_in + w * b_w + x * b_in, peak)       # dX
        total += _bound(flops, x * b_in + y * b_in + w * b_dw, peak)          # dW
    return total
