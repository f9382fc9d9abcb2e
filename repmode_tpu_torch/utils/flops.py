"""Analytic FLOP model of the RepMode network (inference / reparam form).

The port's copy of ``repmode_tpu.utils.flops``, over the port's
``ModelConfig``. It grounds a benchmark's throughput claims: voxels/s alone
says nothing about hardware efficiency, so a benchmark reports model
TFLOP/s and MFU derived from this count.

Counts the re-parameterized (eval) network — each MoDE conv merged into ONE
k^3 dense conv per task (reference routing() + eval path,
fnet/nn_modules/RepMode.py:171-192,210) — which is exactly what both the
reference's `Model.predict` (fnet/fnet_model.py:149-223) and the port's
TiledPredictor execute per patch. Convention: 1 multiply-add = 2 FLOPs.
Gate/merge costs are once-per-task, not per-patch, and are excluded.

These are NATIVE model FLOPs: the s2d serving routes (ops/s2d.py) compute
structured zeros as real MACs (1.44x for k=5), so an MFU reported against
native FLOPs on those routes is conservative (the ratio of useful work to
peak).
"""

from __future__ import annotations

from repmode_tpu_torch.config import ModelConfig


def conv_flops(voxels: int, ci: int, co: int, taps: int) -> int:
    return 2 * voxels * ci * co * taps


def inference_flops_per_patch(cfg: ModelConfig, patch_size) -> int:
    """FLOPs of one re-parameterized forward on one patch (batch 1)."""
    d, h, w = patch_size
    k3 = cfg.kernel_size ** 3
    c = cfg.in_channels * cfg.mult_chan
    chans = [c * (2 ** i) for i in range(cfg.depth + 1)]  # [32,64,...,512]
    vox = [d * h * w // (8 ** i) for i in range(cfg.depth + 1)]

    total = 0
    # encoder blocks (conv_more: two k^3 convs; conv_down: 2^3 stride-2)
    in_ch = cfg.in_channels
    for i in range(cfg.depth):
        total += conv_flops(vox[i], in_ch, chans[i], k3)       # conv1
        total += conv_flops(vox[i], chans[i], chans[i], k3)    # conv2
        total += conv_flops(vox[i + 1], chans[i], chans[i], 8)  # downsample
        in_ch = chans[i]
    # bottleneck
    total += conv_flops(vox[cfg.depth], chans[cfg.depth - 1], chans[cfg.depth], k3)
    total += conv_flops(vox[cfg.depth], chans[cfg.depth], chans[cfg.depth], k3)
    # decoder blocks (convT up: each output voxel gets exactly one 2^3 tap;
    # conv1 consumes the skip-concat 2*c_i channels)
    for i in range(cfg.depth - 1, -1, -1):
        total += conv_flops(vox[i], chans[i + 1], chans[i], 1)  # upsample
        total += conv_flops(vox[i], 2 * chans[i], chans[i], k3)  # conv1
        total += conv_flops(vox[i], chans[i], chans[i], k3)      # conv2
    # final conv (k^3, no BN)
    total += conv_flops(vox[0], c, cfg.out_channels, k3)
    return total


def tiling_patch_count(vol_shape, patch_size, overlap: float = 0.5):
    """Patch count of the reference sliding-window grid (fnet_model.py:156-164):
    stride = patch*(1-overlap), steps = ceil((vol-patch)/stride)+1 per axis."""
    n = 1
    for v, p in zip(vol_shape, patch_size):
        stride = int(p * (1 - overlap))
        steps = 1 if v <= p else -((v - p) // -stride) + 1
        n *= steps
    return n


def tiled_inference_flops(cfg: ModelConfig, vol_shape, patch_size,
                          overlap: float = 0.5) -> dict:
    """Total model FLOPs to predict one full volume with overlap tiling."""
    per_patch = inference_flops_per_patch(cfg, patch_size)
    n_patches = tiling_patch_count(vol_shape, patch_size, overlap)
    vol_vox = 1
    for v in vol_shape:
        vol_vox *= v
    patch_vox = 1
    for p in patch_size:
        patch_vox *= p
    return {
        "flops_per_patch": per_patch,
        "n_patches": n_patches,
        "total_flops": per_patch * n_patches,
        "redundancy": n_patches * patch_vox / vol_vox,
        "flops_per_voxel_unique": per_patch / patch_vox,
        "flops_per_voxel_effective": per_patch * n_patches / vol_vox,
    }
