"""Tiled full-volume inference with Gaussian-blended stitching.

The port of ``repmode_tpu.infer.predict.TiledPredictor`` in its fused mode
(reference Model.predict, fnet_model.py:149-223): patches of the volume are
gathered in batches, run through the re-parameterized plain net, weighted by
a Gaussian importance map and added into fp32 ``pred_sum`` / ``weight_sum``
volumes, which are divided at the end. Everything stays on the device.

The start grid is the JAX package's: the patch list is padded to a multiple
of the batch with copies of the last start whose blend weight is zero, so
every batch has the same shape. The JAX scan over batches is a Python loop
here, and patches are added in the same order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repmode_tpu_torch.config import Config
from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.infer.tiling import compute_patch_starts
from repmode_tpu_torch.models.reparam import make_inference
from repmode_tpu_torch.ops.gaussian import gaussian_importance_map


class TiledPredictor:
    """Sliding-window predictor over re-parameterized per-task params.

        pred = TiledPredictor(cfg)
        prepare, _ = make_inference(cfg)
        y = pred(prepare(state_dict, task_id), volume)   # volume: (D,H,W)
    """

    def __init__(self, cfg: Config, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if cfg.eval.predictor != "fused":
            raise NotImplementedError(
                f"predictor {cfg.eval.predictor!r} is not ported yet; use 'fused'"
            )
        self.cfg = cfg
        self.patch_size = tuple(cfg.eval.patch_size)
        self.overlap = cfg.eval.overlap
        self.batch = cfg.train.batch_size_eval
        _, self._forward = make_inference(cfg)
        self._gauss = torch.from_numpy(
            gaussian_importance_map(self.patch_size, cfg.eval.gaussian_sigma_scale)
        ).to(self.device)

    def grid(self, vol_shape: Tuple[int, int, int]):
        """Padded start grid (NB, B, 3), validity mask (NB, B) and patch count."""
        starts = compute_patch_starts(vol_shape, self.patch_size, self.overlap)
        p = starts.shape[0]
        nb = -(-p // self.batch)
        pad = nb * self.batch - p
        if pad:
            starts = np.concatenate([starts, np.repeat(starts[-1:], pad, 0)], 0)
        valid = np.ones((nb * self.batch,), np.float32)
        valid[p:] = 0.0
        return starts.reshape(nb, self.batch, 3), valid.reshape(nb, self.batch), p

    def num_patches(self, vol_shape) -> int:
        return self.grid(tuple(int(s) for s in vol_shape))[2]

    @torch.no_grad()
    def __call__(self, plain_params, volume) -> torch.Tensor:
        """volume: (D,H,W) array or tensor -> stitched (D,H,W) fp32 on the device."""
        if not torch.is_tensor(volume):
            volume = torch.from_numpy(np.asarray(volume, np.float32))
        vol = volume.to(self.device, torch.float32)
        vol_shape = tuple(int(s) for s in vol.shape)
        starts, valid, _ = self.grid(vol_shape)
        pd, ph, pw = self.patch_size
        pred_sum = torch.zeros(vol_shape, dtype=torch.float32, device=self.device)
        weight_sum = torch.zeros_like(pred_sum)
        for st_b, valid_b in zip(starts.tolist(), valid.tolist()):
            patches = torch.stack(
                [vol[d:d + pd, h:h + ph, w:w + pw] for d, h, w in st_b]
            )
            preds = self._forward(plain_params, patches[..., None])[..., 0].float()
            for (d, h, w), v, pred in zip(st_b, valid_b, preds):
                wgt = self._gauss * v
                pred_sum[d:d + pd, h:h + ph, w:w + pw] += pred * wgt
                weight_sum[d:d + pd, h:h + ph, w:w + pw] += wgt
        return pred_sum / weight_sum
