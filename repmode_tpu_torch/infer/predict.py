"""Tiled full-volume inference with Gaussian-blended stitching.

The port of ``repmode_tpu.infer.predict.TiledPredictor`` (reference
Model.predict, fnet_model.py:149-223): patches of the volume are gathered in
batches, run through the re-parameterized plain net, weighted by a Gaussian
importance map and added into fp32 ``pred_sum`` / ``weight_sum`` volumes,
which are divided at the end. Everything stays on the device. Two modes, as
in the JAX package:

  fused      one loop over patch batches, each batch stitched right after
             its forward;
  two_phase  the first pass predicts every batch into one (NB, B, pd, ph, pw)
             tensor, the second stitches them, batch by batch in the same
             order as fused, so the two modes give the same volume.

The start grid is the JAX package's: the patch list is padded to a multiple
of the batch with copies of the last start whose blend weight is zero, so
every batch has the same shape. The JAX scans over batches are Python loops
here, and patches are added in the same order. Sharding the patch grid over
a device mesh (the JAX two_phase ``mesh``) is not ported (A10).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repmode_tpu_torch.config import Config
from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.infer.tiling import compute_patch_starts
from repmode_tpu_torch.models.reparam import make_inference
from repmode_tpu_torch.ops.gaussian import gaussian_importance_map

MODES = ("fused", "two_phase")


class TiledPredictor:
    """Sliding-window predictor over re-parameterized per-task params.

        pred = TiledPredictor(cfg)
        prepare, _ = make_inference(cfg)
        y = pred(prepare(state_dict, task_id), volume)   # volume: (D,H,W)

    ``forward_fn`` replaces the forward of ``make_inference(cfg)`` (which
    honours ``cfg.eval.s2d`` and ``cfg.eval.pallas_conv``); ``mode``
    replaces ``cfg.eval.predictor``.
    """

    def __init__(
        self,
        cfg: Config,
        device: DeviceLike = "cuda",
        forward_fn: Optional[Callable] = None,
        mode: Optional[str] = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mode = mode or cfg.eval.predictor
        if self.mode not in MODES:
            raise ValueError(f"predictor mode {self.mode!r} must be one of {MODES}")
        if mesh is not None:
            raise NotImplementedError("a device mesh for the two_phase predictor is not "
                                      "ported yet (A10)")
        self.cfg = cfg
        self.patch_size = tuple(cfg.eval.patch_size)
        self.overlap = cfg.eval.overlap
        self.batch = cfg.train.batch_size_eval
        self._forward = forward_fn if forward_fn is not None else make_inference(cfg)[1]
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

    def _predict(self, plain_params, vol, st_b) -> torch.Tensor:
        """One batch of patches -> (B, pd, ph, pw) fp32 predictions."""
        pd, ph, pw = self.patch_size
        patches = torch.stack([vol[d:d + pd, h:h + ph, w:w + pw] for d, h, w in st_b])
        return self._forward(plain_params, patches[..., None])[..., 0].float()

    def _accumulate(self, pred_sum, weight_sum, preds, st_b, valid_b) -> None:
        """Add one batch's weighted predictions into the sums, in order."""
        pd, ph, pw = self.patch_size
        for (d, h, w), v, pred in zip(st_b, valid_b, preds):
            wgt = self._gauss * v
            pred_sum[d:d + pd, h:h + ph, w:w + pw] += pred * wgt
            weight_sum[d:d + pd, h:h + ph, w:w + pw] += wgt

    @torch.no_grad()
    def __call__(self, plain_params, volume) -> torch.Tensor:
        """volume: (D,H,W) array or tensor -> stitched (D,H,W) fp32 on the device."""
        if not torch.is_tensor(volume):
            volume = torch.from_numpy(np.asarray(volume, np.float32))
        vol = volume.to(self.device, torch.float32)
        vol_shape = tuple(int(s) for s in vol.shape)
        starts, valid, _ = self.grid(vol_shape)
        starts, valid = starts.tolist(), valid.tolist()
        pred_sum = torch.zeros(vol_shape, dtype=torch.float32, device=self.device)
        weight_sum = torch.zeros_like(pred_sum)
        if self.mode == "fused":
            for st_b, valid_b in zip(starts, valid):
                preds = self._predict(plain_params, vol, st_b)
                self._accumulate(pred_sum, weight_sum, preds, st_b, valid_b)
        else:
            preds = torch.stack([self._predict(plain_params, vol, st_b) for st_b in starts])
            for preds_b, st_b, valid_b in zip(preds, starts, valid):
                self._accumulate(pred_sum, weight_sum, preds_b, st_b, valid_b)
        return pred_sum / weight_sum
