"""Patch sampling on the device from a volume bank held in device memory.

The port of ``repmode_tpu/data/device_sampler.py``. The host ``PatchSampler``
(``data/sampler.py``) follows the reference DataLoader; here a split's
volumes live on the device as one stacked (V, D, H, W) bank per array, and
``sample(epoch, step)`` draws a task-tagged, augmented batch there: no host
work, no host-to-device copy and no host sync per step.

The sampling law is the JAX package's, which is the reference's
(SSPdataset.py:137-155 and the shuffled DataLoader, functions.py:47): each
epoch visits every volume once in a fresh random permutation, one random
crop inside the volume's true extents and independent per-axis flips (each
with ``flip_prob``) per visit; the ragged tail batch is filled with extra
random volumes. Volumes of different shapes are zero-padded to the largest
shape and each crop is bounded by its volume's extents, so padding is never
read.

A batch is a function of ``(seed, epoch, step)``, as JAX's ``fold_in`` makes
it: the permutation comes from a generator seeded from (seed, epoch), the
crops and flips from one seeded from (seed, epoch, step), so resuming at any
(epoch, step) gives the same batch. The streams are torch's, not
``jax.random``'s: the law is the same, the bits are not. Sharding the batch
over a device mesh (JAX's ``mesh``) is not ported (A10).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.device import DeviceLike, resolve_device

_MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """A 63-bit seed from integers: splitmix64 folded over the words (the
    role ``jax.random.fold_in`` plays in JAX)."""
    z = 0x9E3779B97F4A7C15
    for w in words:
        z = (z ^ (int(w) & _MASK64)) & _MASK64
        z = (z + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


class DeviceVolumeBank:
    """A split's volumes on the device, stacked and padded to the largest
    shape, with each volume's task and true extents."""

    def __init__(self, signals: torch.Tensor, targets: torch.Tensor, tasks: torch.Tensor,
                 extents: torch.Tensor):
        self.signals = signals  # (V, Dm, Hm, Wm) fp32, padded
        self.targets = targets  # (V, Dm, Hm, Wm) fp32, padded
        self.tasks = tasks      # (V,) int32
        self.extents = extents  # (V, 3) int64: true (D, H, W) of each volume

    @property
    def num_volumes(self) -> int:
        return self.signals.shape[0]

    @property
    def vol_shape(self) -> Tuple[int, int, int]:
        return tuple(self.signals.shape[1:])

    @staticmethod
    def padded_nbytes(store: VolumeStore) -> int:
        """Device bytes of a bank built from this store (signal and target fp32)."""
        shapes = [r.signal.shape for r in store.records]
        if not shapes:
            return 0
        mx = tuple(max(s[i] for s in shapes) for i in range(3))
        return 2 * len(shapes) * int(np.prod(mx)) * 4

    @classmethod
    def from_store(cls, store: VolumeStore, device: DeviceLike = "cuda") -> "DeviceVolumeBank":
        """Copy the store's volumes into a zero-padded bank on ``device``, one
        volume at a time."""
        dev = resolve_device(device)
        if not store.records:
            raise ValueError("an empty store has no device bank")
        shapes = [r.signal.shape for r in store.records]
        mx = tuple(max(s[i] for s in shapes) for i in range(3))
        v = len(shapes)
        sig = torch.zeros((v, *mx), dtype=torch.float32, device=dev)
        tgt = torch.zeros((v, *mx), dtype=torch.float32, device=dev)
        for i, r in enumerate(store.records):
            if r.target is None:
                raise ValueError(f"volume {i} ({r.info.get('path_czi', r.dataset)}) has no "
                                 "target: a training bank needs labeled volumes")
            d, h, w = r.signal.shape
            sig[i, :d, :h, :w].copy_(torch.from_numpy(np.asarray(r.signal, np.float32)))
            tgt[i, :d, :h, :w].copy_(torch.from_numpy(np.asarray(r.target, np.float32)))
        tasks = torch.tensor([r.task for r in store.records], dtype=torch.int32, device=dev)
        extents = torch.tensor(shapes, dtype=torch.int64, device=dev)
        return cls(sig, tgt, tasks, extents)


def make_device_sampler(
    bank: DeviceVolumeBank,
    batch_size: int,
    patch_size: Tuple[int, int, int],
    flip_prob: float = 0.5,
    seed: int = 0,
    mesh=None,
) -> Tuple[Callable[[int, int], Dict[str, torch.Tensor]], int]:
    """Returns (sample, steps_per_epoch); sample(epoch, step) ->
    {'signal', 'target'}: (B, pd, ph, pw, 1) fp32 and 'task': (B,) int32, on
    the bank's device. A volume smaller than the patch raises here."""
    if mesh is not None:
        raise NotImplementedError("a device mesh for the sampler is not ported yet (A10)")
    pd, ph, pw = (int(p) for p in patch_size)
    nvol = bank.num_volumes
    dev = bank.signals.device
    ext_min = bank.extents.min(dim=0).values.tolist()  # once, at construction
    if any(e < p for e, p in zip(ext_min, (pd, ph, pw))):
        raise ValueError(
            f"volumes smaller than the patch {tuple(patch_size)}: min extents "
            f"{tuple(ext_min)} (reference data_aug requires volume >= patch, "
            "SSPdataset.py:139-148)"
        )
    steps_per_epoch = -(-nvol // batch_size)
    padded_len = steps_per_epoch * batch_size
    patch = torch.tensor([pd, ph, pw], dtype=torch.int64, device=dev)
    ranges = [torch.arange(p, dtype=torch.int64, device=dev) for p in (pd, ph, pw)]

    def generator(*words) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(_mix(seed, *words))

    def epoch_order(epoch: int) -> torch.Tensor:
        g = generator(epoch)
        order = torch.randperm(nvol, generator=g, device=dev)
        if padded_len > nvol:  # the ragged tail: extra random volumes
            pad = torch.randint(0, nvol, (padded_len - nvol,), generator=g, device=dev)
            order = torch.cat([order, order[pad]])
        return order

    def sample(epoch: int, step: int) -> Dict[str, torch.Tensor]:
        vidx = epoch_order(epoch)[step * batch_size:(step + 1) * batch_size]
        g = generator(epoch, step + 1)
        b = vidx.shape[0]
        # a start uniform in [0, extent - patch] per axis, then the flips
        limits = bank.extents[vidx] - patch + 1
        starts = (torch.rand((b, 3), generator=g, device=dev) * limits).long()
        starts = torch.minimum(starts, limits - 1)
        flips = torch.rand((b, 3), generator=g, device=dev) <= flip_prob
        # per axis, the index start + i, or start + p - 1 - i when flipped
        idx = [starts[:, a:a + 1] + torch.where(flips[:, a:a + 1], r.flip(0), r)
               for a, r in enumerate(ranges)]
        at = (vidx[:, None, None, None], idx[0][:, :, None, None], idx[1][:, None, :, None],
              idx[2][:, None, None, :])
        return {"signal": bank.signals[at][..., None], "target": bank.targets[at][..., None],
                "task": bank.tasks[vidx]}

    return sample, steps_per_epoch
