"""Host-side patch sampling with background prefetch.

The port's copy of ``repmode_tpu.data.sampler`` (reference DataLoader
pipeline, fnet/functions.py:45-58, and the augmentation of
SSPdataset.data_aug:137-155): per epoch every volume is visited once in a
shuffled order, one random crop plus independent per-axis random flips
(p=0.5) per visit, batches of ``batch_size`` with the ragged tail kept.

A batch is assembled by the native C++ batcher (``native.crop_flip_batch``,
the default, as in JAX) or by numpy (``use_native=False``). Both take the
crops and flips of one RNG draw (``draw_crop_flip``, every sample of a batch
first), so the batches are bit-equal whichever path runs, and equal to the
JAX package's ``PatchSampler`` for the same seed, the padded tail under a
mesh included. Where the JAX sampler falls
back to numpy when the library cannot be built, this one raises.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np

from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.utils.timing import span


def draw_crop_flip(vol_shape, patch_size: Tuple[int, int, int], rng: np.random.Generator,
                   flip_prob: float = 0.5):
    """Draw (starts[3], flips[3]) for one crop."""
    starts = np.asarray(
        [rng.integers(0, s - p + 1) for s, p in zip(vol_shape, patch_size)], np.int64
    )
    flips = np.asarray([rng.uniform() <= flip_prob for _ in range(3)], np.uint8)
    return starts, flips


def apply_crop_flip(vol: np.ndarray, starts, flips, patch_size) -> np.ndarray:
    sl = tuple(slice(int(st), int(st) + p) for st, p in zip(starts, patch_size))
    out = vol[sl]
    axes = [ax for ax in range(3) if flips[ax]]
    if axes:
        out = np.flip(out, axis=axes)
    return np.ascontiguousarray(out)


class PatchSampler:
    """Iterates epochs of augmented patch batches from a VolumeStore."""

    def __init__(
        self,
        store: VolumeStore,
        batch_size: int,
        patch_size: Tuple[int, int, int],
        seed: int = 0,
        flip_prob: float = 0.5,
        shuffle: bool = True,
        prefetch: int = 2,
        use_native: bool = True,
    ):
        self.store = store
        self.batch_size = batch_size
        self.patch_size = tuple(patch_size)
        self.flip_prob = flip_prob
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self._native = None
        if use_native:
            from repmode_tpu_torch import native

            native.lib()  # build now: a failed build raises here, not in the prefetch thread
            self._native = native

    def batches_per_epoch(self) -> int:
        return -(-len(self.store) // self.batch_size)

    def _make_batch(self, idxs) -> Dict[str, np.ndarray]:
        records = [self.store[i] for i in idxs]
        tasks = np.asarray([r.task for r in records], np.int32)

        # one RNG draw protocol for both paths
        starts = np.empty((len(records), 3), np.int64)
        flips = np.empty((len(records), 3), np.uint8)
        for i, r in enumerate(records):
            starts[i], flips[i] = draw_crop_flip(r.signal.shape, self.patch_size, self.rng,
                                                 self.flip_prob)

        if self._native is not None:
            sig, tgt = self._native.crop_flip_batch(
                [(r.signal, r.target) for r in records], starts, flips, self.patch_size)
            return {"signal": sig[..., None], "target": tgt[..., None], "task": tasks}

        sigs = [apply_crop_flip(r.signal, starts[i], flips[i], self.patch_size)
                for i, r in enumerate(records)]
        tgts = [apply_crop_flip(r.target, starts[i], flips[i], self.patch_size)
                for i, r in enumerate(records)]
        return {
            "signal": np.stack(sigs)[..., None].astype(np.float32),
            "target": np.stack(tgts)[..., None].astype(np.float32),
            "task": tasks,
        }

    def epoch(self, pad_tail_to_batch: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """Yield one epoch of batches (each volume visited once).

        ``pad_tail_to_batch`` fills the ragged tail batch with volumes drawn
        at random from the epoch's order, as the JAX package does under a
        mesh: every batch then splits evenly over the ranks."""
        order = np.arange(len(self.store))
        if self.shuffle:
            self.rng.shuffle(order)
        b = self.batch_size
        chunks = [order[i:i + b] for i in range(0, len(order), b)]
        if pad_tail_to_batch and chunks and len(chunks[-1]) < b:
            tail = chunks[-1]
            chunks[-1] = np.concatenate([tail, self.rng.choice(order, size=b - len(tail))])
        if self.prefetch <= 0:
            for i, c in enumerate(chunks):
                with span("sampler.wait", i):
                    batch = self._make_batch(c)
                yield batch
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for c in chunks:
                    q.put(self._make_batch(c))
            finally:
                q.put(sentinel)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        for i in range(len(chunks)):  # the sentinel comes early only if the producer failed
            with span("sampler.wait", i):
                item = q.get()
            if item is sentinel:
                break
            yield item
        th.join()
