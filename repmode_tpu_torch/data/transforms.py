"""Volume preprocessing transforms: the port's own copy of
``repmode_tpu.data.transforms``.

Clean-room equivalents of the reference's fnet/transforms.py utility set.
The ingest path uses `normalize` + `Resizer` (SSPdataset.py:22-25); the rest
(Padder/Cropper/Propper, ReflectionPadder3d, Capper, transforms.py:21-261)
are there for users who compose them for their own preprocessing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np


def normalize(img: np.ndarray) -> np.ndarray:
    """Float64 z-score: zero mean, unit std (transforms.py:9-14)."""
    result = img.astype(np.float64)
    result -= np.mean(result)
    result /= np.std(result)
    return result


class Resizer:
    """scipy zoom by per-axis factors, spline order 3, mode 'nearest'
    (transforms.py:190-200)."""

    def __init__(self, factors: Sequence[float]):
        self.factors = tuple(factors)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        import scipy.ndimage

        return scipy.ndimage.zoom(x, self.factors, mode="nearest")

    def __repr__(self):
        return f"Resizer({self.factors})"


class Padder:
    """Pad each dim up to a multiple of `by` ('+') or by explicit amounts;
    remembers the last pad for undo (transforms.py:46-98 semantics)."""

    def __init__(self, padding: Union[str, int, Sequence] = "+", by: int = 16,
                 mode: str = "constant"):
        self.padding = padding
        self.by = by
        self.mode = mode
        self.last_pad: Optional[dict] = None

    def _pad_width(self, shape) -> list:
        pads = (
            (self.padding,) * len(shape)
            if isinstance(self.padding, (str, int))
            else tuple(self.padding)
        )
        out = []
        for dim, p in zip(shape, pads):
            if isinstance(p, int):
                out.append((p, p))
            elif p == "+":
                total = int(np.ceil(dim / self.by) * self.by) - dim
                out.append((total // 2, total - total // 2))
            else:
                raise ValueError(f"bad padding spec {p!r}")
        return out

    def __call__(self, x: np.ndarray) -> np.ndarray:
        pw = self._pad_width(x.shape)
        out = np.pad(x, pw, mode=self.mode)
        self.last_pad = {"pad_width": pw, "shape_out": out.shape}
        return out

    def undo_last(self, x: np.ndarray) -> np.ndarray:
        assert self.last_pad and x.shape == self.last_pad["shape_out"]
        sl = tuple(
            slice(a, -b) if (a, b) != (0, 0) else slice(None)
            for a, b in self.last_pad["pad_width"]
        )
        return x[sl].copy()


class Cropper:
    """Crop each dim down to a multiple of `by` ('-') or by explicit amounts,
    centered ('mid') or at given offsets; undo re-pads with zeros
    (transforms.py:101-187 semantics, without the max-pixel shrink loop)."""

    def __init__(self, cropping: Union[str, int, Sequence] = "-", by: int = 16,
                 offset: Union[str, Sequence] = "mid"):
        self.cropping = cropping
        self.by = by
        self.offset = offset
        self.last_crop: Optional[dict] = None

    def _slices(self, shape) -> list:
        crops = (
            (self.cropping,) * len(shape)
            if isinstance(self.cropping, (str, int))
            else tuple(self.cropping)
        )
        offsets = (
            (self.offset,) * len(shape)
            if isinstance(self.offset, str)
            else tuple(self.offset)
        )
        slices = []
        for dim, c, o in zip(shape, crops, offsets):
            if c is None:
                size = dim
            elif isinstance(c, int):
                size = dim - c
            elif c == "-":
                size = dim // self.by * self.by
            else:
                raise ValueError(f"bad cropping spec {c!r}")
            start = (dim - size) // 2 if o == "mid" else int(o)
            if start + size > dim:
                raise ValueError("crop outside image")
            slices.append(slice(start, start + size))
        return slices

    def __call__(self, x: np.ndarray) -> np.ndarray:
        sl = self._slices(x.shape)
        out = x[tuple(sl)].copy()
        self.last_crop = {"shape_in": x.shape, "slices": sl}
        return out

    def undo_last(self, x: np.ndarray) -> np.ndarray:
        assert self.last_crop is not None
        out = np.zeros(self.last_crop["shape_in"], dtype=x.dtype)
        out[tuple(self.last_crop["slices"])] = x
        return out


class Propper:
    """Padder ('+') or Cropper ('-') behind one switch (transforms.py:21-43)."""

    def __init__(self, action: str = "-", **kwargs):
        assert action in ("+", "-")
        self.action = action
        self.transformer = Padder("+", **kwargs) if action == "+" else Cropper("-", **kwargs)

    def __call__(self, x):
        return self.transformer(x)

    def undo_last(self, x):
        return self.transformer.undo_last(x)


class Capper:
    """Clamp values to [low, hi] (transforms.py:223-237)."""

    def __init__(self, low: Optional[float] = None, hi: Optional[float] = None):
        self.low, self.hi = low, hi

    def __call__(self, x: np.ndarray) -> np.ndarray:
        out = x.copy()
        if self.hi is not None:
            out[out > self.hi] = self.hi
        if self.low is not None:
            out[out < self.low] = self.low
        return out


class ReflectionPadder3d:
    """Mirror-pad a 3D array by per-axis amounts (transforms.py:203-220)."""

    def __init__(self, padding: Union[int, Tuple[int, int, int]]):
        self.padding = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
        if any(p < 0 for p in self.padding):
            raise ValueError("negative padding")

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.pad(x, [(p, p) for p in self.padding], mode="reflect")
