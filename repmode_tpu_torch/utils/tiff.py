"""Minimal TIFF I/O for 3D float32 volumes (multi-page grayscale): the port's
own copy of ``repmode_tpu.utils.tiff``.

The reference saves test predictions/signals/targets with tifffile
(main.py:288-297). This module is a small writer/reader pair for the subset
needed: little-endian TIFF, one page per z-slice, 32-bit IEEE float samples,
one strip per page. Its files are byte-equal to the JAX package's.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_SAMPLE_FORMAT = 339

_TYPE_SHORT = 3
_TYPE_LONG = 4

_SAMPLE_FORMAT_IEEEFP = 3


def imwrite(path: str, volume: np.ndarray) -> None:
    """Write (D,H,W) or (H,W) float32 as a multi-page grayscale TIFF."""
    vol = np.asarray(volume, np.float32)
    if vol.ndim == 2:
        vol = vol[None]
    assert vol.ndim == 3, vol.shape
    d, h, w = vol.shape
    page_bytes = h * w * 4

    with open(path, "wb") as f:
        f.write(b"II*\x00")  # little-endian magic + version 42
        first_ifd_ptr_pos = f.tell()
        f.write(struct.pack("<I", 0))  # patched later

        ifd_ptr_pos = first_ifd_ptr_pos
        for z in range(d):
            data_offset = f.tell()
            f.write(vol[z].tobytes())
            ifd_offset = f.tell()
            # patch previous IFD/next pointer to this IFD
            f.seek(ifd_ptr_pos)
            f.write(struct.pack("<I", ifd_offset))
            f.seek(ifd_offset)

            entries = [
                (_IMAGE_WIDTH, _TYPE_LONG, 1, w),
                (_IMAGE_LENGTH, _TYPE_LONG, 1, h),
                (_BITS_PER_SAMPLE, _TYPE_SHORT, 1, 32),
                (_COMPRESSION, _TYPE_SHORT, 1, 1),      # none
                (_PHOTOMETRIC, _TYPE_SHORT, 1, 1),      # BlackIsZero
                (_STRIP_OFFSETS, _TYPE_LONG, 1, data_offset),
                (_SAMPLES_PER_PIXEL, _TYPE_SHORT, 1, 1),
                (_ROWS_PER_STRIP, _TYPE_LONG, 1, h),
                (_STRIP_BYTE_COUNTS, _TYPE_LONG, 1, page_bytes),
                (_SAMPLE_FORMAT, _TYPE_SHORT, 1, _SAMPLE_FORMAT_IEEEFP),
            ]
            f.write(struct.pack("<H", len(entries)))
            for tag, typ, count, value in entries:
                f.write(struct.pack("<HHI", tag, typ, count))
                if typ == _TYPE_SHORT:
                    f.write(struct.pack("<HH", value, 0))
                else:
                    f.write(struct.pack("<I", value))
            ifd_ptr_pos = f.tell()
            f.write(struct.pack("<I", 0))  # next-IFD (patched by next page)


def imread(path: str) -> np.ndarray:
    """Read a TIFF written by imwrite (subset reader) -> (D,H,W) float32."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"II*\x00":
        raise ValueError("not a little-endian TIFF")
    (ifd_offset,) = struct.unpack_from("<I", blob, 4)
    pages: List[np.ndarray] = []
    while ifd_offset:
        (n_entries,) = struct.unpack_from("<H", blob, ifd_offset)
        tags = {}
        p = ifd_offset + 2
        for _ in range(n_entries):
            tag, typ, count = struct.unpack_from("<HHI", blob, p)
            if typ == _TYPE_SHORT:
                (value,) = struct.unpack_from("<H", blob, p + 8)
            else:
                (value,) = struct.unpack_from("<I", blob, p + 8)
            tags[tag] = value
            p += 12
        (ifd_offset,) = struct.unpack_from("<I", blob, p)
        w, h = tags[_IMAGE_WIDTH], tags[_IMAGE_LENGTH]
        off, cnt = tags[_STRIP_OFFSETS], tags[_STRIP_BYTE_COUNTS]
        if tags.get(_SAMPLE_FORMAT) != _SAMPLE_FORMAT_IEEEFP or tags.get(_BITS_PER_SAMPLE) != 32:
            raise ValueError("subset reader supports float32 only")
        page = np.frombuffer(blob, "<f4", count=h * w, offset=off).reshape(h, w)
        assert cnt == h * w * 4
        pages.append(page)
    return np.stack(pages)
