"""Clean-room CZI (Zeiss ZISRAW) reader: the port's own copy of
``repmode_tpu.data.czi``.

Replaces the reference's vendored pure-Python czifile parser
(aicsimage/io/czifile.py) for the ingest path (fnet/data/czireader.py:31-82).
Written from the public ZISRAW file format specification.

Format summary (ZISRAW spec):
  * the file is a sequence of segments, each aligned to 32 bytes:
      16-byte ASCII id | int64 allocated_size | int64 used_size | payload
  * 'ZISRAWFILE'      file header: version, GUIDs, directory/metadata offsets
  * 'ZISRAWMETADATA'  xml_size(i4) attachment_size(i4) spare(248) xml
  * 'ZISRAWDIRECTORY' entry_count(i4) reserved(124) entries
  * 'ZISRAWSUBBLOCK'  metadata_size(i4) attachment_size(i4) data_size(i8)
                      directory_entry ... metadata xml, pixel data, attachment
  * DirectoryEntryDV: 'DV'(2) pixel_type(i4) file_position(i8) file_part(i4)
                      compression(i4) pyramid_type(1) spare(5) dim_count(i4)
                      then dim_count x DimensionEntryDV1
  * DimensionEntryDV1: dimension(4 ascii) start(i4) size(i4)
                       start_coordinate(f4) stored_size(i4)

Scope: uncompressed and TIFF-LZW (compression 2) subblocks, as the Allen
Institute microscopes write them. LZW decodes through the port's native codec
(``repmode_tpu_torch.native.lzw_decode``), which raises if it cannot be
built. Other compressed forms (JPEG / JPEG-XR / zstd) raise
NotImplementedError.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

SEGMENT_HEADER = struct.Struct("<16sqq")

PIXEL_DTYPES = {
    0: np.dtype("<u1"),    # Gray8
    1: np.dtype("<u2"),    # Gray16
    2: np.dtype("<f4"),    # Gray32Float
    3: np.dtype("<u1"),    # Bgr24 (3 samples)
    4: np.dtype("<u2"),    # Bgr48 (3 samples)
    8: np.dtype("<f4"),    # Bgr96Float (3 samples)
    9: np.dtype("<u1"),    # Bgra32 (4 samples)
    10: np.dtype("<c8"),   # Gray64ComplexFloat
    11: np.dtype("<c8"),   # Bgr192ComplexFloat (3 samples)
    12: np.dtype("<i4"),   # Gray32
    13: np.dtype("<i8"),   # Gray64 (czifile.py:1149 maps 13 -> '<i8')
}
PIXEL_SAMPLES = {3: 3, 4: 3, 8: 3, 9: 4, 11: 3}

COMPRESSION_UNCOMPRESSED = 0


class DimensionEntry:
    __slots__ = ("dimension", "start", "size", "start_coordinate", "stored_size")

    def __init__(self, dimension, start, size, start_coordinate, stored_size):
        self.dimension = dimension
        self.start = start
        self.size = size
        self.start_coordinate = start_coordinate
        self.stored_size = stored_size

    def __repr__(self):
        return f"Dim({self.dimension}={self.start}+{self.size})"


class SubBlockEntry:
    __slots__ = (
        "pixel_type", "file_position", "compression", "dimensions",
    )

    def __init__(self, pixel_type, file_position, compression, dimensions):
        self.pixel_type = pixel_type
        self.file_position = file_position
        self.compression = compression
        self.dimensions: List[DimensionEntry] = dimensions

    @property
    def dims_no_m(self) -> List[DimensionEntry]:
        """Dimensions excluding the mosaic-tile index 'M' (czifile.py:666-686
        excludes M from axes/shape/start the same way)."""
        return [d for d in self.dimensions if d.dimension != "M"]

    @property
    def mosaic_index(self) -> Optional[int]:
        for d in self.dimensions:
            if d.dimension == "M":
                return d.start
        return None


def _read_directory_entry(buf: bytes, off: int) -> Tuple[SubBlockEntry, int]:
    schema = buf[off : off + 2]
    if schema != b"DV":
        raise ValueError(f"unsupported directory entry schema {schema!r}")
    pixel_type, = struct.unpack_from("<i", buf, off + 2)
    file_position, = struct.unpack_from("<q", buf, off + 6)
    # file_part(i4) at +14, compression(i4) at +18
    compression, = struct.unpack_from("<i", buf, off + 18)
    # pyramid_type(1) + spare(5) at +22, dim_count at +28
    dim_count, = struct.unpack_from("<i", buf, off + 28)
    dims = []
    p = off + 32
    for _ in range(dim_count):
        name = buf[p : p + 4].rstrip(b"\x00").decode("ascii")
        start, size = struct.unpack_from("<ii", buf, p + 4)
        start_coord, = struct.unpack_from("<f", buf, p + 12)
        stored, = struct.unpack_from("<i", buf, p + 16)
        # stored_size == 0 means "same as size" (czifile.py:718 fallback)
        dims.append(DimensionEntry(name, start, size, start_coord,
                                   stored if stored else size))
        p += 20
    # Real CZI files store dimension entries fastest-axis-first (X first);
    # reversing yields the C-contiguous order of the pixel data. Same
    # behavior as the reference parser (czifile.py:650-652 "reverse
    # dimension_entries to match C contiguous data").
    dims.reverse()
    return SubBlockEntry(pixel_type, file_position, compression, dims), p


class CziFile:
    """Minimal ZISRAW container reader: metadata XML + full array assembly."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._parse_header()
        self._parse_directory()

    # -- context manager ------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- segments -------------------------------------------------------
    def _read_segment_header(self, pos: int) -> Tuple[str, int, int, int]:
        self._fh.seek(pos)
        raw = self._fh.read(SEGMENT_HEADER.size)
        if len(raw) < SEGMENT_HEADER.size:
            raise EOFError
        sid, alloc, used = SEGMENT_HEADER.unpack(raw)
        sid = sid.rstrip(b"\x00").decode("ascii")
        return sid, alloc, used, pos + SEGMENT_HEADER.size

    def _parse_header(self):
        sid, _, _, payload = self._read_segment_header(0)
        if sid != "ZISRAWFILE":
            raise ValueError(f"not a CZI file (leading segment {sid!r})")
        self._fh.seek(payload)
        buf = self._fh.read(512)
        # version(2xi4) reserved(2xi4) guids(2x16) file_part(i4)
        # -> directory_position at offset 4*4 + 32 + 4 = 52
        self.version = struct.unpack_from("<ii", buf, 0)
        self.directory_position, = struct.unpack_from("<q", buf, 52)
        self.metadata_position, = struct.unpack_from("<q", buf, 60)
        # update_pending(i4) at 68, attachment_dir at 72
        self.attachment_directory_position, = struct.unpack_from("<q", buf, 72)

    def _parse_directory(self):
        sid, _, used, payload = self._read_segment_header(self.directory_position)
        if sid != "ZISRAWDIRECTORY":
            raise ValueError(f"expected directory segment, got {sid!r}")
        self._fh.seek(payload)
        buf = self._fh.read(used)
        entry_count, = struct.unpack_from("<i", buf, 0)
        off = 128  # entry_count(i4) + reserved(124)
        self.entries: List[SubBlockEntry] = []
        for _ in range(entry_count):
            entry, off = _read_directory_entry(buf, off)
            self.entries.append(entry)

    # -- metadata -------------------------------------------------------
    def metadata_xml(self) -> str:
        if self.metadata_position <= 0:
            return ""
        sid, _, used, payload = self._read_segment_header(self.metadata_position)
        if sid != "ZISRAWMETADATA":
            raise ValueError(f"expected metadata segment, got {sid!r}")
        self._fh.seek(payload)
        head = self._fh.read(256)
        xml_size, = struct.unpack_from("<i", head, 0)
        xml = self._fh.read(xml_size)
        return xml.decode("utf-8", errors="replace")

    def metadata(self) -> Optional[ET.Element]:
        xml = self.metadata_xml()
        return ET.fromstring(xml) if xml else None

    # -- array assembly -------------------------------------------------
    @property
    def axes(self) -> str:
        """Global axis order: dimension order of the first entry (minus the
        mosaic index M) + '0' samples (czifile.py:666-669)."""
        dims = [d.dimension for d in self.entries[0].dims_no_m]
        return "".join(dims) + "0"

    def _assembly_entries(self) -> List[SubBlockEntry]:
        """Entries in paste order: mosaic files sorted by M index
        (czifile.py:309-320 filtered_subblock_directory), else file order."""
        if any(e.mosaic_index is not None for e in self.entries):
            return sorted(
                (e for e in self.entries if e.mosaic_index is not None),
                key=lambda e: e.mosaic_index,
            )
        return list(self.entries)

    def _global_ranges(self) -> Dict[str, Tuple[int, int]]:
        rng: Dict[str, Tuple[int, int]] = {}
        for e in self._assembly_entries():
            for d in e.dims_no_m:
                lo, hi = rng.get(d.dimension, (d.start, d.start + d.size))
                rng[d.dimension] = (
                    min(lo, d.start), max(hi, d.start + d.size)
                )
        return rng

    def shape(self) -> Tuple[int, ...]:
        rng = self._global_ranges()
        dims = [d.dimension for d in self.entries[0].dims_no_m]
        samples = PIXEL_SAMPLES.get(self.entries[0].pixel_type, 1)
        return tuple(rng[d][1] - rng[d][0] for d in dims) + (samples,)

    def _read_subblock_data(self, entry: SubBlockEntry) -> np.ndarray:
        sid, _, used, payload = self._read_segment_header(entry.file_position)
        if sid != "ZISRAWSUBBLOCK":
            raise ValueError(f"expected subblock, got {sid!r}")
        self._fh.seek(payload)
        head = self._fh.read(16)
        metadata_size, attachment_size = struct.unpack_from("<ii", head, 0)
        data_size, = struct.unpack_from("<q", head, 8)
        # directory entry is repeated inline; data starts after
        # max(256, entry_size + 16) bytes from payload start
        entry_size = 32 + 20 * len(entry.dimensions)
        data_offset = payload + max(256, entry_size + 16) + metadata_size
        self._fh.seek(data_offset)
        raw = self._fh.read(data_size)
        if entry.compression != COMPRESSION_UNCOMPRESSED:
            raw = self._decompress(entry, raw)
        dtype = PIXEL_DTYPES[entry.pixel_type]
        samples = PIXEL_SAMPLES.get(entry.pixel_type, 1)
        stored = tuple(d.stored_size for d in entry.dims_no_m) + (samples,)
        full = tuple(d.size for d in entry.dims_no_m) + (samples,)
        arr = np.frombuffer(raw, dtype=dtype).reshape(stored)
        if stored != full:
            # Pyramid / sub-sampled subblock: resample up to the declared
            # size, bilinear, like the reference (czifile.py:575-598).
            from scipy.ndimage import zoom

            factors = [1.0 if abs(1.0 - j / i) < 1e-4 else j / i
                       for i, j in zip(stored, full)]
            arr = zoom(arr, zoom=factors, order=1)
            arr = arr.reshape(full)
        return arr

    def _decompress(self, entry: SubBlockEntry, raw: bytes) -> bytes:
        if entry.compression == 2:  # LZW (TIFF variant)
            from repmode_tpu_torch import native

            samples = PIXEL_SAMPLES.get(entry.pixel_type, 1)
            expected = (
                int(np.prod([d.stored_size for d in entry.dims_no_m]))
                * samples
                * PIXEL_DTYPES[entry.pixel_type].itemsize
            )
            return native.lzw_decode(raw, expected)
        raise NotImplementedError(
            f"compressed CZI subblocks (compression={entry.compression}) are "
            "not supported: only uncompressed (0) and LZW (2) subblocks are read"
        )

    def asarray(self) -> np.ndarray:
        """Assemble all subblocks into one array, axes = self.axes."""
        rng = self._global_ranges()
        dims = [d.dimension for d in self.entries[0].dims_no_m]
        samples = PIXEL_SAMPLES.get(self.entries[0].pixel_type, 1)
        shape = tuple(rng[d][1] - rng[d][0] for d in dims) + (samples,)
        out = np.zeros(shape, PIXEL_DTYPES[self.entries[0].pixel_type])
        for e in self._assembly_entries():
            data = self._read_subblock_data(e)
            index = tuple(
                slice(d.start - rng[d.dimension][0],
                      d.start - rng[d.dimension][0] + d.size)
                for d in e.dims_no_m
            ) + (slice(None),)
            out[index] = data
        return out


class CziVolumeReader:
    """Channel/axis-aware volume extraction (reference fnet/data/czireader.py:31-82)."""

    def __init__(self, path: str):
        with CziFile(path) as czi:
            self.array = czi.asarray()
            self.axes = czi.axes
            self.meta = czi.metadata()

    def get_size(self, dim: str) -> int:
        return self.array.shape[self.axes.find(dim)]

    def get_volume(self, chan: int, time_slice: Optional[int] = None) -> np.ndarray:
        """(Z, Y, X) volume for a channel (czireader.py:66-82 semantics)."""
        slices = []
        for label in self.axes:
            if label == "C":
                slices.append(int(chan))
            elif label == "T":
                slices.append(0 if time_slice is None else int(time_slice))
            elif label in "ZYX":
                slices.append(slice(None))
            else:
                slices.append(0)
        return self.array[tuple(slices)]

    def get_scales(self) -> Dict[str, Optional[float]]:
        """um/px per axis from Metadata/Scaling/Items/Distance."""
        out: Dict[str, Optional[float]] = {}
        if self.meta is None:
            return out
        for dist in self.meta.iter("Distance"):
            axis = (dist.attrib.get("Id") or "").lower()
            if axis in "zyx" and axis:
                value = dist.find("Value")
                try:
                    out[axis] = float(value.text) * 1e6
                except (AttributeError, TypeError, ValueError):
                    out[axis] = None
        return out
