"""DICOM codec of the port (``ctagan_tpu/data/dicom.py``).

The subset of DICOM the synthesis service, the datasets, the test-time
writeback and the offline corpus stage touch, in numpy and the standard
library: part-10 files (128-byte preamble + ``DICM``), the file meta group,
and the two uncompressed little-endian transfer syntaxes (implicit VR
1.2.840.10008.1.2, explicit VR 1.2.840.10008.1.2.1). Every top-level element
is kept as (tag, VR, raw value), so a request's header goes back out
unchanged apart from PixelData, Rows/Columns and SeriesInstanceUID.
Sequences (VR SQ) are carried as opaque bytes; undefined-length sequences
are scanned to their delimiter.
"""
from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"

# VRs whose explicit form has a 2-byte reserved field and a 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC",
             b"UR"}

TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_SOP_CLASS = (0x0008, 0x0016)
TAG_SOP_INSTANCE = (0x0008, 0x0018)
TAG_ACCESSION = (0x0008, 0x0050)
TAG_MANUFACTURER = (0x0008, 0x0070)
TAG_SERIES_DESC = (0x0008, 0x103E)
TAG_PATIENT_ID = (0x0010, 0x0020)
TAG_PATIENT_SEX = (0x0010, 0x0040)
TAG_PATIENT_AGE = (0x0010, 0x1010)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_SLICE_LOCATION = (0x0020, 0x1041)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_BITS_STORED = (0x0028, 0x0101)
TAG_HIGH_BIT = (0x0028, 0x0102)
TAG_PIXEL_REP = (0x0028, 0x0103)
TAG_WINDOW_CENTER = (0x0028, 0x1050)
TAG_WINDOW_WIDTH = (0x0028, 0x1051)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

# implicit-VR files carry no VR: the one each tag is written with
_TAG_VRS: Dict[Tuple[int, int], bytes] = {
    TAG_TRANSFER_SYNTAX: b"UI", TAG_SOP_CLASS: b"UI", TAG_SOP_INSTANCE: b"UI",
    TAG_ACCESSION: b"SH", TAG_MANUFACTURER: b"LO", TAG_SERIES_DESC: b"LO",
    TAG_PATIENT_ID: b"LO", TAG_PATIENT_SEX: b"CS", TAG_PATIENT_AGE: b"AS",
    TAG_SERIES_UID: b"UI", TAG_SLICE_LOCATION: b"DS", TAG_ROWS: b"US",
    TAG_COLS: b"US", TAG_BITS_ALLOCATED: b"US", TAG_BITS_STORED: b"US",
    TAG_HIGH_BIT: b"US", TAG_PIXEL_REP: b"US", TAG_WINDOW_CENTER: b"DS",
    TAG_WINDOW_WIDTH: b"DS", TAG_RESCALE_INTERCEPT: b"DS",
    TAG_RESCALE_SLOPE: b"DS", TAG_PIXEL_DATA: b"OW",
}

_UID_ROOT = "1.2.826.0.1.3680043.10.1543"  # generated-UID prefix
_uid_counter = [0]


def generate_uid() -> str:
    """A unique UID under the project's root."""
    _uid_counter[0] += 1
    return (f"{_UID_ROOT}.{os.getpid()}.{int(time.time() * 1000)}."
            f"{_uid_counter[0]}")


@dataclass
class Element:
    group: int
    elem: int
    vr: bytes  # b"" for implicit
    value: bytes

    @property
    def tag(self) -> Tuple[int, int]:
        return (self.group, self.elem)


@dataclass
class DicomFile:
    """A parsed part-10 file: ordered element lists for the meta group and
    the dataset, with the accessors the serving path needs."""

    meta: List[Element] = field(default_factory=list)
    elements: List[Element] = field(default_factory=list)
    transfer_syntax: str = EXPLICIT_VR_LE

    def _find(self, tag) -> Optional[Element]:
        for e in self.elements:
            if e.tag == tag:
                return e
        return None

    def get_bytes(self, tag) -> Optional[bytes]:
        e = self._find(tag)
        return e.value if e is not None else None

    def set_bytes(self, tag, value: bytes, vr: Optional[bytes] = None):
        if len(value) % 2:  # DICOM values are even-length
            value += b"\x00"
        e = self._find(tag)
        if e is not None:
            e.value = value
            if vr:
                e.vr = vr
            return
        new = Element(tag[0], tag[1], vr or _TAG_VRS.get(tag, b"UN"), value)
        idx = len(self.elements)  # keep the elements tag-ordered
        for i, el in enumerate(self.elements):
            if el.tag > tag:
                idx = i
                break
        self.elements.insert(idx, new)

    def get_str(self, tag) -> Optional[str]:
        v = self.get_bytes(tag)
        if v is None:
            return None
        return v.decode("ascii", errors="replace").rstrip(" \x00")

    def set_str(self, tag, s: str, vr: Optional[bytes] = None):
        b = s.encode("ascii")
        if len(b) % 2:
            b += b"\x00" if (vr or _TAG_VRS.get(tag)) == b"UI" else b" "
        self.set_bytes(tag, b, vr)

    def get_us(self, tag) -> Optional[int]:
        v = self.get_bytes(tag)
        return struct.unpack("<H", v[:2])[0] if v else None

    def set_us(self, tag, value: int):
        self.set_bytes(tag, struct.pack("<H", value), b"US")

    def get_ds(self, tag) -> Optional[List[float]]:
        """Decimal String, possibly multi-valued ('50\\400')."""
        s = self.get_str(tag)
        if not s:
            return None
        return [float(p) for p in s.split("\\") if p.strip()]

    def get_ds1(self, tag, default: Optional[float] = None
                ) -> Optional[float]:
        v = self.get_ds(tag)
        return v[0] if v else default

    @property
    def rows(self) -> int:
        return self.get_us(TAG_ROWS) or 0

    @property
    def cols(self) -> int:
        return self.get_us(TAG_COLS) or 0

    @property
    def bits_allocated(self) -> int:
        return self.get_us(TAG_BITS_ALLOCATED) or 16

    @property
    def pixel_representation(self) -> int:
        return self.get_us(TAG_PIXEL_REP) or 0

    @property
    def rescale_intercept(self) -> float:
        return self.get_ds1(TAG_RESCALE_INTERCEPT, 0.0)

    @property
    def rescale_slope(self) -> float:
        return self.get_ds1(TAG_RESCALE_SLOPE, 1.0)

    @property
    def window_center(self) -> Optional[float]:
        return self.get_ds1(TAG_WINDOW_CENTER)

    @property
    def window_width(self) -> Optional[float]:
        return self.get_ds1(TAG_WINDOW_WIDTH)

    @property
    def series_description(self) -> str:
        return self.get_str(TAG_SERIES_DESC) or ""

    @property
    def patient_id(self) -> str:
        return self.get_str(TAG_PATIENT_ID) or ""

    @property
    def accession_number(self) -> str:
        return self.get_str(TAG_ACCESSION) or ""

    @property
    def slice_location(self) -> Optional[float]:
        return self.get_ds1(TAG_SLICE_LOCATION)

    @property
    def series_instance_uid(self) -> str:
        return self.get_str(TAG_SERIES_UID) or ""

    @series_instance_uid.setter
    def series_instance_uid(self, uid: str):
        self.set_str(TAG_SERIES_UID, uid, b"UI")

    def pixel_array(self) -> np.ndarray:
        """Stored pixel values, no rescale applied."""
        raw = self.get_bytes(TAG_PIXEL_DATA)
        if raw is None:
            raise ValueError("no PixelData")
        bits = self.bits_allocated
        signed = self.pixel_representation == 1
        if bits == 16:
            dt = np.int16 if signed else np.uint16
        elif bits == 8:
            dt = np.int8 if signed else np.uint8
        else:
            raise ValueError(f"unsupported BitsAllocated {bits}")
        n = self.rows * self.cols
        arr = np.frombuffer(raw[: n * (bits // 8)], dtype=dt)
        return arr.reshape(self.rows, self.cols)

    def hu_array(self) -> np.ndarray:
        """Pixels with the rescale applied, slope · stored + intercept, as
        float32."""
        return (self.pixel_array().astype(np.float32) * self.rescale_slope
                + self.rescale_intercept)

    def set_pixel_data(self, arr: np.ndarray):
        """Replace PixelData with ``arr`` cast per BitsAllocated (int16 or
        int8, truncating, as the reference's writeback does)."""
        bits = self.bits_allocated
        if bits == 16:
            data = arr.astype(np.int16)
        elif bits == 8:
            data = arr.astype(np.int8)
        else:
            raise ValueError(f"unknown Bits Allocated value {bits}")
        self.set_bytes(TAG_PIXEL_DATA, data.tobytes(), b"OW")
        self.set_us(TAG_ROWS, arr.shape[0])
        self.set_us(TAG_COLS, arr.shape[1])


def _scan_undefined_sequence(buf: bytes, pos: int) -> int:
    """Position just past the delimiter of the undefined-length sequence
    whose contents start at ``pos``."""
    depth = 1
    while pos + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, pos)
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if (group, elem) == (0xFFFE, 0xE000):  # item
            if length != 0xFFFFFFFF:
                pos += length
        elif (group, elem) == (0xFFFE, 0xE00D):  # item delimiter
            continue
        elif (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            depth -= 1
            if depth == 0:
                return pos
        elif length == 0xFFFFFFFF:  # nested undefined-length element
            depth += 1
        else:
            pos += length
    return len(buf)


def _parse_elements(buf: bytes, pos: int, explicit: bool,
                    stop_at_group=None):
    out: List[Element] = []
    while pos + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, pos)
        if stop_at_group is not None and group != stop_at_group:
            break
        if explicit:
            vr = buf[pos + 4: pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 8)[0]
                hdr = 12
            else:
                length = struct.unpack_from("<H", buf, pos + 6)[0]
                hdr = 8
        else:
            vr = _TAG_VRS.get((group, elem), b"")
            length = struct.unpack_from("<I", buf, pos + 4)[0]
            hdr = 8
        body = pos + hdr
        if length == 0xFFFFFFFF:
            end = _scan_undefined_sequence(buf, body)
            out.append(Element(group, elem, vr or b"SQ", buf[body:end]))
            pos = end
        else:
            out.append(Element(group, elem, vr, buf[body: body + length]))
            pos = body + length
    return out, pos


def read_dicom(path_or_bytes: Union[str, bytes, os.PathLike]) -> DicomFile:
    """Parse a part-10 DICOM file, from its path or its bytes."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    pos = 132 if len(buf) > 132 and buf[128:132] == b"DICM" else 0
    ds = DicomFile()
    # the file meta group (0002) is always explicit VR little endian
    ds.meta, pos = _parse_elements(buf, pos, explicit=True,
                                   stop_at_group=0x0002)
    ts = None
    for e in ds.meta:
        if e.tag == TAG_TRANSFER_SYNTAX:
            ts = e.value.decode("ascii").rstrip(" \x00")
    ds.transfer_syntax = ts or EXPLICIT_VR_LE
    if ds.transfer_syntax not in (IMPLICIT_VR_LE, EXPLICIT_VR_LE):
        raise ValueError(
            f"unsupported transfer syntax {ds.transfer_syntax} (only "
            "uncompressed little-endian is supported)")
    ds.elements, _ = _parse_elements(
        buf, pos, explicit=ds.transfer_syntax == EXPLICIT_VR_LE)
    return ds


def _serialize_element(e: Element, explicit: bool) -> bytes:
    head = struct.pack("<HH", e.group, e.elem)
    if not explicit:
        return head + struct.pack("<I", len(e.value)) + e.value
    vr = e.vr if len(e.vr) == 2 else _TAG_VRS.get(e.tag, b"UN")
    if vr in _LONG_VRS:
        return (head + vr + b"\x00\x00" + struct.pack("<I", len(e.value))
                + e.value)
    return head + vr + struct.pack("<H", len(e.value)) + e.value


def dicom_bytes(ds: DicomFile) -> bytes:
    """Serialize to part-10 bytes."""
    explicit = ds.transfer_syntax == EXPLICIT_VR_LE
    meta = list(ds.meta)
    if not any(e.tag == TAG_TRANSFER_SYNTAX for e in meta):
        ts = ds.transfer_syntax.encode("ascii")
        meta.append(Element(0x0002, 0x0010, b"UI",
                            ts + b"\x00" * (len(ts) % 2)))
    meta_body = b"".join(_serialize_element(e, True) for e in meta
                         if e.tag != (0x0002, 0x0000))
    group_len = Element(0x0002, 0x0000, b"UL",
                        struct.pack("<I", len(meta_body)))
    out = [b"\x00" * 128, b"DICM", _serialize_element(group_len, True),
           meta_body]
    out.extend(_serialize_element(e, explicit) for e in ds.elements)
    return b"".join(out)


def write_dicom(ds: DicomFile, path: str) -> None:
    """Write ``dicom_bytes(ds)`` to a part-10 file at ``path``."""
    with open(path, "wb") as f:
        f.write(dicom_bytes(ds))


def make_ct_slice(pixels: np.ndarray, *, series_uid: Optional[str] = None,
                  slice_location: float = 0.0, series_description: str = "C-",
                  patient_id: str = "P0", accession: str = "A0",
                  wc: float = 50.0, ww: float = 400.0,
                  rescale_intercept: float = -1024.0,
                  manufacturer: str = "GE MEDICAL SYSTEMS", sex: str = "M",
                  age: str = "060Y") -> DicomFile:
    """An in-memory CT slice (explicit VR, 16-bit unsigned, 12 bits stored,
    rescale slope 1) holding the stored values ``pixels`` (0..4095): the
    synthetic request body and corpus slice of the tests and the smoke."""
    ds = DicomFile()
    ts = EXPLICIT_VR_LE.encode("ascii")
    ds.meta = [Element(0x0002, 0x0010, b"UI", ts + b"\x00" * (len(ts) % 2))]
    ds.set_str(TAG_SOP_CLASS, "1.2.840.10008.5.1.4.1.1.2", b"UI")  # CT Image
    ds.set_str(TAG_SOP_INSTANCE, generate_uid(), b"UI")
    ds.set_str(TAG_ACCESSION, accession, b"SH")
    ds.set_str(TAG_MANUFACTURER, manufacturer, b"LO")
    ds.set_str(TAG_SERIES_DESC, series_description, b"LO")
    ds.set_str(TAG_PATIENT_ID, patient_id, b"LO")
    ds.set_str(TAG_PATIENT_SEX, sex, b"CS")
    ds.set_str(TAG_PATIENT_AGE, age, b"AS")
    ds.set_str(TAG_SERIES_UID, series_uid or generate_uid(), b"UI")
    ds.set_str(TAG_SLICE_LOCATION, f"{slice_location:g}", b"DS")
    ds.set_us(TAG_ROWS, pixels.shape[0])
    ds.set_us(TAG_COLS, pixels.shape[1])
    ds.set_us(TAG_BITS_ALLOCATED, 16)
    ds.set_us(TAG_BITS_STORED, 12)
    ds.set_us(TAG_HIGH_BIT, 11)
    ds.set_us(TAG_PIXEL_REP, 0)
    ds.set_str(TAG_WINDOW_CENTER, f"{wc:g}", b"DS")
    ds.set_str(TAG_WINDOW_WIDTH, f"{ww:g}", b"DS")
    ds.set_str(TAG_RESCALE_INTERCEPT, f"{rescale_intercept:g}", b"DS")
    ds.set_str(TAG_RESCALE_SLOPE, "1", b"DS")
    ds.set_bytes(TAG_PIXEL_DATA, pixels.astype(np.uint16).tobytes(), b"OW")
    return ds
