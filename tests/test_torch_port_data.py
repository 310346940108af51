"""Parity: the port's numpy host layer (``ctagan_tpu_torch.data``) against
``ctagan_tpu.data`` on the same bytes and the same seeds. Everything here is
exact: the DICOM bytes, the decoded pixels, the preprocessed images."""
import struct

import numpy as np
import pytest

from ctagan_tpu.data import dicom as jax_dicom
from ctagan_tpu.data import fixtures as jax_fixtures
from ctagan_tpu.data import native as jax_native
from ctagan_tpu_torch.data import dicom, fixtures, native


@pytest.mark.parametrize("dtype", [np.uint16, np.int16])
def test_dual_window_matches_jax_on_every_stored_value(dtype):
    raw = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(dtype)
    raw = raw.reshape(256, 256)
    for got, want in zip(native.dual_window_native(raw),
                         jax_native.dual_window_native(raw)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [((512, 512), 32), ((32, 32), 512),
                                        ((37, 53), 64), ((64, 64), 64)])
def test_resize_nearest_matches_jax(shape, size):
    img = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = native.resize_nearest_native(img, size)
    assert got.shape == (size, size)
    np.testing.assert_array_equal(got, jax_native.resize_nearest_native(img,
                                                                        size))


@pytest.mark.parametrize("size", [32, 512])
def test_synthetic_pixels_match_jax(size):
    got = fixtures.synthetic_ct_pixels(np.random.default_rng(7), size)
    want = jax_fixtures.synthetic_ct_pixels(np.random.default_rng(7), size)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def _jax_slice(transfer_syntax=jax_dicom.EXPLICIT_VR_LE):
    px = jax_fixtures.synthetic_ct_pixels(np.random.default_rng(1), 32)
    ds = jax_dicom.make_ct_slice(px, series_uid="1.2.3.4")
    ds.transfer_syntax = transfer_syntax
    ds.meta = []  # dicom_bytes writes the transfer syntax from the field
    return jax_dicom.dicom_bytes(ds)


@pytest.mark.parametrize("ts", [jax_dicom.EXPLICIT_VR_LE,
                                jax_dicom.IMPLICIT_VR_LE])
def test_read_and_serialize_match_jax(ts):
    body = _jax_slice(ts)
    got, want = dicom.read_dicom(body), jax_dicom.read_dicom(body)
    assert got.transfer_syntax == want.transfer_syntax == ts
    assert [(e.tag, e.vr, e.value) for e in got.elements] == [
        (e.tag, e.vr, e.value) for e in want.elements]
    np.testing.assert_array_equal(got.pixel_array(), want.pixel_array())
    assert got.series_instance_uid == want.series_instance_uid == "1.2.3.4"
    assert dicom.dicom_bytes(got) == jax_dicom.dicom_bytes(want) == body


def test_writeback_matches_jax():
    """The service's writeback: stored values from the generator output,
    cast per BitsAllocated, and a new SeriesInstanceUID."""
    body = _jax_slice()
    fake = np.random.default_rng(2).uniform(-1, 1, (16, 16)).astype(
        np.float32)
    out = []
    for mod in (dicom, jax_dicom):
        ds = mod.read_dicom(body)
        ds.set_pixel_data((fake + 1.0) * 0.5 * 4095.0)
        ds.series_instance_uid = "1.2.3.5"
        out.append(mod.dicom_bytes(ds))
    assert out[0] == out[1]
    assert dicom.read_dicom(out[0]).pixel_array().shape == (16, 16)


def test_make_ct_slice_matches_jax():
    px = fixtures.synthetic_ct_pixels(np.random.default_rng(3), 32)
    got = dicom.make_ct_slice(px, series_uid="1.2.3.6")
    want = jax_dicom.make_ct_slice(px, series_uid="1.2.3.6")
    sop = dicom.TAG_SOP_INSTANCE
    got.set_str(sop, "1.2.3.7", b"UI")  # the only generated field
    want.set_str(sop, "1.2.3.7", b"UI")
    assert dicom.dicom_bytes(got) == jax_dicom.dicom_bytes(want)


def test_undefined_length_sequence_matches_jax():
    """An explicit-VR file with an undefined-length sequence (an item of
    defined length holding one element, then an empty item of undefined
    length) before the pixel data."""
    def el(group, elem, vr, value):
        if vr in (b"SQ", b"OW"):
            return (struct.pack("<HH", group, elem) + vr + b"\x00\x00"
                    + struct.pack("<I", len(value)) + value)
        return (struct.pack("<HH", group, elem) + vr
                + struct.pack("<H", len(value)) + value)

    ts = jax_dicom.EXPLICIT_VR_LE.encode() + b"\x00"
    meta = el(0x0002, 0x0010, b"UI", ts)
    nested = el(0x0008, 0x0100, b"SH", b"T1")
    seq = (struct.pack("<HH", 0x0008, 0x1140) + b"SQ\x00\x00"
           + struct.pack("<I", 0xFFFFFFFF)
           + struct.pack("<HHI", 0xFFFE, 0xE000, len(nested)) + nested
           + struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF)
           + struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    px = np.arange(16, dtype=np.uint16)
    body = (b"\x00" * 128 + b"DICM"
            + el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta))) + meta
            + seq + el(0x0028, 0x0010, b"US", struct.pack("<H", 4))
            + el(0x0028, 0x0011, b"US", struct.pack("<H", 4))
            + el(0x7FE0, 0x0010, b"OW", px.tobytes()))
    got, want = dicom.read_dicom(body), jax_dicom.read_dicom(body)
    assert [(e.tag, e.vr, e.value) for e in got.elements] == [
        (e.tag, e.vr, e.value) for e in want.elements]
    assert len(got.elements) == 4
    np.testing.assert_array_equal(got.pixel_array(), px.reshape(4, 4))
    assert dicom.dicom_bytes(got) == jax_dicom.dicom_bytes(want)


def test_unsupported_transfer_syntax_rejected():
    body = bytearray(_jax_slice())
    pos = body.find(jax_dicom.EXPLICIT_VR_LE.encode())
    body[pos:pos + 19] = b"1.2.840.10008.1.2.5"  # RLE lossless
    with pytest.raises(ValueError, match="transfer syntax"):
        dicom.read_dicom(bytes(body))
