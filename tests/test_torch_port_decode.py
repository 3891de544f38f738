"""The port's image decoder and PIL-exact resize against PIL, on the CPU.

``t2igan_torch.data.native`` decodes JPEG and PNG with its own C++ decoder
(``csrc/image_decode.cc``: libjpeg-turbo's arithmetic re-implemented, zlib
for PNG), since the machine with the card has no PIL.  Every decode here
must be bitwise equal to ``np.asarray(Image.open(p).convert("RGB"))``:
JPEG baseline 4:4:4, 4:2:2, 4:2:0 and 4:4:0, progressive, optimised
Huffman tables, restart markers, grayscale, CMYK, the RGB colour space,
odd sizes and qualities 10-95, and a hypothesis sweep over size, quality,
subsampling and progression; PNG colour types 0, 2, 3, 4 and 6 with and
without tRNS and every row filter.  Truncated and corrupt files and every
feature the decoder does not take raise ``DecodeError`` naming the file.
The committed fixtures' recorded hashes are PIL's decode here, and
``resize_pil_bilinear`` is bitwise ``Image.resize(..., BILINEAR)``.
"""

import hashlib
import io
import json
import struct
import sys
import types
import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from make_torch_port_fixtures import (OUT as TESTDATA, jpeg, png, raw_png,
                                      filtered_rows, smooth, with_sampling)
from t2igan_torch.data import native

FIXTURES = json.loads((TESTDATA / "fixtures.json").read_text())["files"]


@pytest.fixture(autouse=True, scope="module")
def _hashable_sys_modules():
    """hypothesis hashes every entry of ``sys.modules`` while it draws;
    another test file of the suite registers a ``SimpleNamespace`` there
    as a stub module, which cannot be hashed.  Such entries stand in as
    real modules with the same attributes while this file runs."""
    swapped = {}
    for name, mod in list(sys.modules.items()):
        try:
            hash(mod)
        except TypeError:
            swapped[name] = mod
            stand_in = types.ModuleType(name)
            stand_in.__dict__.update(vars(mod))
            sys.modules[name] = stand_in
    yield
    sys.modules.update(swapped)


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(tmp_path, data: bytes, name: str = "x.img"):
    path = tmp_path / name
    path.write_bytes(data)
    got = native.decode_image(str(path))
    want = pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert native.image_dims(str(path)) == want.shape[:2]


def _rgb(h, w, seed=0, texture=6.0):
    return Image.fromarray(smooth(h, w, seed, texture))


JPEG_CASES = {
    "baseline_444": lambda: jpeg(_rgb(40, 56), quality=75, subsampling=0),
    "baseline_422": lambda: jpeg(_rgb(40, 56), quality=75, subsampling=1),
    "baseline_420": lambda: jpeg(_rgb(40, 56), quality=75, subsampling=2),
    "baseline_440": lambda: with_sampling(
        jpeg(_rgb(48, 64, 1), quality=75, subsampling=1),
        [0x12, 0x11, 0x11]),
    "baseline_411": lambda: with_sampling(
        jpeg(_rgb(32, 32, 2), quality=75, subsampling=2),
        [0x41, 0x11, 0x11]),
    "progressive_420": lambda: jpeg(_rgb(40, 56), quality=80,
                                    progressive=True),
    "progressive_444": lambda: jpeg(_rgb(40, 56), quality=80,
                                    progressive=True, subsampling=0),
    "progressive_440": lambda: with_sampling(
        jpeg(_rgb(48, 64, 3), quality=80, subsampling=1, progressive=True),
        [0x12, 0x11, 0x11]),
    "optimized": lambda: jpeg(_rgb(40, 56), quality=70, optimize=True),
    "restart_blocks": lambda: jpeg(_rgb(41, 57), quality=85,
                                   restart_marker_blocks=3),
    "restart_rows_422": lambda: jpeg(_rgb(41, 57), quality=85, subsampling=1,
                                     restart_marker_rows=1),
    "restart_progressive": lambda: jpeg(_rgb(41, 57), quality=85,
                                        progressive=True,
                                        restart_marker_blocks=2),
    "grayscale": lambda: jpeg(_rgb(33, 45).convert("L"), quality=75),
    "grayscale_progressive": lambda: jpeg(_rgb(33, 45).convert("L"),
                                          quality=75, progressive=True),
    "cmyk": lambda: jpeg(Image.fromarray(np.concatenate(
        [smooth(30, 38, 4, 6.0), smooth(30, 38, 5, 6.0)[..., :1]], axis=2),
        "CMYK"), quality=85),
    "rgb_colour_space": lambda: jpeg(_rgb(30, 38), quality=85,
                                     keep_rgb=True),
    "size_1x1": lambda: jpeg(_rgb(1, 1), quality=90),
    "size_17x9": lambda: jpeg(_rgb(9, 17), quality=50),
    "size_2x5_420": lambda: jpeg(_rgb(5, 2), quality=60, subsampling=2),
    "size_501x375": lambda: jpeg(_rgb(375, 501), quality=75),
    "quality_10": lambda: jpeg(_rgb(40, 56), quality=10),
    "quality_50": lambda: jpeg(_rgb(40, 56), quality=50, subsampling=1),
    "quality_95": lambda: jpeg(_rgb(40, 56), quality=95),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_decodes_as_pil(tmp_path, case):
    data = JPEG_CASES[case]()
    if "restart" in case:
        assert b"\xff\xdd" in data  # PIL wrote a restart interval
    if "progressive" in case:
        assert b"\xff\xc2" in data
    assert_decodes_as_pil(tmp_path, data, f"{case}.jpg")


def _filtered_png(img: np.ndarray) -> bytes:
    if img.ndim == 2:
        return raw_png(img.shape[1], img.shape[0], 8, 0,
                       filtered_rows(img, 1))
    return raw_png(img.shape[1], img.shape[0], 8, 2, filtered_rows(img, 3))


def _packed_gray(depth: int) -> bytes:
    rng = np.random.default_rng(depth)
    g = rng.integers(0, 2 ** depth, (5, 13), dtype=np.uint8)
    rows = [(0, np.packbits(np.unpackbits(r[:, None], axis=1)[:, 8 - depth:]
                            .reshape(-1)).tobytes()) for r in g]
    return raw_png(13, 5, depth, 0, rows)


PNG_CASES = {
    "type2_rgb": lambda: png(_rgb(19, 23)),
    "type2_trns": lambda: png(_rgb(19, 23), transparency=(1, 2, 3)),
    "type6_rgba": lambda: png(_rgb(19, 23).convert("RGBA")),
    "type0_gray": lambda: png(_rgb(19, 23).convert("L")),
    "type0_trns": lambda: png(_rgb(19, 23).convert("L"), transparency=9),
    "type0_1bit": lambda: png(_rgb(19, 23).convert("1")),
    "type0_2bit": lambda: _packed_gray(2),
    "type0_4bit": lambda: _packed_gray(4),
    "type4_la": lambda: png(_rgb(19, 23).convert("LA")),
    "type3_palette": lambda: png(_rgb(19, 23).convert("P")),
    "type3_trns": lambda: png(_rgb(19, 23).convert("P"), transparency=4),
    "type3_4bit": lambda: png(_rgb(19, 23).quantize(12)),
    "type3_1bit": lambda: png(_rgb(19, 23).quantize(2)),
    "type3_short_palette": lambda: raw_png(
        9, 2, 8, 3, [(0, bytes(range(i * 9, i * 9 + 9))) for i in range(2)],
        plte=bytes(range(30))),
    "filters_rgb": lambda: _filtered_png(smooth(19, 23, 6, 20.0)),
    "filters_gray": lambda: _filtered_png(smooth(19, 23, 7, 20.0)[..., 0]),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_decodes_as_pil(tmp_path, case):
    assert_decodes_as_pil(tmp_path, PNG_CASES[case](), f"{case}.png")


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(5, 100), subsampling=st.integers(0, 2),
       progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_jpeg_decodes_as_pil_over_random_settings(tmp_path_factory, h, w,
                                                  quality, subsampling,
                                                  progressive, seed):
    data = jpeg(_rgb(h, w, seed, texture=10.0), quality=quality,
                subsampling=subsampling, progressive=progressive)
    path = tmp_path_factory.mktemp("hyp") / "x.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(native.decode_image(str(path)),
                                  pil_rgb(data))


def _patched(data: bytes, offset: int, value: int) -> bytes:
    b = bytearray(data)
    b[offset] = value
    return bytes(b)


def _marker(data: bytes, codes) -> int:
    """Offset of the first marker in ``codes``."""
    i = 2
    while data[i + 1] not in codes:
        i += 2 + ((data[i + 2] << 8) | data[i + 3])
    return i


def _png_with_ihdr(data: bytes, field: int, value: int) -> bytes:
    b = bytearray(data)
    b[16 + field] = value
    b[29:33] = struct.pack(">I", zlib.crc32(bytes(b[12:29])) & 0xFFFFFFFF)
    return bytes(b)


def _base_jpeg():
    return jpeg(_rgb(24, 32), quality=80)


UNSUPPORTED = {
    "arithmetic": (lambda: _patched(
        _base_jpeg(), _marker(_base_jpeg(), (0xC0,)) + 1, 0xC9),
        "arithmetic"),
    "lossless": (lambda: _patched(
        _base_jpeg(), _marker(_base_jpeg(), (0xC0,)) + 1, 0xC3), "lossless"),
    "hierarchical": (lambda: _patched(
        _base_jpeg(), _marker(_base_jpeg(), (0xC0,)) + 1, 0xC5),
        "hierarchical"),
    "12-bit": (lambda: _patched(
        _base_jpeg(), _marker(_base_jpeg(), (0xC0,)) + 4, 12), "12-bit"),
    "dnl_height": (lambda: _patched(_patched(
        _base_jpeg(), _marker(_base_jpeg(), (0xC0,)) + 5, 0),
        _marker(_base_jpeg(), (0xC0,)) + 6, 0), "DNL"),
    "ycck": (lambda: _patched(
        JPEG_CASES["cmyk"](), _marker(JPEG_CASES["cmyk"](), (0xEE,)) + 15,
        2), "YCCK"),
    "interlaced_png": (lambda: _png_with_ihdr(png(_rgb(8, 8)), 12, 1),
                       "interlaced"),
    "16bit_png": (lambda: png(Image.fromarray(
        smooth(8, 8, 1)[..., 0].astype(np.uint16) * 257)), "16 bits"),
    "bmp": (lambda: _saved(_rgb(8, 8), "BMP"), "BMP"),
    "webp": (lambda: b"RIFF\x24\x00\x00\x00WEBPVP8 " + bytes(32), "WebP"),
    "gif": (lambda: _saved(_rgb(8, 8).convert("P"), "GIF"), "GIF"),
}


def _saved(img, fmt):
    buf = io.BytesIO()
    img.save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_features_raise_naming_file_and_feature(tmp_path, case):
    make, feature = UNSUPPORTED[case]
    path = tmp_path / f"{case}.img"
    path.write_bytes(make())
    with pytest.raises(native.DecodeError) as e:
        native.decode_image(str(path))
    assert str(path) in str(e.value) and feature in str(e.value)
    assert "unsupported" in str(e.value)


def _truncated_jpeg():
    data = _base_jpeg()
    return data[:len(data) // 2]


def _corrupt_scan():
    data = bytearray(JPEG_CASES["baseline_420"]())
    sos = _marker(bytes(data), (0xDA,))
    data[sos + 20:sos + 22] = b"\xff\xd9"  # EOI inside the scan
    return bytes(data)


def _bad_png_crc():
    data = bytearray(png(_rgb(8, 8)))
    data[40] ^= 0xFF
    return bytes(data)


def _truncated_png():
    data = png(_rgb(32, 32, texture=30.0))
    return data[:len(data) - 60]


CORRUPT = {
    "truncated_jpeg": _truncated_jpeg,
    "jpeg_scan_cut_by_eoi": _corrupt_scan,
    "jpeg_without_soi": lambda: _base_jpeg()[2:] + b"\xff\xd8",
    "png_bad_crc": _bad_png_crc,
    "truncated_png": _truncated_png,
    "empty": lambda: b"",
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_and_truncated_files_raise_naming_the_file(tmp_path, case):
    path = tmp_path / f"{case}.img"
    path.write_bytes(CORRUPT[case]())
    with pytest.raises(native.DecodeError) as e:
        native.decode_image(str(path))
    assert str(path) in str(e.value)


def test_missing_file_raises_with_its_name(tmp_path):
    path = str(tmp_path / "nope.jpg")
    with pytest.raises(native.DecodeError, match="nope.jpg.*cannot read"):
        native.decode_image(path)
    with pytest.raises(native.DecodeError, match="nope.jpg"):
        native.image_dims(path)


def test_fixture_hashes_are_pils_decode():
    """The committed fixtures' recorded sha256 and shapes equal PIL's
    decode here."""
    assert len(FIXTURES) >= 30
    for name, rec in FIXTURES.items():
        rgb = np.asarray(Image.open(TESTDATA / name).convert("RGB"))
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
            rec["sha256_rgb"], name
        assert list(rgb.shape) == rec["shape"], name


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_decodes_to_its_recorded_hash(name):
    got = native.decode_image(str(TESTDATA / name))
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        FIXTURES[name]["sha256_rgb"]
    assert list(got.shape) == FIXTURES[name]["shape"]


@pytest.mark.parametrize("src,dst", [
    ((256, 256), (32, 32)),      # Scale(32) of a generated image
    ((375, 500), (32, 43)),      # Scale(32) of a CUB-sized one
    ((500, 375), (43, 32)),
    ((20, 30), (41, 57)),        # upscale
    ((7, 9), (7, 20)),           # one axis only
    ((64, 48), (32, 24)),
    ((1, 1), (5, 3)),
])
def test_resize_pil_bilinear_is_pils(src, dst):
    img = smooth(*src, seed=src[0] + src[1], texture=25.0)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]),
                                                  Image.BILINEAR))
    np.testing.assert_array_equal(native.resize_pil_bilinear(img, *dst),
                                  want)


def test_library_name_follows_its_sources():
    """The host library is named by a hash of its sources and flags, so an
    edited source builds anew; a built one loads again without a
    compile."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libt2igan_host-") and path.suffix == ".so"
    native.load()
    assert path.exists() and native.build() == 0.0
