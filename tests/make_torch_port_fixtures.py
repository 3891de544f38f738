#!/usr/bin/env python3
"""Write the image fixtures of ``t2igan_torch/testdata/`` with PIL.

    python tests/make_torch_port_fixtures.py

The machine with the card cannot write a JPEG (it has no PIL), so
``chip_smoke.py`` decodes these committed files and holds each to the
sha256 of PIL's ``Image.open(path).convert("RGB")`` bytes, recorded here in
``fixtures.json`` (with the shape, the PIL and libjpeg-turbo versions that
wrote them, and what each file covers).  The files are smooth synthetic
pictures made from a seed, so they stay small:

* ``cub_*.jpg``: eight 500x375 / 375x500 JPEGs at CUB's size (4:2:0, 4:2:2,
  4:4:4, progressive, optimised tables, restart markers), from which the
  smoke run builds a CUB-shaped tree;
* ``jpeg_*``: the decoder's features (4:4:0, grayscale, CMYK, RGB colour
  space, restart markers in a progressive file, odd sizes 1x1, 17x9 and
  501x375, qualities 10 to 95);
* ``png_*``: colour types 0, 2, 3, 4 and 6, with and without tRNS, bit
  depths 1 to 8, every row filter.

``tests/test_torch_port_decode.py`` checks that the recorded hashes are
PIL's and that the port decodes every file to them.

It also writes the glyph table of the port's word labels,
``t2igan_torch/utils/aileron10.npz`` (:func:`glyph_table`: PIL's default
font, Aileron Regular at size 10, CC0 1.0, with the Pillow version), and
the attention-grid fixture ``attention_grid.npz`` with the sha256 of the
JAX package's PIL grid of it in ``fixtures.json``, which ``chip_smoke.py``
holds the port's grid to (``tests/test_torch_port_viz.py`` checks both).
"""

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
from PIL import Image, features

OUT = Path(__file__).resolve().parents[1] / "t2igan_torch" / "testdata"
GLYPHS = OUT.parent / "utils" / "aileron10.npz"


def smooth(h: int, w: int, seed: int, texture: float = 0.0) -> np.ndarray:
    """A smooth RGB picture: low-frequency waves and a gradient, plus
    ``texture``: normal noise of that deviation over 2x2 blocks (so a
    CUB-sized JPEG carries about as many bytes as a photograph)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        a, b = rng.uniform(0.005, 0.04, 2)
        p, q = rng.uniform(0, 6.28, 2)
        img[..., c] = (128 + 70 * np.sin(a * x + p) * np.cos(b * y + q)
                       + 50 * (x / max(w, 1) - y / max(h, 1)))
    if texture:
        noise = rng.normal(0, texture, ((h + 1) // 2, (w + 1) // 2, 3))
        img += noise.repeat(2, 0).repeat(2, 1)[:h, :w]
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def with_sampling(data: bytes, factors) -> bytes:
    """The JPEG with its components' sampling factors rewritten in the
    frame header (the entropy data is unchanged)."""
    data = bytearray(data)
    i = 2
    while True:
        marker, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        if marker in (0xC0, 0xC1, 0xC2):
            for k, f in enumerate(factors):
                data[i + 10 + 3 * k + 1] = f
            return bytes(data)
        i += 2 + n


def chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def raw_png(w: int, h: int, depth: int, ctype: int, rows, plte=None) -> bytes:
    """A PNG written by hand: ``rows`` are (filter, raw bytes) per row."""
    body = b"".join(bytes([f]) + r for f, r in rows)
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    return out + chunk(b"IDAT", zlib.compress(body, 9)) + chunk(b"IEND", b"")


def filtered_rows(img: np.ndarray, bpp: int):
    """Rows of ``img`` encoded with filter (y mod 5): every PNG filter."""
    rows, prev = [], np.zeros(img.shape[1] * img.shape[2] if img.ndim == 3
                              else img.shape[1], np.int32)
    for y, row in enumerate(img.reshape(img.shape[0], -1).astype(np.int32)):
        f = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            enc = row
        elif f == 1:
            enc = row - a
        elif f == 2:
            enc = row - prev
        elif f == 3:
            enc = row - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
            enc = row - pred
        rows.append((f, (enc & 0xFF).astype(np.uint8).tobytes()))
        prev = row
    return rows


def fixtures():
    files = {}
    shapes = [(375, 500), (500, 375)]
    cub = [("cub_420_q75.jpg", dict(quality=75, subsampling=2)),
           ("cub_422_q90.jpg", dict(quality=90, subsampling=1)),
           ("cub_444_q60.jpg", dict(quality=60, subsampling=0)),
           ("cub_progressive_q80.jpg", dict(quality=80, progressive=True)),
           ("cub_optimized_q70.jpg", dict(quality=70, optimize=True)),
           ("cub_restart_q85.jpg", dict(quality=85, restart_marker_rows=2)),
           ("cub_420_q40.jpg", dict(quality=40, subsampling=2)),
           ("cub_progressive_q95.jpg", dict(quality=95, progressive=True,
                                            subsampling=0))]
    for i, (name, kw) in enumerate(cub):
        h, w = shapes[i % 2]
        files[name] = (jpeg(Image.fromarray(smooth(h, w, i, texture=8.0)),
                            **kw),
                       f"CUB-sized JPEG {kw}")
    base = Image.fromarray(smooth(48, 64, 20))
    files["jpeg_440.jpg"] = (
        with_sampling(jpeg(Image.fromarray(smooth(64, 48, 21)), quality=80,
                           subsampling=1), [0x12, 0x11, 0x11]),
        "4:4:0 (Y 1x2): a 4:2:2 file with its sampling factors swapped")
    files["jpeg_gray.jpg"] = (jpeg(base.convert("L"), quality=75),
                              "grayscale")
    files["jpeg_gray_progressive.jpg"] = (
        jpeg(base.convert("L"), quality=75, progressive=True),
        "grayscale, progressive")
    cmyk = np.concatenate([smooth(40, 56, 22), smooth(40, 56, 23)[..., :1]],
                          axis=2)
    files["jpeg_cmyk.jpg"] = (jpeg(Image.fromarray(cmyk, "CMYK"),
                                   quality=85), "Adobe CMYK")
    files["jpeg_rgb.jpg"] = (jpeg(base, quality=85, keep_rgb=True),
                             "RGB colour space (no YCbCr transform)")
    files["jpeg_progressive_restart.jpg"] = (
        jpeg(base, quality=80, progressive=True, restart_marker_blocks=3),
        "progressive with restart markers")
    files["jpeg_1x1.jpg"] = (jpeg(Image.fromarray(smooth(1, 1, 24)),
                                  quality=90), "1x1")
    files["jpeg_17x9.jpg"] = (jpeg(Image.fromarray(smooth(9, 17, 25)),
                                   quality=50, subsampling=2),
                              "17 wide, 9 high, 4:2:0")
    files["jpeg_501x375.jpg"] = (jpeg(Image.fromarray(smooth(375, 501, 26)),
                                      quality=20, subsampling=1),
                                 "501x375, 4:2:2")
    for q in (10, 95):
        files[f"jpeg_q{q}.jpg"] = (jpeg(Image.fromarray(smooth(33, 47, q)),
                                        quality=q), f"quality {q}")
    rgb = smooth(19, 23, 30)
    im = Image.fromarray(rgb)
    files["png_rgb.png"] = (png(im), "type 2")
    files["png_rgb_trns.png"] = (png(im, transparency=(10, 20, 30)),
                                 "type 2 with tRNS")
    files["png_rgba.png"] = (png(im.convert("RGBA")), "type 6")
    files["png_gray.png"] = (png(im.convert("L")), "type 0, 8 bits")
    files["png_gray_trns.png"] = (png(im.convert("L"), transparency=5),
                                  "type 0 with tRNS")
    files["png_la.png"] = (png(im.convert("LA")), "type 4")
    files["png_palette.png"] = (png(im.convert("P")), "type 3, 8 bits")
    files["png_palette_trns.png"] = (png(im.convert("P"), transparency=2),
                                     "type 3 with tRNS")
    files["png_palette_4bit.png"] = (png(im.quantize(12)), "type 3, 4 bits")
    files["png_bilevel.png"] = (png(im.convert("1")), "type 0, 1 bit")
    files["png_filters_rgb.png"] = (
        raw_png(23, 19, 8, 2, filtered_rows(rgb, 3)),
        "type 2, rows filtered None/Sub/Up/Average/Paeth in turn")
    gray = rgb[..., 1]
    files["png_filters_gray.png"] = (
        raw_png(23, 19, 8, 0, filtered_rows(gray, 1)),
        "type 0, every row filter")
    return files


def _mask(m) -> np.ndarray:
    w, h = m.size
    return np.array([m.getpixel((x, y)) for y in range(h) for x in range(w)],
                    np.uint8).reshape(h, w)


def glyph_table() -> dict:
    """The arrays of ``aileron10.npz``: every code point U+0020-U+00FF and
    every other one of the Basic Multilingual Plane that PIL's default
    font draws with a glyph of its own (not the missing glyph), then the
    missing glyph (code point -1); per entry its L coverage mask from
    ``getmask2`` (concatenated, ``mask_start`` and ``size`` [h, w] index
    them), its offset and its advance; and the kerned pairs.  Asserts what
    the port's drawing relies on: whole-pixel advances and kerning, and
    additive string lengths."""
    from PIL import ImageFont

    font = ImageFont.load_default()
    assert isinstance(font, ImageFont.FreeTypeFont) and \
        font.layout_engine == ImageFont.Layout.BASIC
    name = " ".join(font.getname())

    def entry(ch):
        m, off = font.getmask2(ch, "L")
        adv = font.getlength(ch)
        assert adv == int(adv), (ch, adv)
        return _mask(m), tuple(off), int(adv)

    missing = entry("\U0001f600")
    cps = [cp for cp in range(0x20, 0x10000)
           if not 0xD800 <= cp < 0xE000
           and (cp <= 0xFF or not _same(entry(chr(cp)), missing))]
    entries = [entry(chr(cp)) for cp in cps] + [missing]
    kern = []
    for a in cps:
        la = font.getlength(chr(a))
        for b in cps:
            k = font.getlength(chr(a) + chr(b)) - la - font.getlength(chr(b))
            assert k == int(k), (a, b, k)
            if k:
                kern.append((a, b, int(k)))
    sizes = [m.shape for m, _, _ in entries]
    return {
        "codepoints": np.asarray(cps + [-1], np.int32),
        "mask_data": np.concatenate([m.reshape(-1) for m, _, _ in entries]),
        "mask_start": np.cumsum([0] + [h * w for h, w in sizes]).astype(
            np.int32),
        "size": np.asarray(sizes, np.int32).reshape(-1, 2),
        "offset": np.asarray([o for _, o, _ in entries], np.int32),
        "advance": np.asarray([a for _, _, a in entries], np.int32),
        "kern_pairs": np.asarray(kern, np.int32).reshape(-1, 3),
        "font": np.asarray(f"{name}, size {font.size}, Pillow's "
                           "ImageFont.load_default()"),
        "licence": np.asarray("CC0 1.0 (the Aileron font shipped inside "
                              "Pillow)"),
        "pillow": np.asarray(Image.__version__),
    }


def _same(a, b) -> bool:
    return a[1:] == b[1:] and np.array_equal(a[0], b[0])


GRID_LABELS = [["a", "small", "bird", "with", "·", "", "wings", "x"],
               ["AVATAR", "To", "this·bird", "yellow", "WAVE", "ff", "Tj",
                "overlong-label-cut"],
               ["ÀÉîõü", "ß¿¡", "\u2019s", "\ufb01ne", "\u4e2d", "(x)",
                "/;s,", "ÿ"]]


def attention_grid_fixture():
    """(inputs, labels, sha256 of the JAX package's PIL grid): three 64 px
    images and [3, 16, 16, 10] maps made from a seed, with a NaN, a zero
    map and a negative one among them."""
    sys.path.insert(0, str(OUT.parents[1]))
    from t2igan.utils.viz import attention_grid

    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    attn = rng.random((3, 16, 16, 10)).astype(np.float32)
    attn[0, 3, 4, 1] = np.nan
    attn[1, :, :, 2] = 0.0
    attn[2, :, :, 3] *= -1.0
    grid = attention_grid(images.astype(np.float32) / 255.0, attn,
                          GRID_LABELS)
    return ({"images_u8": images, "attn": attn}, GRID_LABELS,
            hashlib.sha256(np.ascontiguousarray(grid).tobytes()).hexdigest(),
            list(grid.shape))


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GLYPHS, **glyph_table())
    record = {"written_by": {
        "PIL": Image.__version__ if hasattr(Image, "__version__")
        else features.version("pil"),
        "libjpeg_turbo": features.version("libjpeg_turbo")}, "files": {}}
    for name, (data, what) in sorted(fixtures().items()):
        (OUT / name).write_bytes(data)
        rgb = np.asarray(Image.open(OUT / name).convert("RGB"))
        record["files"][name] = {
            "sha256_rgb": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "shape": list(rgb.shape), "bytes": len(data), "covers": what}
    inputs, labels, sha, shape = attention_grid_fixture()
    np.savez_compressed(OUT / "attention_grid.npz", **inputs)
    record["attention_grid"] = {
        "file": "attention_grid.npz", "labels": labels, "sha256_grid": sha,
        "shape": shape, "covers": "t2igan.utils.viz.attention_grid of "
        "images_u8 / 255 and attn with these labels: PIL's bicubic resize, "
        "its default font's labels, NaN, zero and negative maps"}
    (OUT / "fixtures.json").write_text(json.dumps(record, indent=1) + "\n")
    total = sum(f["bytes"] for f in record["files"].values())
    print(f"{len(record['files'])} fixtures, {total} bytes, in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
