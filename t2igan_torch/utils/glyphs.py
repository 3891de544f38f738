"""Word labels drawn without PIL.

The JAX package labels its attention grids with PIL's
``ImageDraw.text(xy, text, fill="black")`` in the default font: on Pillow
12.1 that is Aileron Regular at size 10 (a FreeType font, CC0 1.0, shipped
inside Pillow), laid out in the BASIC layout.  The machine with the card
has no PIL, so :func:`draw_text` draws the same pixels from a table of
that font's glyphs, ``aileron10.npz`` beside this module, which
``tests/make_torch_port_fixtures.py`` renders with PIL (it records the
Pillow version, the font's name and its licence in the table):

* each glyph's 8-bit coverage mask and its offset from the pen, from
  ``font.getmask2(ch, "L")``, and its advance, ``font.getlength(ch)``
  (whole pixels at this size, so every pen position is an integer and the
  masks need no sub-pixel variants);
* the pairs whose kerning ``getlength(a + b) - getlength(a) -
  getlength(b)`` is not 0 (none in this font);
* every code point U+0020-U+00FF and every other one of the Basic
  Multilingual Plane that the font maps to a glyph; any other character is
  the font's missing glyph, as FreeType draws it.

A string is drawn as PIL draws it: the glyphs' masks combine into one
coverage mask where they overlap as ``s + t * (255 - s) / 255`` (rounded
as Pillow's ``DIV255``), and that mask blends the ink into the canvas,
``out = (out * (255 - m) + ink * m) / 255`` with the same rounding,
clipped to the canvas.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

TABLE = Path(__file__).with_name("aileron10.npz")


def _div255(v: np.ndarray) -> np.ndarray:
    """Pillow's rounded division by 255 of an integer in [0, 255 * 255]."""
    t = v + 128
    return ((t >> 8) + t) >> 8


class GlyphTable:
    """The glyphs of ``path``: ``glyph(ch)`` gives ``(mask [h, w] uint8,
    (x, y) offset, advance)``."""

    def __init__(self, path: Path = TABLE):
        with np.load(path) as f:
            t = {k: f[k] for k in f.files}
        starts = t["mask_start"]
        self.info = {k: str(t[k]) for k in ("font", "licence", "pillow")}
        glyphs = []
        for i, (h, w) in enumerate(t["size"]):
            mask = t["mask_data"][starts[i]:starts[i + 1]].reshape(h, w)
            glyphs.append((mask, tuple(int(v) for v in t["offset"][i]),
                           int(t["advance"][i])))
        # The last entry is the missing glyph (code point -1).
        self.missing = glyphs[-1]
        self.glyphs: Dict[str, Tuple] = {
            chr(cp): g for cp, g in zip(t["codepoints"][:-1], glyphs)}
        self.kerning: Dict[Tuple[str, str], int] = {
            (chr(a), chr(b)): int(k) for a, b, k in t["kern_pairs"]}

    def glyph(self, ch: str) -> Tuple[np.ndarray, Tuple[int, int], int]:
        return self.glyphs.get(ch, self.missing)

    def coverage(self, text: str) -> Tuple[np.ndarray, int, int]:
        """The coverage mask of ``text`` drawn with its pen at (0, 0), and
        the mask's (x, y) offset from the pen."""
        placed, pen, prev = [], 0, None
        for ch in text:
            if prev is not None:
                pen += self.kerning.get((prev, ch), 0)
            mask, (ox, oy), adv = self.glyph(ch)
            if mask.size:
                placed.append((mask, pen + ox, oy))
            pen += adv
            prev = ch
        if not placed:
            return np.zeros((0, 0), np.int32), 0, 0
        x0 = min(x for _, x, _ in placed)
        y0 = min(y for _, _, y in placed)
        x1 = max(x + m.shape[1] for m, x, _ in placed)
        y1 = max(y + m.shape[0] for m, _, y in placed)
        cov = np.zeros((y1 - y0, x1 - x0), np.int32)
        for mask, x, y in placed:
            h, w = mask.shape
            region = cov[y - y0:y - y0 + h, x - x0:x - x0 + w]
            s = mask.astype(np.int32)
            region[...] = s + _div255(region * (255 - s))
        return cov, x0, y0


@functools.lru_cache(maxsize=1)
def default_table() -> GlyphTable:
    return GlyphTable()


def draw_text(canvas: np.ndarray, x: int, y: int, text: str,
              ink: Tuple[int, int, int] = (0, 0, 0)) -> None:
    """Draw ``text`` into the uint8 [H, W, 3] ``canvas`` in place, as
    ``ImageDraw.Draw(img).text((x, y), text, fill=ink)`` draws it on an RGB
    image with the default font.  ``x`` and ``y`` are whole pixels; a line
    break raises (PIL would lay out several lines)."""
    if "\n" in text:
        raise ValueError(f"draw_text draws one line; got {text!r}")
    cov, ox, oy = default_table().coverage(text)
    h, w = cov.shape
    x0, y0 = x + ox, y + oy
    cx0, cy0 = max(x0, 0), max(y0, 0)
    cx1, cy1 = min(x0 + w, canvas.shape[1]), min(y0 + h, canvas.shape[0])
    if cx0 >= cx1 or cy0 >= cy1:
        return
    m = cov[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0, None]
    out = canvas[cy0:cy1, cx0:cx1].astype(np.int32)
    canvas[cy0:cy1, cx0:cx1] = _div255(
        out * (255 - m) + np.asarray(ink, np.int32) * m).astype(np.uint8)
