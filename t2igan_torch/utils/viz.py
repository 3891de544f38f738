"""Image grids (port of :mod:`t2igan.utils.viz`), written through the zlib
PNG writer: the card's machine has no PIL.

:func:`attention_grid` is the JAX package's grid bit for bit: the same
numpy arithmetic (float32 where it is float32, truncation to uint8), with
PIL's parts done by the port: the cell resize is PIL's default BICUBIC
(:func:`t2igan_torch.data.native.resize_pil_bicubic`), pasting is array
assignment, and the word labels come from
:func:`t2igan_torch.utils.glyphs.draw_text`, PIL's default font.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from t2igan_torch.data.native import resize_pil_bicubic
from t2igan_torch.ops.image import CLIP_MEAN, CLIP_STD
from t2igan_torch.utils.glyphs import draw_text
from t2igan_torch.utils.png import write_png


def denormalize_clip(x: np.ndarray) -> np.ndarray:
    """CLIP-normalised images -> [0, 1] (float64, as the JAX package's)."""
    return np.clip(x * np.asarray(CLIP_STD) + np.asarray(CLIP_MEAN), 0, 1)


def tanh_to01(x: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1], clipped."""
    return np.clip((x + 1.0) * 0.5, 0, 1)


def _upscale_nearest(a: np.ndarray, size: int) -> np.ndarray:
    """Nearest-resize a 2-D map to exactly (size, size)."""
    idx_r = (np.arange(size) * a.shape[0]) // size
    idx_c = (np.arange(size) * a.shape[1]) // size
    return a[np.ix_(idx_r, idx_c)]


def word_labels(tokenizer, ids) -> List[List[str]]:
    """The grids' labels: each row's tokens 1-8 decoded one by one,
    ``"·"`` for one that decodes to nothing, as the JAX trainers make
    them."""
    return [[tokenizer.decode([t]).strip() or "·" for t in row[1:9]]
            for row in np.asarray(ids)]


def attention_grid(images01: np.ndarray, attn: np.ndarray,
                   words: Sequence[Sequence[str]], max_words: int = 8,
                   cell: int = 96) -> np.ndarray:
    """One row per sample: the image resized to ``cell``, then its first
    ``max_words`` attention maps over it (red where the map is high), each
    under its word (cut to 12 characters).

    images01 [B, S, S, 3] in [0, 1]; attn [B, Hw, Ww, L] (or [B, P, L],
    the first ``side**2`` regions taken as a square); ``words`` per-sample
    strings.  Returns the uint8 [B * (cell + 14), (n + 1) * cell, 3]
    grid."""
    b = images01.shape[0]
    if attn.ndim == 3:
        p = attn.shape[1]
        side = int(np.sqrt(p))
        attn = attn[:, :side * side, :].reshape(b, side, side, -1)
    n_words = min(max_words, attn.shape[-1])
    pad_top = 14
    grid = np.full((b * (cell + pad_top), (n_words + 1) * cell, 3), 255,
                   np.uint8)
    for i in range(b):
        base = resize_pil_bicubic((images01[i] * 255).astype(np.uint8),
                                  cell, cell)
        y = i * (cell + pad_top) + pad_top
        grid[y:y + cell, :cell] = base
        for w in range(n_words):
            amap = np.nan_to_num(attn[i, :, :, w])
            amax = amap.max() if amap.max() > 0 else 1.0
            amap = _upscale_nearest(amap / amax, cell)
            overlay = np.asarray(base, np.float32) / 255.0
            heat = np.stack([amap, np.zeros_like(amap), 1.0 - amap], -1)
            mix = np.clip(0.6 * overlay + 0.4 * heat, 0, 1)
            x = (w + 1) * cell
            grid[y:y + cell, x:x + cell] = (mix * 255).astype(np.uint8)
            label = words[i][w] if w < len(words[i]) else ""
            draw_text(grid, x + 2, y - pad_top + 2, label[:12])
    return grid


def save_image_grid(images01: np.ndarray, path: str, ncol: int = 8) -> None:
    """Save a batch of [B, S, S, 3] images in [0, 1] as one tiled PNG,
    ``ncol`` to a row, truncated to uint8 as the JAX package does."""
    b, s, _, _ = images01.shape
    ncol = min(ncol, b)
    nrow = (b + ncol - 1) // ncol
    grid = np.zeros((nrow * s, ncol * s, 3), np.float32)
    for i in range(b):
        r, c = divmod(i, ncol)
        grid[r * s:(r + 1) * s, c * s:(c + 1) * s] = images01[i]
    write_png(path, (grid * 255).astype(np.uint8))
