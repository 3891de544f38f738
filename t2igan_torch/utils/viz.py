"""Image grids (port of part of :mod:`t2igan.utils.viz`), written through
the zlib PNG writer.  The attention grids, which draw word labels, are
not ported yet (ROADMAP.md, Queue 1)."""

from __future__ import annotations

import numpy as np

from t2igan_torch.utils.png import write_png


def tanh_to01(x: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1], clipped."""
    return np.clip((x + 1.0) * 0.5, 0, 1)


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
