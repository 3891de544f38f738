"""The chip's peaks and the least time of the fused stage tail (K3).

Copied from ``chip_smoke.py`` at commit c2e05f1: the peaks
(``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, lines 163-166), ``f32_bound``
(line 299) and K3's work and bytes from its stage shapes
(``time_reschain``, lines 1866-1876).  The program may change; this copy
does not, so every later run is held to the same yardstick.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# H100 SXM data-sheet peaks: device memory rate, dense bf16 and TF32
# tensor-core rates, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}

# The peak a cell's whole step is read against: bf16's tensor-core rate;
# for f32, the TF32 rate, the highest at which the card takes f32
# operands, so that no implementation reads over 100%.
MFU_PEAK = {"bf16": PEAK_FLOPS["bf16"], "f32": PEAK_FLOPS["tf32"]}


def f32_bound(nbytes: float, flops: float) -> Tuple[float, float, float,
                                                     float]:
    """The least time (ms) an f32 function may take on the card: the larger
    of its bytes over the memory rate and its f32 work done as 3xTF32 (three
    TF32 products for each f32 one) over the TF32 peak.  Also returns the
    bytes and 3xTF32 times and the CUDA-core floor (the f32 work over the
    67 TFLOP/s outside the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops, flops / PEAK_FLOPS["f32"] * 1e3


def k3_stage_work(b: int, hw: Tuple[int, int], c: int, n_res: int,
                  rgb: bool, elem_bytes: int) -> Tuple[float, float]:
    """(flops, bytes) of one K3 launch: ``n_res`` ResBlocks and the
    UpBlock (as its four 2x2 phase kernels) on a [b, h, w, c] map, then
    either the 2x map out or, with ``rgb``, only the RGB head's image."""
    n = hw[0] * hw[1]
    e = elem_bytes
    flops = 2 * b * n * (n_res * 9 * (2 * c * c + c * c) + 16 * c * c)
    nbytes = e * (b * n * c + n_res * 9 * 3 * c * c + 9 * c * c) \
        + 4 * (n_res * 6 * c + 2 * c)
    if rgb:
        flops += 2 * b * 4 * n * 9 * (c // 2) * 3
        nbytes += e * (9 * (c // 2) * 3 + b * 4 * n * 3)
    else:
        nbytes += e * b * 4 * n * (c // 2)
    return flops, nbytes


def k3_stage_bound_ms(flops: float, nbytes: float, dtype: str) -> float:
    """The least time (ms) of one launch: bytes at the memory rate against
    the work at bf16's rate, or, in f32, as 3xTF32 (:func:`f32_bound`)."""
    if dtype == "f32":
        return f32_bound(nbytes, flops)[0]
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]) * 1e3


def k3_bound_ms(b: int, stages: Iterable[Tuple[Tuple[int, int], bool]],
                c: int, n_res: int, dtype: str) -> float:
    """K3's least time for one sampler call: its launches' bounds summed,
    each stage ``((h, w), rgb)``."""
    e = 2 if dtype == "bf16" else 4
    return sum(k3_stage_bound_ms(*k3_stage_work(b, hw, c, n_res, rgb, e),
                                 dtype) for hw, rgb in stages)
