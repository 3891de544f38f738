"""Image helpers of the sampler path (port of part of
:mod:`t2igan.ops.image`).  Feature maps are NCHW here, as PyTorch's
convolutions take them; images leave the sampler as NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW map: every pixel becomes a
    2x2 block (``nn.Upsample(scale_factor=2, mode='nearest')``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def uint8_from_tanh(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> [0, 255] uint8, truncating as the JAX package does."""
    return torch.clamp((img.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)
