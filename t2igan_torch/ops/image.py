"""Image helpers of the sampler and train paths (port of part of
:mod:`t2igan.ops.image`).  Feature maps are NCHW here, as PyTorch's
convolutions take them; images leave the generator as NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# CLIP's image normalisation (datasets.py:403-406).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW map: every pixel becomes a
    2x2 block (``nn.Upsample(scale_factor=2, mode='nearest')``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def uint8_from_tanh(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> [0, 255] uint8, truncating as the JAX package does."""
    return torch.clamp((img.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)


def resize_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of an NHWC batch to (size, size): the source pixel of
    output i is ``floor((i + 0.5) * in / out)``, as ``jax.image.resize``
    takes it, which is torch's ``"nearest-exact"`` (its ``"nearest"``
    floors ``i * in / out`` and picks other rows)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)
