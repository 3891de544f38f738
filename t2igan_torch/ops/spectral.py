"""Spectral normalisation of the discriminators' convolutions (port of
:mod:`t2igan.ops.spectral`).

Every forward runs one power iteration from the stored ``u`` with the
weight detached, ``v = l2n(W^T u)``, ``u = l2n(W v)``, and divides the
weight by ``sigma = u . W v``, with the gradient flowing through ``W``.
The new ``u`` and ``v`` are stored only when the caller passes
``update=True``: the JAX step stores them once per discriminator update,
in the trunk apply over ``[real, fake1, fake2]``, and never in the heads
or in the generator's loss.  ``torch.nn.utils.spectral_norm`` would store
them on every train-mode forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class SNConv(nn.Module):
    """Conv2d (NCHW) with a spectrally normalised weight.

    ``weight`` is [out, in, kh, kw]; ``u`` is [out] and ``v`` is
    [kh * kw * in], flattened in the JAX kernel's (kh, kw, in) order so
    that the stored vectors equal the JAX package's ``spectral``
    collection.  sigma and the power iteration run in f32, outside any
    autocast region; the convolution runs in the caller's precision.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.empty(features))
        self.register_buffer("v", torch.empty(kernel_size * kernel_size
                                              * in_features))

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        with torch.autocast(self.weight.device.type, enabled=False):
            w2d = self.weight.permute(0, 2, 3, 1).reshape(
                self.weight.shape[0], -1)
            with torch.no_grad():
                v = l2normalize(w2d.T @ self.u)
                u = l2normalize(w2d @ v)
                if update:
                    self.u.copy_(u)
                    self.v.copy_(v)
            weight = self.weight / torch.dot(u, w2d @ v)
        return F.conv2d(x, weight, self.bias, self.stride, self.padding)
