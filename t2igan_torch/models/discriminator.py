"""Per-scale spectral-norm discriminators for 64/128/256 px images (port of
:mod:`t2igan.models.discriminator`).

The modules take and return the JAX package's NHWC layout at their edges
(images [B, S, S, 3] in, feature codes [B, 4, 4, 8ndf] out) and run
channels-last NCHW inside.  The heads emit logits; the sigmoid lives in
:func:`t2igan_torch.losses.gan.bce_with_logits`.  Only the trunk's
spectral-norm vectors are ever stored, and only with
``features(x, update_spectral=True)`` (:mod:`t2igan_torch.ops.spectral`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from t2igan_torch.ops.spectral import SNConv, l2normalize


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class DownBlock(nn.Module):
    """SN conv4x4 stride 2 + LeakyReLU(0.2)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = SNConv(in_features, features, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        return leaky(self.conv(x, update))


class Block3x3Leaky(nn.Module):
    """SN conv3x3 stride 1 + LeakyReLU(0.2)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = SNConv(in_features, features, 3, stride=1, padding=1)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        return leaky(self.conv(x, update))


class Encode16x(nn.Module):
    """Downsample 16x: 3 -> ndf -> 2ndf -> 4ndf -> 8ndf."""

    def __init__(self, ndf: int):
        super().__init__()
        chans = [3, ndf, 2 * ndf, 4 * ndf, 8 * ndf]
        self.blocks = nn.ModuleList(DownBlock(a, b)
                                    for a, b in zip(chans, chans[1:]))

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, update)
        return x


class DGetLogits(nn.Module):
    """Head on a [B, 8ndf, 4, 4] code: with ``bcondition`` the sentence
    embedding is tiled over the 4x4 grid and joined by an SN conv3x3; then
    a plain 4x4 stride-4 conv to one logit per image."""

    def __init__(self, ndf: int, nef: int, bcondition: bool = False):
        super().__init__()
        self.nef = nef
        self.joint = Block3x3Leaky(8 * ndf + nef, 8 * ndf) if bcondition \
            else None
        self.conv = nn.Conv2d(8 * ndf, 1, 4, stride=4)

    def forward(self, h_code: torch.Tensor,
                c_code: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h_code NCHW [B, 8ndf, 4, 4]; c_code [B, nef].  Returns [B]."""
        if self.joint is not None and c_code is not None:
            b = h_code.shape[0]
            c = c_code.to(h_code.dtype)[:, :, None, None].expand(
                b, self.nef, 4, 4)
            h_code = self.joint(torch.cat([h_code, c], dim=1))
        return self.conv(h_code).reshape(-1)


class DNet(nn.Module):
    """Per-scale trunk: ``img_size`` 64, 128 or 256 selects the
    reference's D_NET64/128/256."""

    def __init__(self, ndf: int, img_size: int = 64):
        super().__init__()
        self.img_size = img_size
        self.encode = Encode16x(ndf)
        down, blocks = [], []
        if img_size >= 128:
            down.append(DownBlock(8 * ndf, 16 * ndf))
            if img_size == 128:
                blocks.append(Block3x3Leaky(16 * ndf, 8 * ndf))
        if img_size >= 256:
            down.append(DownBlock(16 * ndf, 32 * ndf))
            blocks += [Block3x3Leaky(32 * ndf, 16 * ndf),
                       Block3x3Leaky(16 * ndf, 8 * ndf)]
        self.down = nn.ModuleList(down)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        """x NHWC [B, S, S, 3] -> NCHW [B, 8ndf, 4, 4] (channels-last)."""
        if x.shape[1] != self.img_size or self.img_size < 64:
            raise ValueError(
                f"D_NET{self.img_size} got a {x.shape[1]}x{x.shape[2]} "
                f"image; the discriminator trunk downsamples 16x to a 4x4 "
                f"code, so inputs must be {max(self.img_size, 64)}^2")
        h = x.permute(0, 3, 1, 2)
        h = self.encode(h, update)
        for block in list(self.down) + list(self.blocks):
            h = block(h, update)
        return h


class DNetWithHeads(nn.Module):
    """Trunk plus conditional and (with ``b_jcu``) unconditional heads.
    ``features`` gives the NHWC code; ``cond`` and ``uncond`` take it."""

    def __init__(self, ndf: int, nef: int, img_size: int = 64,
                 b_jcu: bool = True):
        super().__init__()
        self.img_size = img_size
        self.trunk = DNet(ndf, img_size)
        self.cond_head = DGetLogits(ndf, nef, bcondition=True)
        self.uncond_head = DGetLogits(ndf, nef) if b_jcu else None

    def features(self, x: torch.Tensor,
                 update_spectral: bool = False) -> torch.Tensor:
        """x [B, S, S, 3] -> [B, 4, 4, 8ndf].  ``update_spectral`` stores
        the trunk's new ``u``/``v``."""
        return self.trunk(x, update_spectral).permute(0, 2, 3, 1)

    def cond(self, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return self.cond_head(h.permute(0, 3, 1, 2), c)

    def uncond(self, h: torch.Tensor) -> torch.Tensor:
        if self.uncond_head is None:
            raise ValueError("unconditional head disabled (b_jcu=False)")
        return self.uncond_head(h.permute(0, 3, 1, 2))


@torch.no_grad()
def init_discriminator_(model: nn.Module,
                        generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, with the JAX package's families:
    orthogonal kernels (over the flattened [out, kh * kw * in] matrix),
    zero biases, random unit ``u``/``v``."""
    for module in model.modules():
        if isinstance(module, (SNConv, nn.Conv2d)):
            w = module.weight
            flat = torch.empty(w.shape[0], w[0].numel())
            nn.init.orthogonal_(flat, generator=generator)
            w.copy_(flat.reshape(w.shape[0], *w.shape[2:], w.shape[1])
                    .permute(0, 3, 1, 2))
            nn.init.zeros_(module.bias)
        if isinstance(module, SNConv):
            for buf in (module.u, module.v):
                buf.copy_(l2normalize(torch.randn(buf.shape,
                                                  generator=generator)))
    return model
