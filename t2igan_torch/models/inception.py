"""Inception-v3 for FID features and the Inception Score.

Port of :mod:`t2igan.models.inception`.  ``variant="fid"`` is pytorch-fid's
patched network (``count_include_pad=False`` average pools in InceptionA,
InceptionC and the first InceptionE, a stride-1 max pool in the second
InceptionE, the 1008-way head); ``variant="torchvision"`` is the stock
torchvision model (1000-way head).  Inference only: BatchNorm (eps 1e-3)
always uses its running statistics.

Module and parameter names are torchvision's and pytorch-fid's, one module
per branch (``branch1x1``, ``branch5x5_1``, ...), so their state dicts load
with ``load_state_dict``; :func:`t2igan_torch.models.convert.load_jax_inception`
splits the JAX package's fused 1x1 convs into these branches.  Input and
spatial taps are NHWC at the edges, as in the JAX package; inside, maps are
NCHW in channels-last memory.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

FID_CLASSES = 1008
TORCHVISION_CLASSES = 1000


class BasicConv2d(nn.Module):
    """conv (no bias), BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3x3(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    """3x3 stride-1 average pool, pad 1; ``count_include_pad=False``
    divides by the window's size inside the image (the TF-FID patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1,
                        count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int, fid: bool):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3x3(x, not self.fid))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int, fid: bool):
        super().__init__()
        self.fid = fid
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool3x3(x, not self.fid))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool``: "avg" (torchvision), "avg_nocount" (FID, first E) or
    "max" (FID, second E: 3x3 stride-1 max pool, pad 1)."""

    def __init__(self, in_channels: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool3x3(x, self.pool == "avg")
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """Inception-v3 trunk with the FID feature taps.

    ``forward(x)`` takes an NHWC batch already resized to 299 and scaled
    to [-1, 1] (:func:`preprocess`) and returns ``pool1`` [B, h, w, 64],
    ``pool2`` [B, h, w, 192], ``mixed6e`` [B, h, w, 768] (NHWC views),
    ``pool3`` [B, 2048] and ``logits``.
    """

    def __init__(self, variant: str = "fid"):
        super().__init__()
        if variant not in ("fid", "torchvision"):
            raise ValueError(f"unknown Inception variant {variant!r}")
        fid = variant == "fid"
        self.variant = variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_nocount" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg")
        self.fc = nn.Linear(2048, FID_CLASSES if fid else TORCHVISION_CLASSES)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        out = {}
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        out["pool1"] = nhwc(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        out["pool2"] = nhwc(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        out["mixed6e"] = nhwc(x)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))
        out["pool3"] = pooled
        out["logits"] = self.fc(pooled)
        return out


def preprocess(x01: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[0, 1] NHWC -> bilinear resize to ``size`` (torch's kernel:
    ``align_corners=False``, no antialias) -> [-1, 1], NHWC."""
    x = F.interpolate(x01.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=False)
    return (2.0 * x - 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def init_inception_(model: InceptionV3,
                    generator: torch.Generator) -> InceptionV3:
    """Random weights from ``generator`` (no FID weights ship with the
    repository): He-normal conv kernels (fan in, ReLU gain), so the
    activations keep their scale through the trunk; BN scale 1, shift 0,
    running mean 0, variance 1; a normal fc."""
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            nn.init.kaiming_normal_(module.weight, nonlinearity="relu",
                                    generator=generator)
        elif isinstance(module, nn.BatchNorm2d):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        elif isinstance(module, nn.Linear):
            nn.init.normal_(module.weight, 0.0, 2048 ** -0.5,
                            generator=generator)
            nn.init.zeros_(module.bias)
    return model
