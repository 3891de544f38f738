"""Random weights from the seed, made on the device in one draw, for the
program and the reference alike.

One standard-normal draw covers every entry of a state dict; each entry
takes its slice through a rule chosen by its name and shape:

* ``logit_scale``: log(1 / 0.07), CLIP's start;
* BN running statistics: mean ``0.1 n``, variance ``exp(0.2 n)``;
* spectral-norm vectors ``u``, ``v``: ``n / |n|``;
* embeddings: ``0.02 n``;
* one-dimensional ``weight`` (LayerNorm, BatchNorm scales): ``1 + 0.02 n``;
* ``bias``: ``0.02 n``;
* every other weight: ``n / sqrt(fan_in)``, the fan-in all but the output
  dimension (the last one for CLIP's patch kernel [p, p, C, D]).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _rule(name: str, shape: Tuple[int, ...], n: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "logit_scale":
        return torch.full_like(n, math.log(1.0 / 0.07))
    if leaf == "running_mean":
        return 0.1 * n
    if leaf == "running_var":
        return torch.exp(0.2 * n)
    if leaf in ("u", "v"):
        return n / torch.linalg.vector_norm(n)
    if "embedding" in name:
        return 0.02 * n
    if leaf == "weight" and len(shape) == 1:
        return 1.0 + 0.02 * n
    if leaf == "bias":
        return 0.02 * n
    fan_in = math.prod(shape[:-1] if leaf == "kernel" else shape[1:])
    return n / math.sqrt(fan_in)


def make(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """f32 tensors by name for ``(name, shape)`` pairs, from ``seed``."""
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        size = math.prod(shape)
        out[name] = _rule(name, tuple(shape), flat[at:at + size].view(shape))
        at += size
    return out


def state_shapes(module: torch.nn.Module, prefix: str = ""
                 ) -> Iterable[Tuple[str, Tuple[int, ...]]]:
    return [(prefix + k, tuple(v.shape))
            for k, v in module.state_dict().items()]
