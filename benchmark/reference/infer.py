"""The plain reference of the sampler and of the R-precision rank function.

Copied, frozen, from the port at commit c2e05f1: ``t2igan_torch/train/
steps.py::make_sampler`` (the text tower, then the generator in eval mode
with the plain stage tail) and ``evaluation/rprecision.py::make_rank_fn``
(image code and sentence codes l2-normalised with the norm clipped at
1e-8, dotted in f32, the true caption first).  Rows are computed in
blocks, so that the reference fits beside what the run kept.  It imports
nothing of the port.
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.reference.nets import Numerics

BLOCK = 16  # rows a block


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


@torch.no_grad()
def sample(clip, gen, ids, mask, z, eps, n: Numerics) -> List[torch.Tensor]:
    """Each pyramid size's images [B, s, s, 3] in [-1, 1], f32."""
    parts = []
    for r in range(0, ids.shape[0], BLOCK):
        s = slice(r, r + BLOCK)
        words, sent = clip.encode_text(ids[s], mask[s], n)
        imgs, _, _ = gen(z[s], sent, words, mask[s] == 0, eps[s], False, n)
        parts.append(imgs)
    return [torch.cat(p) for p in zip(*parts)]


@torch.no_grad()
def rank_scores(clip, images, ids_true, mask_true, ids_mis, mask_mis,
                n: Numerics) -> torch.Tensor:
    """scores [B, 1 + n_mis], the true caption first."""
    b, n_mis, w = ids_mis.shape
    _, img = clip.encode_image(images, n)
    _, true = clip.encode_text(ids_true, mask_true, n)
    flat_ids = ids_mis.reshape(b * n_mis, w)
    flat_mask = mask_mis.reshape(b * n_mis, w)
    mis = torch.cat([clip.encode_text(flat_ids[r:r + 8 * BLOCK],
                                      flat_mask[r:r + 8 * BLOCK], n)[1]
                     for r in range(0, b * n_mis, 8 * BLOCK)])
    cands = torch.cat([true[:, None], mis.reshape(b, n_mis, -1)], dim=1)
    return torch.einsum("bd,bnd->bn", _unit(img.float()), _unit(cands.float()))
