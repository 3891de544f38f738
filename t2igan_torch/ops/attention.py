"""Attention primitives: word-region attention and the gated-memory read.

Port of :mod:`t2igan.ops.attention`, in the same ``[batch, length, dim]``
sequence layout and NHWC query maps, with the same mask conventions:
``masked_softmax`` fills with -1e9 (a fully masked row gives uniform
weights, not NaN) and ``memory_read``'s ``pad_mask`` is True at padding.
"""

from __future__ import annotations

from typing import Optional

import torch

from t2igan_torch.ops.kernels.memory_read import NEG_INF, MemoryRead


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-8) -> torch.Tensor:
    """``x / (sqrt(sum(x^2)) + eps)``: eps is added to the norm."""
    return x / (torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax with positions where ``mask`` (broadcast, True = keep) is
    False set to -1e9 first."""
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype,
                                          device=logits.device))
    return torch.softmax(logits, dim=dim)


def word_region_attention(words: torch.Tensor, regions: torch.Tensor,
                          word_mask: Optional[torch.Tensor], gamma1: float):
    """AttnGAN word->region attention (eq. 7-9).

    words [B, L, D], regions [B, P, D], word_mask [B, L] bool (True = real
    token) or None.  Returns (context [B, L, D] built from the l2-normalized
    regions, attn [B, P, L] per-patch attention over words).
    """
    wn = l2_normalize(words)
    rn = l2_normalize(regions)
    sim = torch.einsum("bpd,bld->bpl", rn.float(), wn.float())
    mask = None if word_mask is None else word_mask[:, None, :]
    attn = masked_softmax(sim, mask, dim=-1)
    attn2 = torch.softmax(gamma1 * attn, dim=1)  # over patches
    context = torch.einsum("bpl,bpd->bld", attn2, rn.float())
    return context, attn


def memory_read(query_map: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, pad_mask: Optional[torch.Tensor],
                return_attn: bool = True):
    """DM-GAN gated-memory read: each pixel attends over the memory slots.

    query_map [B, H, W, C]; key/value [B, L, C]; pad_mask [B, L] bool, True
    at padding, or None.  Returns (read [B, H, W, C] in ``query_map``'s
    dtype, attn [B, H, W, L] f32 or None).

    ``return_attn=False`` is the sampler's and the train step's path,
    :class:`MemoryRead`: on a CUDA tensor it launches the forward kernel
    (K1) and, for gradients to q, k and v, the backward kernel (K2); on a
    CPU tensor it runs their plain versions.  ``return_attn=True``
    (visualisation) computes the maps with plain einsums, as the JAX
    package does.
    """
    if not return_attn:
        return MemoryRead.apply(query_map, key, value, pad_mask), None
    b, h, w, c = query_map.shape
    q = query_map.reshape(b, h * w, c).float()
    logits = torch.einsum("bqc,blc->bql", q, key.float())
    keep = None if pad_mask is None else (~pad_mask)[:, None, :]
    attn = masked_softmax(logits, keep, dim=-1)
    read = torch.einsum("bql,blc->bqc", attn, value.float())
    return (read.reshape(b, h, w, c).to(query_map.dtype),
            attn.reshape(b, h, w, -1))
