"""DAMSM losses (port of :mod:`t2igan.losses.damsm`): sentence-image and
word-region matching, the conditioning-augmentation KL, and the removal of
<sos>/<eos> from CLIP word states for the DAMSM step.  Everything is
computed in f32.  As in the JAX package, padded words are left out of the
per-patch softmax but their region-context terms still enter R(Q, D)'s
log-sum-exp."""

from __future__ import annotations

from typing import Optional

import torch

from t2igan_torch.ops.attention import l2_normalize
from t2igan_torch.ops.kernels.memory_read import NEG_INF


def _class_mask(class_ids: torch.Tensor) -> torch.Tensor:
    """[B, B] bool: True where (i, j) share a class but are not the same
    sample; those pairs are no negatives."""
    same = class_ids[:, None] == class_ids[None, :]
    eye = torch.eye(class_ids.shape[0], dtype=torch.bool,
                    device=class_ids.device)
    return same & ~eye


def _cross_entropy_rows(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with labels ``arange(B)``."""
    return -torch.mean(torch.diagonal(torch.log_softmax(logits, dim=-1)))


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
              class_ids: Optional[torch.Tensor], gamma3: float,
              eps: float = 1e-8):
    """(image -> text, text -> image) cross entropies of the cosine scores
    ``gamma3 * cos(cnn_i, rnn_j)``, same-class pairs masked to -1e9."""
    cnn, rnn = cnn_code.float(), rnn_code.float()
    cnn_norm = torch.linalg.vector_norm(cnn, dim=-1, keepdim=True)
    rnn_norm = torch.linalg.vector_norm(rnn, dim=-1, keepdim=True)
    scores = cnn @ rnn.T
    scores = scores / torch.clamp(cnn_norm * rnn_norm.T, min=eps) * gamma3
    if class_ids is not None:
        scores = scores.masked_fill(_class_mask(class_ids), NEG_INF)
    return _cross_entropy_rows(scores), _cross_entropy_rows(scores.T)


def attention_match_scores(words: torch.Tensor, regions: torch.Tensor,
                           word_mask: Optional[torch.Tensor],
                           gamma1: float, gamma2: float,
                           cosine_eps: float = 1e-6) -> torch.Tensor:
    """R(Q, D) for every (text i, image j): words [B, L, D], regions
    [B, P, D], word_mask [B, L] bool (True = real token) or None.  Returns
    [B, B], rows = texts."""
    wn = l2_normalize(words.float())
    rn = l2_normalize(regions.float())
    sim = torch.einsum("jpd,ild->ijpl", rn, wn)
    if word_mask is not None:
        sim = sim.masked_fill(~word_mask[:, None, None, :], NEG_INF)
    sm = torch.softmax(sim, dim=-1)                       # over words
    attn = torch.softmax(gamma1 * sm, dim=2)              # over patches
    rc = torch.einsum("ijpl,jpd->ijld", attn, rn)
    num = torch.einsum("ijld,ild->ijl", rc, wn)
    rc_n = torch.linalg.vector_norm(rc, dim=-1)
    wn_n = torch.linalg.vector_norm(wn, dim=-1)
    cos = num / torch.clamp(rc_n * wn_n[:, None, :], min=cosine_eps)
    return torch.logsumexp(gamma2 * cos, dim=-1) / gamma2


def words_loss(regions: torch.Tensor, words: torch.Tensor,
               class_ids: Optional[torch.Tensor],
               word_mask: Optional[torch.Tensor],
               gamma1: float, gamma2: float, gamma3: float):
    """(text -> image, image -> text) cross entropies of
    ``gamma3 * R(Q, D)``, same-class pairs masked to -1e9."""
    sims = attention_match_scores(words, regions, word_mask, gamma1,
                                  gamma2) * gamma3
    if class_ids is not None:
        sims = sims.masked_fill(_class_mask(class_ids), NEG_INF)
    return _cross_entropy_rows(sims), _cross_entropy_rows(sims.T)


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """``-0.5 * mean(1 + logvar - mu^2 - exp(logvar))``."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.mean(1.0 + logvar - mu * mu - torch.exp(logvar))


def strip_special_tokens(words: torch.Tensor, mask: torch.Tensor):
    """Drop the <sos> and <eos> slots from CLIP word states, as one static
    gather: words [B, L, D] and mask [B, L] (1 = real token, <sos> and
    <eos> included) -> (words [B, L-2, D], mask [B, L-2] bool).

    The <eos> slot is ``clip(n_real - 1, 1, L - 1)``; output j takes input
    j+1 before it and j+2 after it, so a caption [sos, w1..wk, eos, pad...]
    becomes [w1..wk, pad...] with k mask ones, and one that fills the
    window loses its first and last slots."""
    b, l, d = words.shape
    mask = mask.to(torch.int64)
    eos = torch.clamp(mask.sum(dim=-1) - 1, 1, l - 1)
    j = torch.arange(l - 2, device=words.device)[None, :]
    idx = torch.where(j + 1 < eos[:, None], j + 1, j + 2)
    out = torch.gather(words, 1, idx[:, :, None].expand(b, l - 2, d))
    return out, torch.gather(mask, 1, idx).bool()
