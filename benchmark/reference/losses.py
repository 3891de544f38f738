"""The plain reference of the adversarial step's losses, in f32.

Copied, frozen, from the port at commit c2e05f1: ``t2igan_torch/losses/
damsm.py`` (``sent_loss``, ``attention_match_scores``, ``words_loss``,
``kl_loss``), ``losses/gan.py`` and ``losses/ntxent.py``.  It imports
nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nets import NEG_INF, l2_normalize


def _class_mask(cls):
    same = cls[:, None] == cls[None, :]
    return same & ~torch.eye(cls.shape[0], dtype=torch.bool,
                             device=cls.device)


def _ce_rows(logits):
    return -torch.mean(torch.diagonal(torch.log_softmax(logits, dim=-1)))


def sent_loss(cnn, rnn, cls, gamma3, eps=1e-8):
    cnn, rnn = cnn.float(), rnn.float()
    norm = (torch.linalg.vector_norm(cnn, dim=-1, keepdim=True)
            * torch.linalg.vector_norm(rnn, dim=-1, keepdim=True).T)
    scores = cnn @ rnn.T / torch.clamp(norm, min=eps) * gamma3
    scores = scores.masked_fill(_class_mask(cls), NEG_INF)
    return _ce_rows(scores), _ce_rows(scores.T)


def words_loss(regions, words, cls, word_mask, g1, g2, g3, eps=1e-6):
    wn = l2_normalize(words.float())
    rn = l2_normalize(regions.float())
    sim = torch.einsum("jpd,ild->ijpl", rn, wn)
    sim = sim.masked_fill(~word_mask[:, None, None, :], NEG_INF)
    attn = torch.softmax(g1 * torch.softmax(sim, dim=-1), dim=2)
    rc = torch.einsum("ijpl,jpd->ijld", attn, rn)
    num = torch.einsum("ijld,ild->ijl", rc, wn)
    cos = num / torch.clamp(torch.linalg.vector_norm(rc, dim=-1)
                            * torch.linalg.vector_norm(wn, dim=-1)[:, None],
                            min=eps)
    sims = torch.logsumexp(g2 * cos, dim=-1) / g2 * g3
    sims = sims.masked_fill(_class_mask(cls), NEG_INF)
    return _ce_rows(sims), _ce_rows(sims.T)


def kl_loss(mu, logvar):
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.mean(1.0 + logvar - mu * mu - torch.exp(logvar))


def bce(logits, target: float):
    logits = logits.float()
    return -torch.mean(F.logsigmoid(logits if target == 1.0 else -logits))


def d_loss(cond_real, cond_fake, cond_wrong, uncond_real, uncond_fake):
    return ((bce(uncond_real, 1.0) + bce(cond_real, 1.0)) / 2.0
            + (bce(uncond_fake, 0.0) + bce(cond_fake, 0.0)
               + bce(cond_wrong, 0.0)) / 3.0)


def nt_xent(z_i, z_j, t=0.5):
    b = z_i.shape[0]
    z = torch.cat([z_i, z_j]).float()
    zn = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                         min=1e-8)
    sim = zn @ zn.T / t
    n = 2 * b
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    rows = torch.arange(n, device=z.device)
    return torch.mean(torch.logsumexp(sim.masked_fill(eye, NEG_INF), -1)
                      - sim[rows, (rows + b) % n])
