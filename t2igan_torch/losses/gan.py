"""Adversarial losses on discriminator logits (port of
:mod:`t2igan.losses.gan`): the heads emit logits and the losses take the
sigmoid inside a log-sigmoid, and the wrong-pair term rolls the sentence
embeddings by one instead of slicing."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross entropy against a constant 0/1 target, in f32."""
    logits = logits.float()
    if target == 1.0:
        return -torch.mean(F.logsigmoid(logits))
    if target == 0.0:
        return -torch.mean(F.logsigmoid(-logits))
    return -torch.mean(target * F.logsigmoid(logits)
                       + (1.0 - target) * F.logsigmoid(-logits))


def discriminator_loss(cond_real: torch.Tensor, cond_fake: torch.Tensor,
                       cond_wrong: torch.Tensor,
                       uncond_real: Optional[torch.Tensor],
                       uncond_fake: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """With an unconditional head ``(real + cond_real) / 2 + (fake +
    cond_fake + cond_wrong) / 3``, without ``cond_real + (cond_fake +
    cond_wrong) / 2``.  Also returns ``real_acc`` and ``fake_acc``, the
    mean sigmoid of the (unconditional, else conditional) logits."""
    cond_real_err = bce_with_logits(cond_real, 1.0)
    cond_fake_err = bce_with_logits(cond_fake, 0.0)
    cond_wrong_err = bce_with_logits(cond_wrong, 0.0)
    if uncond_real is not None:
        loss = ((bce_with_logits(uncond_real, 1.0) + cond_real_err) / 2.0
                + (bce_with_logits(uncond_fake, 0.0) + cond_fake_err
                   + cond_wrong_err) / 3.0)
        real, fake = uncond_real, uncond_fake
    else:
        loss = cond_real_err + (cond_fake_err + cond_wrong_err) / 2.0
        real, fake = cond_real, cond_fake
    aux = {"real_acc": torch.sigmoid(real.float()).mean(),
           "fake_acc": torch.sigmoid(fake.float()).mean()}
    return loss, aux


def generator_adv_loss(cond_logits: torch.Tensor,
                       uncond_logits: Optional[torch.Tensor]) -> torch.Tensor:
    """Conditional (+ unconditional) BCE against the real label."""
    loss = bce_with_logits(cond_logits, 1.0)
    if uncond_logits is not None:
        loss = loss + bce_with_logits(uncond_logits, 1.0)
    return loss


def wrong_pair(conditions: torch.Tensor) -> torch.Tensor:
    """Sample i paired with sentence i + 1: a roll by -1 on the batch."""
    return torch.roll(conditions, shifts=-1, dims=0)
