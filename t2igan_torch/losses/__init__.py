"""Losses of the adversarial and DAMSM steps: GAN, DAMSM and NT-Xent (port
of :mod:`t2igan.losses`)."""

from t2igan_torch.losses.damsm import (attention_match_scores, kl_loss,
                                       sent_loss, strip_special_tokens,
                                       words_loss)
from t2igan_torch.losses.gan import (bce_with_logits, discriminator_loss,
                                     generator_adv_loss, wrong_pair)
from t2igan_torch.losses.ntxent import nt_xent_loss

__all__ = [
    "sent_loss", "words_loss", "attention_match_scores", "kl_loss",
    "strip_special_tokens",
    "discriminator_loss", "generator_adv_loss", "bce_with_logits",
    "wrong_pair", "nt_xent_loss",
]
