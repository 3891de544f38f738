"""The AttnGAN-heritage encoders of the pre-CLIP path (port of
:mod:`t2igan.models.legacy`).

* :class:`RnnEncoder`: the reference's ``RNN_ENCODER``, a bidirectional
  LSTM or GRU over a word-index vocabulary, under its parameter names
  (``encoder.weight``, ``rnn.weight_ih_l0``, ``rnn.weight_ih_l0_reverse``,
  ...), so a reference ``text_encoder*.pth`` loads with
  ``load_state_dict``;
* :class:`CnnEncoder`: the Inception-v3 DAMSM image encoder, the port's
  torchvision-variant trunk with its ``mixed6e`` and ``pool3`` taps
  detached, then the trainable heads ``emb_features`` (1x1 conv) and
  ``emb_cnn_code`` (linear);
* :class:`GlobalAttentionText`: the text-side attention readout.

:mod:`t2igan_torch.models.convert` fills them from the JAX package's
variables (``load_jax_rnn_encoder``, ``load_jax_cnn_encoder``,
``load_jax_global_attention_text``).  The JAX package runs the recurrence
as ``flax`` scans and the reads as einsums, none of them a Pallas kernel;
here they are ``nn.LSTM``/``nn.GRU`` and ``torch.einsum``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from t2igan_torch.models.inception import InceptionV3
from t2igan_torch.ops.kernels.memory_read import NEG_INF

RNN_TYPES = ("LSTM", "GRU")


class RnnEncoder(nn.Module):
    """Bidirectional LSTM/GRU text encoder: ``forward(captions [B, T] int,
    cap_lens [B], train=False)`` returns (words [B, T, nhidden], sent
    [B, nhidden]), each direction ``nhidden / 2`` wide.

    Each row is read within its length: the backward direction starts at
    the row's last word (a packed sequence), word states past the length
    are 0, and ``sent`` joins the forward state after the last word to the
    backward state after the first, as the reference's final hidden state
    and the JAX encoder's scans give them.  A row of length 0 takes the
    JAX encoder's value: zero word states, and ``sent`` the forward state
    after the first token joined to the backward state over the whole row.
    ``train`` applies dropout ``drop_prob`` to the embeddings."""

    def __init__(self, ntoken: int, ninput: int = 300, nhidden: int = 128,
                 rnn_type: str = "LSTM", drop_prob: float = 0.5):
        super().__init__()
        if rnn_type not in RNN_TYPES:
            raise ValueError(f"unsupported rnn_type {rnn_type!r}; expected "
                             f"one of {RNN_TYPES}")
        self.rnn_type = rnn_type
        self.drop_prob = drop_prob
        self.encoder = nn.Embedding(ntoken, ninput)
        rnn = nn.LSTM if rnn_type == "LSTM" else nn.GRU
        self.rnn = rnn(ninput, nhidden // 2, 1, batch_first=True,
                       bidirectional=True)

    def _run(self, emb: torch.Tensor, lens: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(words, sent) of ``emb`` read within ``lens`` (CPU, all >= 1)."""
        packed = pack_padded_sequence(emb, lens, batch_first=True,
                                      enforce_sorted=False)
        out, hidden = self.rnn(packed)
        words, _ = pad_packed_sequence(out, batch_first=True,
                                       total_length=emb.shape[1])
        h = hidden[0] if self.rnn_type == "LSTM" else hidden
        return words, torch.cat([h[0], h[1]], dim=-1)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                train: bool = False):
        emb = F.dropout(self.encoder(captions), self.drop_prob,
                        training=train)
        t = captions.shape[1]
        lens = torch.as_tensor(cap_lens).to("cpu", torch.int64)
        words, sent = self._run(emb, lens.clamp(min=1))
        empty = lens == 0
        if empty.any():
            half = sent.shape[-1] // 2
            _, full = self._run(emb[empty.to(emb.device)],
                                torch.full((int(empty.sum()),), t))
            sent = sent.clone()
            sent[empty.to(sent.device), half:] = full[:, half:]
            words = words * (lens > 0).to(words.device, words.dtype)[:, None,
                                                                      None]
        return words, sent


class CnnEncoder(nn.Module):
    """Inception-v3 DAMSM image encoder: ``forward(images [B, 299, 299, 3])``
    (already resized and scaled for Inception) returns (region features
    [B, 17, 17, nef], global code [B, nef]): the ``mixed6e`` tap through
    ``emb_features`` (1x1 conv, no bias) and the pooled 2048 through
    ``emb_cnn_code`` (linear).  The trunk runs without gradient and stays
    in eval mode: only the heads train, as the JAX encoder stops
    gradients at the taps."""

    def __init__(self, nef: int = 256):
        super().__init__()
        self.inception = InceptionV3(variant="torchvision")
        self.emb_features = nn.Conv2d(768, nef, 1, bias=False)
        self.emb_cnn_code = nn.Linear(2048, nef)

    def train(self, mode: bool = True) -> "CnnEncoder":
        super().train(mode)
        self.inception.eval()
        return self

    def forward(self, images: torch.Tensor):
        with torch.no_grad():
            out = self.inception(images)
        features = self.emb_features(out["mixed6e"].permute(0, 3, 1, 2))
        return features.permute(0, 2, 3, 1), self.emb_cnn_code(out["pool3"])


class GlobalAttentionText(nn.Module):
    """Text-side attention: ``forward(input_map [B, H, W, idf], context
    [B, L, cdf], pad_mask [B, L] bool, True at padding, or None)`` returns
    [B, L, idf], each word's image features weighted by a softmax over the
    pixels of their products with the word's projected context
    (``conv_context``); padded words get -1e9 before it."""

    def __init__(self, idf: int, cdf: int):
        super().__init__()
        self.conv_context = nn.Linear(cdf, idf)

    def forward(self, input_map: torch.Tensor, context: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, c = input_map.shape
        source = self.conv_context(context)                   # [B, L, idf]
        target = input_map.reshape(b, h * w, c)
        attn = torch.einsum("bqc,blc->bql", target, source)
        if pad_mask is not None:
            attn = attn.masked_fill(pad_mask[:, None, :], NEG_INF)
        attn = torch.softmax(attn, dim=1)                     # over pixels
        return torch.einsum("bqc,bql->blc", target, attn)
