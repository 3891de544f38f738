"""CLIP R-precision: rank each generated image's true caption against 99
captions of other classes (port of :mod:`t2igan.evaluation.rprecision`).

A hit is an image whose true caption scores highest; R is the share of
hits, reported as a bootstrap mean and spread over 10 groups of 3000 (the
reference's 30,000 queries).  A whole batch ranks against its [B, 100]
candidate sets in one pass: the image tower once, the true captions once,
and the B·99 mis-captions as one text batch, as in the JAX package.

The mis-caption encode is most of the sweep's work: at batch B it runs
B·100 captions of ``WORDS_NUM`` tokens through the text tower.  Sentence
codes are not kept across batches, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from t2igan_torch.models.clip import ClipWithRegionHead
from t2igan_torch.utils.profiling import span


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


def make_rank_fn(clip: ClipWithRegionHead
                 ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``rank(images, ids_true, mask_true, ids_mis, mask_mis) -> (hits,
    scores)``: ``images`` [B, S, S, 3] are the generator's [-1, 1] output
    resized to the CLIP input size (not CLIP-normalised, as in the JAX
    package), the true ids/mask [B, W], the mis ids/mask [B, n_mis, W], as
    arrays or tensors.  The image code and the sentence codes are
    l2-normalised (norm clipped at 1e-8) and dotted in f32: ``scores``
    [B, 1 + n_mis] with the true caption first, ``hits`` [B] bool where
    the argmax is 0.  Runs under ``torch.inference_mode()`` on ``clip``'s
    device and dtype.  Under a profiler a call shows three spans: the
    inputs moved to the device (``t2igan.rank.put``; the mis-captions
    arrive as host arrays), the image tower (``t2igan.rank.image``) and
    both text-tower calls (``t2igan.rank.text``)."""
    weight = clip.text_projection.weight

    def rank(images, ids_true, mask_true, ids_mis, mask_mis):
        dev, dtype = weight.device, weight.dtype

        def put(x):
            return torch.as_tensor(x, device=dev)

        with torch.inference_mode():
            with span("t2igan.rank.put"):
                images = put(images)
                ids_true, mask_true = put(ids_true), put(mask_true)
                ids_mis, mask_mis = put(ids_mis), put(mask_mis)
            b, n_mis, w = ids_mis.shape
            with span("t2igan.rank.image"):
                _, img_code = clip.encode_image_verbose(images.to(dtype))
            with span("t2igan.rank.text"):
                _, sent_true = clip.encode_text_verbose(ids_true, mask_true)
                _, sent_mis = clip.encode_text_verbose(
                    ids_mis.reshape(b * n_mis, w),
                    mask_mis.reshape(b * n_mis, w))
            cands = torch.cat([sent_true[:, None, :],
                               sent_mis.reshape(b, n_mis, -1)], dim=1)
            scores = torch.einsum("bd,bnd->bn", _unit(img_code.float()),
                                  _unit(cands.float()))
            return scores.argmax(dim=-1) == 0, scores

    return rank


class MisCaptionBank:
    """Every caption of a split tokenized once; per query, 99 other-class
    captions drawn with replacement from that class's complement (the
    distribution of the reference's rejection loop) by a
    ``numpy.random.default_rng(seed)`` stream, as in the JAX package."""

    def __init__(self, dataset, tokenizer, words_num: int, seed: int = 100):
        caps, cls = dataset.caption_bank()
        out = tokenizer(caps, max_length=words_num)
        self.ids = np.asarray(out["input_ids"], np.int32)      # [N, W]
        self.mask = np.asarray(out["attention_mask"], np.int32)
        self.cls = np.asarray(cls, np.int64)                   # [N]
        self.words_num = words_num
        self._complement: dict = {}
        self._rng = np.random.default_rng(seed)

    def _comp(self, cls_id: int) -> np.ndarray:
        comp = self._complement.get(cls_id)
        if comp is None:
            comp = np.flatnonzero(self.cls != cls_id)
            self._complement[cls_id] = comp
        return comp

    def sample(self, class_ids, n_mis: int = 99):
        """(ids [B, n_mis, W], mask [B, n_mis, W]) of other-class
        captions."""
        rows = np.empty((len(class_ids), n_mis), np.int64)
        for i, cls in enumerate(class_ids):
            comp = self._comp(int(cls))
            if len(comp) == 0:
                raise ValueError(
                    f"no mis-captions available: every caption in the split "
                    f"belongs to class {int(cls)} (single-class split?); "
                    "R-precision needs at least one other-class caption")
            rows[i] = comp[self._rng.integers(0, len(comp), n_mis)]
        return self.ids[rows], self.mask[rows]


def bootstrap_r_precision(hits: np.ndarray, n_groups: int = 10,
                          group_size: int = 3000,
                          seed: int = 0) -> Tuple[float, float]:
    """Shuffle the hits and average them in ``n_groups`` groups of
    ``group_size`` (fewer rows each when there are not enough); returns
    the mean and the spread of the group means."""
    r = np.asarray(hits, dtype=np.float64).copy()
    np.random.default_rng(seed).shuffle(r)
    n_groups = max(1, min(n_groups, r.size))
    total = n_groups * group_size
    if r.size < total:
        group_size = max(1, r.size // n_groups)
        total = n_groups * group_size
    means = r[:total].reshape(n_groups, group_size).mean(axis=1)
    return float(means.mean()), float(means.std())
