"""The dataset variant that yields CLIP BPE ids instead of caption text: the
port's copy of :mod:`t2igan.data.clip_dataset` (the reference's
``CLIPTextDataset``, datasets.py:119-392).  One caption per sample is
tokenised and padded, or order-keeping subsampled, to ``TEXT.WORDS_NUM``
(datasets.py:316-335)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from t2igan_torch.config import Config
from t2igan_torch.data.dataset import TextImageDataset
from t2igan_torch.data.tokenizer import ClipTokenizer


@dataclass
class TokenRecord:
    images: List[np.ndarray]
    input_ids: np.ndarray      # [W] int32, padded
    attention_mask: np.ndarray
    cap_len: int
    class_id: int
    key: str


class ClipTokenDataset(TextImageDataset):
    """TextImageDataset variant yielding pre-tokenized captions."""

    def __init__(self, cfg: Config, split: str = "train",
                 tokenizer: Optional[ClipTokenizer] = None, seed: int = 0):
        super().__init__(cfg, split, seed)
        self.tokenizer = tokenizer or ClipTokenizer.load(cfg.DATA_DIR or None)
        self.words_num = cfg.TEXT.WORDS_NUM

    def _tokenized(self, sent_ix: int):
        ids = self.tokenizer.encode(self.caption_text(sent_ix))
        w = self.words_num
        if len(ids) > w:
            # random subsample keeping order, like datasets.py:328-333
            keep = np.sort(self.rng.choice(len(ids), w, replace=False))
            ids = [ids[i] for i in keep]
        out = np.full((w,), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((w,), np.int32)
        out[:len(ids)] = ids
        mask[:len(ids)] = 1
        return out, mask, len(ids)

    def __getitem__(self, index: int) -> TokenRecord:
        base = super().__getitem__(index)
        sent_ix = int(self.rng.integers(0, self.embeddings_num))
        ids, mask, n = self._tokenized(index * self.embeddings_num + sent_ix)
        return TokenRecord(images=base.images, input_ids=ids,
                           attention_mask=mask, cap_len=n,
                           class_id=base.class_id, key=base.key)
