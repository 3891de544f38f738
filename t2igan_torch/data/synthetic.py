"""Synthetic dataset, deterministic per (seed, index): the records of
``t2igan.data.synthetic`` (the same images, captions and class ids for a
seed) with the port's own :class:`Record`.  It stands in for CUB/COCO
wherever no data is on disk, as in the JAX package, with the same
mis-caption draws for R-precision (:meth:`SyntheticDataset.mis_captions`,
:meth:`SyntheticDataset.caption_bank`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from t2igan_torch.config import Config

_COLORS = ["red", "blue", "yellow", "green", "black", "white"]
_PARTS = ["wings", "beak", "crown", "tail", "breast", "belly"]


@dataclass
class Record:
    """One sample: a multi-scale image pyramid and two captions."""

    images: List[np.ndarray]        # per-branch [s, s, 3] float32
    caption: str
    caption_2: str
    class_id: int
    key: str


class SyntheticDataset:
    def __init__(self, cfg: Config, size: int = 64, n_classes: int = 8,
                 seed: int = 0):
        self.cfg = cfg
        self.sizes = cfg.branch_sizes
        self.n = size
        self.n_classes = n_classes
        self.seed = seed
        self.class_id = np.arange(size) % n_classes
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def _caption(self, rng) -> str:
        c1, c2 = rng.choice(_COLORS, 2, replace=True)
        p1, p2 = rng.choice(_PARTS, 2, replace=False)
        return f"a bird with {c1} {p1} and {c2} {p2}"

    def __getitem__(self, index: int) -> Record:
        rng = np.random.default_rng((self.seed, index))
        images: List[np.ndarray] = [
            rng.standard_normal((s, s, 3)).astype(np.float32) * 0.5
            for s in self.sizes
        ]
        return Record(images=images,
                      caption=self._caption(rng),
                      caption_2=self._caption(rng),
                      class_id=int(self.class_id[index]),
                      key=f"synthetic/{index:06d}")

    def mis_captions(self, cls_id: int, n: int = 99) -> List[str]:
        """``n`` captions of other classes, drawn from the dataset's own
        generator (so each call continues the last one's stream)."""
        out = []
        while len(out) < n:
            idx = int(self.rng.integers(0, self.n))
            if self.class_id[idx] == cls_id:
                continue
            rng = np.random.default_rng((self.seed, idx, 1))
            out.append(self._caption(rng))
        return out

    def caption_bank(self):
        """One caption per sample with its class id (the draw of
        :meth:`mis_captions`), for the tokenized mis-caption pool."""
        caps = [self._caption(np.random.default_rng((self.seed, i, 1)))
                for i in range(self.n)]
        return caps, self.class_id.astype(np.int64)


def bench_train_batches(batch: int, eos_token_id: int, n_fix: int = 8,
                        length: int = 20, seed: int = 0):
    """The JAX bench's train fixtures (``bench.py:336-450``): ``n_fix``
    batches, each caption view ``length`` random tokens then <eos> and
    padding to 77 (mask over the tokens and the first <eos>), random
    normal images at 64, 128 and 256 px, class ids ``0..batch-1``."""
    rng = np.random.default_rng(seed)

    def captions():
        ids = np.full((batch, 77), eos_token_id, np.int32)
        ids[:, :length] = rng.integers(1, eos_token_id - 1, (batch, length),
                                       dtype=np.int32)
        mask = np.zeros((batch, 77), np.int32)
        mask[:, :length + 1] = 1
        return ids, mask

    batches = []
    for _ in range(n_fix):
        (ids, mask), (ids2, mask2) = captions(), captions()
        batches.append({
            "images": [rng.standard_normal((batch, s, s, 3)).astype(
                np.float32) for s in (64, 128, 256)],
            "ids": ids, "mask": mask, "ids_2": ids2, "mask_2": mask2,
            "class_ids": np.arange(batch, dtype=np.int32)})
    return batches


def bench_damsm_batch(batch: int, eos_token_id: int, size: int = 224,
                      words: int = 30, seed: int = 0):
    """The JAX bench's DAMSM inputs (``bench.py:631-689``): both caption
    views ``words`` <eos> tokens with a full mask, standard-normal images
    at ``size`` px, class ids ``0..batch-1``."""
    rng = np.random.default_rng(seed)
    ids = np.full((batch, words), eos_token_id, np.int32)
    mask = np.ones((batch, words), np.int32)
    return {"images": rng.standard_normal((batch, size, size, 3)).astype(
                np.float32),
            "ids": ids, "mask": mask, "ids_2": ids.copy(),
            "mask_2": mask.copy(),
            "class_ids": np.arange(batch, dtype=np.int32)}
