"""CUB-200-2011 / COCO-2014 text-image pairs on disk: the port's copy of
:mod:`t2igan.data.dataset`.

The on-disk layout is the reference's (datasets.py:395-666):
``<split>/filenames.pickle``, ``captions.pickle`` (legacy word-index lists
with ``ixtoword``, or plain strings), ``<split>/class_info.pickle``, and for
CUB ``CUB_200_2011/{images.txt,bounding_boxes.txt,images/<key>.jpg}``, each
image cropped to a 75%-padded square around its bbox (datasets.py:91-98).
A sample is the image pyramid (Scale(76/64 * size), RandomCrop(size),
RandomHFlip, per-branch resize, CLIP normalisation) and two random
captions.

Pixels come from the port's own decoder (:mod:`t2igan_torch.data.native`;
PIL's pixels, without PIL) and the JAX package's C++ pyramid, copied.  The
random draws come from the dataset's one generator, in the JAX package's
orders:

* :meth:`TextImageDataset.plan_record` (its native engine): crop fractions
  u and v, the flip, two caption draws; no pixel is needed;
* :meth:`TextImageDataset.thread_plan` (its thread engine,
  ``__getitem__``): integer crop offsets ``rng.integers(0, n)`` over the
  scaled image's size, the flip, two caption draws.  The size comes from
  the file's header, so these draws too need no pixel.

A plan is then executed (decode, crop, pyramid) on any thread:
:meth:`TextImageDataset.load_plan` or the C++ executor.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from t2igan_torch.config import Config
from t2igan_torch.data import native
from t2igan_torch.data.synthetic import Record
from t2igan_torch.ops.image import CLIP_MEAN, CLIP_STD

__all__ = ["Record", "ExecPlan", "load_bbox_table", "crop_to_bbox",
           "ImageTransform", "normalize_clip", "TextImageDataset"]


@dataclass
class ExecPlan:
    """One sample but its pixels.  With ``crop_xy`` None the crop comes
    from the fractions, as the executor derives it (``x0 = floor(u * (nw -
    crop + 1))`` in float32); else ``crop_xy`` is the integer crop."""

    path: str
    bbox: Optional[List[int]]       # CUB [x, y, w, h] or None
    u: float                        # crop fractions in [0, 1)
    v: float
    flip: bool
    caption: str
    caption_2: str
    class_id: int
    key: str
    crop_xy: Optional[Tuple[int, int]] = None


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_bbox_table(data_dir: str) -> Dict[str, List[int]]:
    """CUB bbox table (datasets.py:431-454), key -> [x, y, w, h]."""
    boxes_path = os.path.join(data_dir, "CUB_200_2011", "bounding_boxes.txt")
    images_path = os.path.join(data_dir, "CUB_200_2011", "images.txt")
    with open(images_path) as f:
        names = [line.split()[1] for line in f if line.strip()]
    table = {}
    with open(boxes_path) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            table[names[i][:-4]] = [int(float(x)) for x in parts[1:5]]
    return table


def bbox_window(width: int, height: int,
                bbox) -> Tuple[int, int, int, int]:
    """(x1, y1, x2, y2) of the 75%-padded square around the bbox's centre,
    clipped to the image (datasets.py:91-98)."""
    r = int(np.maximum(bbox[2], bbox[3]) * 0.75)
    cx = int((2 * bbox[0] + bbox[2]) / 2)
    cy = int((2 * bbox[1] + bbox[3]) / 2)
    y1, y2 = max(0, cy - r), min(height, cy + r)
    x1, x2 = max(0, cx - r), min(width, cx + r)
    return x1, y1, x2, y2


def crop_to_bbox(img: np.ndarray, bbox) -> np.ndarray:
    """The 75%-padded square crop of an [H, W, C] array around the bbox
    [x, y, w, h]."""
    x1, y1, x2, y2 = bbox_window(img.shape[1], img.shape[0], bbox)
    return img[y1:y2, x1:x2]


class ImageTransform:
    """Scale(76/64 * imsize) -> RandomCrop(imsize) -> RandomHFlip
    (main.py:163-166 / pretrain_DAMSM.py:417-420), as decisions drawn
    ahead of the pixels."""

    def __init__(self, imsize: int):
        self.imsize = imsize
        self.scale = int(imsize * 76 / 64)

    def scaled_dims(self, w: int, h: int):
        """torchvision Scale semantics: shorter side -> scale."""
        if w < h:
            return self.scale, int(round(self.scale * h / w))
        return int(round(self.scale * w / h)), self.scale

    def plan(self, w: int, h: int, rng: np.random.Generator):
        """(scaled w, scaled h, crop x0, crop y0, flip), drawn from
        ``rng`` as the JAX package's ``ImageTransform.plan``."""
        nw, nh = self.scaled_dims(w, h)
        x0 = int(rng.integers(0, nw - self.imsize + 1))
        y0 = int(rng.integers(0, nh - self.imsize + 1))
        flip = bool(rng.random() < 0.5)
        return nw, nh, x0, y0, flip


def normalize_clip(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> CLIP-normalized float32 (datasets.py:403-406)."""
    x = img_u8.astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(
        CLIP_STD, np.float32)


class TextImageDataset:
    """The reference's on-disk dataset.  ``seed`` seeds the one generator
    of every random draw (crops, flips, captions, mis-captions)."""

    def __init__(self, cfg: Config, split: str = "train", seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.data_dir = cfg.DATA_DIR
        self.embeddings_num = cfg.TEXT.CAPTIONS_PER_IMAGE
        self.sizes = cfg.branch_sizes
        self.transform = ImageTransform(cfg.final_size)
        self.rng = np.random.default_rng(seed)

        self.bbox = (load_bbox_table(self.data_dir)
                     if "birds" in self.data_dir else None)
        self.filenames = self._load_filenames(split)
        self.captions, self.ixtoword = self._load_captions(split)
        self.class_id = self._load_class_id(
            os.path.join(self.data_dir, split), len(self.filenames))
        self.number_example = len(self.filenames)

    # ---- index loading ----

    def _load_filenames(self, split):
        path = os.path.join(self.data_dir, split, "filenames.pickle")
        if os.path.isfile(path):
            return _load_pickle(path)
        return []

    def _load_captions(self, split):
        """captions.pickle: [train, test, (ixtoword, wordtoix)?]
        (datasets.py:530-551)."""
        path = os.path.join(self.data_dir, "captions.pickle")
        if not os.path.isfile(path):
            return [], None
        x = _load_pickle(path)
        caps = x[0] if split == "train" else x[1]
        ixtoword = x[2] if len(x) > 2 else None
        return caps, ixtoword

    def _load_class_id(self, split_dir, total):
        path = os.path.join(split_dir, "class_info.pickle")
        if os.path.isfile(path):
            return np.asarray(_load_pickle(path))
        return np.arange(total)

    # ---- captions ----

    def caption_text(self, sent_ix: int) -> str:
        cap = self.captions[sent_ix]
        if isinstance(cap, str):
            return cap
        if self.ixtoword is not None:
            return " ".join(self.ixtoword[int(w)] for w in cap)
        return " ".join(str(w) for w in cap)

    def _random_caption(self, index: int) -> str:
        sent_ix = int(self.rng.integers(0, self.embeddings_num))
        return self.caption_text(index * self.embeddings_num + sent_ix)

    def mis_captions(self, cls_id: int, n: int = 99) -> List[str]:
        """n captions from other classes (datasets.py:635-661)."""
        out = []
        while len(out) < n:
            idx = int(self.rng.integers(0, self.number_example))
            if self.class_id[idx] == cls_id:
                continue
            out.append(self._random_caption(idx))
        return out

    def caption_bank(self):
        """Every caption of the split with its class id, for the tokenized
        mis-caption pool: (captions, caption_class [N])."""
        n_caps = len(self.captions)
        expected = len(self.filenames) * self.embeddings_num
        if n_caps != expected:
            raise ValueError(
                f"captions.pickle carries {n_caps} captions for "
                f"{len(self.filenames)} filenames x {self.embeddings_num} "
                f"captions/image (expected {expected}); the i//"
                "embeddings_num class lookup would misalign classes")
        caps = [self.caption_text(i) for i in range(n_caps)]
        cls = np.asarray([int(self.class_id[i // self.embeddings_num])
                          for i in range(n_caps)], np.int64)
        return caps, cls

    # ---- samples ----

    def image_path(self, key: str) -> str:
        d = self.data_dir
        if self.bbox is not None or d.endswith("birds"):
            return os.path.join(d, "CUB_200_2011", "images", key + ".jpg")
        sub = "train2014" if self.split == "train" else "val2014"
        return os.path.join(d, sub, key + ".jpg")

    def __len__(self):
        return len(self.filenames)

    def _bbox(self, key: str) -> Optional[List[int]]:
        if self.bbox is None:
            return None
        return [int(x) for x in self.bbox[key]]

    def cropped_dims(self, index: int) -> Tuple[int, int]:
        """(width, height) of record ``index``'s image after the bbox crop,
        from the file's header."""
        key = self.filenames[index]
        h, w = native.image_dims(self.image_path(key))
        bbox = self._bbox(key)
        if bbox is not None:
            x1, y1, x2, y2 = bbox_window(w, h, bbox)
            if x2 > x1 and y2 > y1:  # a degenerate box keeps the image
                w, h = x2 - x1, y2 - y1
        return w, h

    def plan_record(self, index: int) -> ExecPlan:
        """The native engine's draws (the JAX ``plan_record``): crop u,
        crop v, flip, two caption draws."""
        key = self.filenames[index]
        u = float(self.rng.random())
        v = float(self.rng.random())
        flip = bool(self.rng.random() < 0.5)
        return ExecPlan(path=self.image_path(key), bbox=self._bbox(key),
                        u=u, v=v, flip=flip,
                        caption=self._random_caption(index),
                        caption_2=self._random_caption(index),
                        class_id=int(self.class_id[index]), key=key)

    def thread_plan(self, index: int) -> ExecPlan:
        """The thread engine's draws (the JAX ``__getitem__``): integer crop
        x0 and y0 over the scaled image, flip, two caption draws."""
        key = self.filenames[index]
        _, _, x0, y0, flip = self.transform.plan(*self.cropped_dims(index),
                                                 self.rng)
        return ExecPlan(path=self.image_path(key), bbox=self._bbox(key),
                        u=0.0, v=0.0, flip=flip,
                        caption=self._random_caption(index),
                        caption_2=self._random_caption(index),
                        class_id=int(self.class_id[index]), key=key,
                        crop_xy=(x0, y0))

    def load_plan(self, plan: ExecPlan,
                  out: Optional[List[np.ndarray]] = None
                  ) -> List[np.ndarray]:
        """The pyramid of a plan with an integer crop (decode, bbox crop,
        scale/crop/flip, per-branch resize, CLIP normalisation), in one
        call that releases the interpreter lock; into ``out`` when
        given."""
        if plan.crop_xy is None:
            raise ValueError("load_plan takes plans with an integer crop; "
                             "fraction plans go through the executor")
        return native.load_sample(plan.path, plan.bbox,
                                  self.transform.scale, self.transform.imsize,
                                  plan.crop_xy[0], plan.crop_xy[1],
                                  plan.flip, self.sizes, out)

    @staticmethod
    def record(plan: ExecPlan, images: List[np.ndarray]) -> Record:
        return Record(images=images, caption=plan.caption,
                      caption_2=plan.caption_2, class_id=plan.class_id,
                      key=plan.key)

    def __getitem__(self, index: int) -> Record:
        plan = self.thread_plan(index)
        return self.record(plan, self.load_plan(plan))

    def deterministic_plan(self, index: int) -> ExecPlan:
        """The generator-free plan of record ``index``: its first two
        captions, the centre crop, no flip."""
        key = self.filenames[index]
        nw, nh = self.transform.scaled_dims(*self.cropped_dims(index))
        crop = self.transform.imsize
        base = index * self.embeddings_num
        cap2_ix = base + min(1, self.embeddings_num - 1)
        return ExecPlan(path=self.image_path(key), bbox=self._bbox(key),
                        u=0.0, v=0.0, flip=False,
                        caption=self.caption_text(base),
                        caption_2=self.caption_text(cap2_ix),
                        class_id=int(self.class_id[index]), key=key,
                        crop_xy=((nw - crop) // 2, (nh - crop) // 2))

    def deterministic_record(self, index: int) -> Record:
        """Record ``index`` without touching ``self.rng`` (probe and
        snapshot batches): :meth:`deterministic_plan`, loaded."""
        plan = self.deterministic_plan(index)
        return self.record(plan, self.load_plan(plan))
