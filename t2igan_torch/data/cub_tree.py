"""A small CUB-200-2011-shaped dataset tree made from a few image files,
for smoke runs and tests where the real dataset is not on disk.

    write_cub_tree(root, sources, n_train=96, n_test=32, n_classes=8)

writes ``<root>/birds`` (the name tells :class:`TextImageDataset` to read
the bounding boxes) with the reference's layout:

* ``CUB_200_2011/images/<class>/<key>.jpg``: the source files, in turn;
* ``CUB_200_2011/images.txt`` and ``bounding_boxes.txt``: every image, and
  a box drawn from ``seed`` inside it (CUB's ``x y w h`` in floats);
* ``train/`` and ``test/``: ``filenames.pickle`` (keys ``<class>/<key>``)
  and ``class_info.pickle`` (class numbers from 1, as CUB's);
* ``captions.pickle``: ``[train captions, test captions]``, plain strings,
  ``captions_per_image`` an image, drawn from ``seed``.

Records are spread over the classes in turn.  It returns the tree's path,
for ``DATA_DIR``.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import List, Sequence

import numpy as np

from t2igan_torch.data import native

_COLORS = ["red", "blue", "yellow", "green", "black", "white", "brown",
           "grey", "orange"]
_PARTS = ["wings", "beak", "crown", "tail", "breast", "belly", "throat",
          "nape"]
_SHAPES = ["small", "large", "plump", "slender"]


def _caption(rng: np.random.Generator) -> str:
    c1, c2 = rng.choice(_COLORS, 2)
    p1, p2 = rng.choice(_PARTS, 2, replace=False)
    return (f"this {rng.choice(_SHAPES)} bird has {c1} {p1} and a {c2} "
            f"{p2}")


def write_cub_tree(root: str, sources: Sequence[str], n_train: int = 96,
                   n_test: int = 32, n_classes: int = 8,
                   captions_per_image: int = 10, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "birds")
    cub = os.path.join(data_dir, "CUB_200_2011")
    dims = [native.image_dims(s) for s in sources]
    names: List[str] = []
    boxes: List[str] = []
    splits = {"train": ([], [], []), "test": ([], [], [])}
    for i in range(n_train + n_test):
        split = "train" if i < n_train else "test"
        cls = i % n_classes + 1
        class_dir = f"{cls:03d}.Bird_{cls}"
        key = f"{class_dir}/Bird_{cls}_{i:04d}"
        src = i % len(sources)
        dst = os.path.join(cub, "images", key + ".jpg")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(sources[src], dst)
        h, w = dims[src]
        bw = int(rng.integers(w // 4, w * 9 // 10 + 1))
        bh = int(rng.integers(h // 4, h * 9 // 10 + 1))
        bx = int(rng.integers(0, w - bw + 1))
        by = int(rng.integers(0, h - bh + 1))
        names.append(f"{i + 1} {key}.jpg")
        boxes.append(f"{i + 1} {bx:.1f} {by:.1f} {bw:.1f} {bh:.1f}")
        keys, classes, caps = splits[split]
        keys.append(key)
        classes.append(cls)
        caps.extend(_caption(rng) for _ in range(captions_per_image))
    with open(os.path.join(cub, "images.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(cub, "bounding_boxes.txt"), "w") as f:
        f.write("\n".join(boxes) + "\n")
    for split, (keys, classes, _) in splits.items():
        os.makedirs(os.path.join(data_dir, split), exist_ok=True)
        with open(os.path.join(data_dir, split, "filenames.pickle"),
                  "wb") as f:
            pickle.dump(keys, f, protocol=2)
        with open(os.path.join(data_dir, split, "class_info.pickle"),
                  "wb") as f:
            pickle.dump(classes, f, protocol=2)
    with open(os.path.join(data_dir, "captions.pickle"), "wb") as f:
        pickle.dump([splits["train"][2], splits["test"][2]], f, protocol=2)
    return data_dir
