"""Inception Score over a directory of generated images: the port's copy of
:mod:`t2igan.evaluation.inception_score` (the reference's
inception_score.py:20-118).

The reference's transform chain is original -> ``Scale(32)`` (PIL bilinear)
-> Normalize(.5) -> torch bilinear to 299 -> torchvision Inception-v3 ->
softmax, then ``exp(mean KL(p(y|x) || p(y)))`` per split.  The host half
decodes with the port's decoder and reproduces PIL's ``Image.resize(...,
BILINEAR)`` bit for bit (:func:`t2igan_torch.data.native.resize_pil_bilinear`)
without PIL; the device half runs on the model's device.
``python -m t2igan_torch.inception_score`` is the CLI.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from t2igan_torch.data import native
from t2igan_torch.evaluation.fid import chunked, list_images
from t2igan_torch.models.inception import InceptionV3


def scale32(path: str, size: int = 32) -> np.ndarray:
    """One file, its shorter side scaled to ``size`` (``Scale(32)``: PIL's
    BILINEAR, the longer side ``round``ed), as [0, 1] float32 HWC."""
    img = native.decode_image(path)
    h, w = img.shape[:2]
    if w <= h:
        out_w, out_h = size, max(1, round(h * size / w))
    else:
        out_w, out_h = max(1, round(w * size / h)), size
    return native.resize_pil_bilinear(img, out_h, out_w).astype(
        np.float32) / 255.0


def scale32_batches(files: List[str], batch_size: int, size: int = 32,
                    num_workers: int = 6) -> Iterator[np.ndarray]:
    """[B, 32, 32, 3] [0, 1] batches of ``files`` after ``Scale(32)``,
    decoded on a thread pool one chunk ahead.  The IS protocol expects
    square generated images: a batch of mixed shapes raises."""
    for imgs in chunked(files, batch_size, lambda f: scale32(f, size),
                        num_workers):
        shapes = {a.shape for a in imgs}
        if len(shapes) > 1:
            raise ValueError(
                f"mixed post-Scale(32) shapes {shapes}: the IS protocol "
                "expects uniformly-sized (square) generated images")
        yield np.stack(imgs)


def make_pred_fn(model: InceptionV3) -> Callable[..., torch.Tensor]:
    """[0, 1] NHWC batch -> softmax class probabilities [B, classes] of
    ``model`` (the torchvision variant), on its device and in its dtype:
    Normalize(.5, .5), torch's bilinear resize to 299 (no antialias), the
    network, softmax."""
    param = next(model.parameters())

    def run(x01) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(x01, device=param.device).to(param.dtype)
            x = 2.0 * x - 1.0
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299),
                              mode="bilinear", align_corners=False,
                              antialias=False).permute(0, 2, 3, 1)
            return torch.softmax(model(x)["logits"].float(), dim=-1)

    return run


def inception_score_from_preds(preds: np.ndarray,
                               splits: int = 10) -> Tuple[float, float]:
    """exp(mean KL) per split -> (mean, std) (inception_score.py:84-103)."""
    n = preds.shape[0]
    scores = []
    for k in range(splits):
        part = preds[k * (n // splits):(k + 1) * (n // splits)]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(path: str, model: InceptionV3, batch_size: int = 32,
                    splits: int = 10) -> Tuple[float, float]:
    """(mean, std) of the Inception Score of the images under ``path``."""
    pred_fn = make_pred_fn(model)
    files = list_images(path)
    if not files:
        raise ValueError(f"no images under {path}")
    preds = [pred_fn(batch).cpu().numpy()
             for batch in scale32_batches(files, batch_size)]
    return inception_score_from_preds(np.concatenate(preds), splits)
