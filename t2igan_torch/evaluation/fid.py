"""FID of the port: Inception activations, Gaussian statistics, the
Fréchet distance, image directories, and the gen+eval path.

Port of :mod:`t2igan.evaluation.fid`.  Activations come from
:class:`InceptionV3` on the device the model lies on; the statistics and
the distance are float64 numpy on the host, copies of the JAX package's
``_sqrtm_psd`` and ``frechet_distance``.  Image files are decoded by the
port's own decoder (:mod:`t2igan_torch.data.native`: PIL's pixels) on a
thread pool, one chunk ahead of the model, and each is resized to 299 on
the host with torch's bilinear kernel (in float64), as pytorch-fid's model
resizes inside (``python -m t2igan_torch.fid_score`` is the CLI).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from t2igan_torch.config import Config
from t2igan_torch.data import native
from t2igan_torch.models.clip import ClipWithRegionHead
from t2igan_torch.models.generator import GNet
from t2igan_torch.models.inception import InceptionV3, preprocess
from t2igan_torch.train.steps import make_sampler

# dims -> feature tap, as pytorch-fid's BLOCK_INDEX_BY_DIM; spatial taps
# are averaged over the image to vectors.
TAP_BY_DIM = {64: "pool1", 192: "pool2", 768: "mixed6e", 2048: "pool3"}


def make_activation_fn(model: InceptionV3,
                       dims: int = 2048) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """[0, 1] NHWC image batch -> [B, dims] activations of ``model`` (on
    its device and in its dtype, under ``torch.inference_mode()``)."""
    if dims not in TAP_BY_DIM:
        raise ValueError(f"dims must be one of {sorted(TAP_BY_DIM)}")
    tap = TAP_BY_DIM[dims]
    param = next(model.parameters())

    def run(x01) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(x01, device=param.device).to(param.dtype)
            feat = model(preprocess(x))[tap]
            if feat.dim() == 4:  # spatial tap: global average pool
                feat = feat.mean(dim=(1, 2))
        return feat

    return run


def compute_statistics(activation_fn, batches: Iterable
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) in float64 over an iterable of [B, H, W, 3] [0, 1]
    batches."""
    acts: List[np.ndarray] = [activation_fn(batch).float().cpu().numpy()
                              for batch in batches]
    a = np.concatenate(acts, axis=0).astype(np.float64)
    return a.mean(axis=0), np.cov(a, rowvar=False)


def _sqrtm_psd(mat: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Symmetric PSD matrix square root through eigh; negative eigenvalues
    from roundoff are clamped."""
    w, v = np.linalg.eigh(mat)
    w = np.clip(w, eps, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians in float64:
    ``|mu1 - mu2|^2 + tr(s1) + tr(s2) - 2 tr sqrtm(s1^1/2 s2 s1^1/2)``,
    retried with ``eps`` on the diagonals if it is not finite."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    s1 = np.asarray(sigma1, np.float64)
    s2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(s1)
    w = np.linalg.eigvalsh(s1_half @ s2 @ s1_half)
    tr_covmean = np.sum(np.sqrt(np.clip(w, 0.0, None)))
    fid = float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_covmean)
    if not np.isfinite(fid):
        off = eps * np.eye(s1.shape[0])
        return frechet_distance(mu1, s1 + off, mu2, s2 + off, eps)
    return fid


# ---------------------------------------------------------------------------
# Image directories (pytorch-fid's path interface, fid_score.py:191-222)
# ---------------------------------------------------------------------------

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_images(path: str) -> List[str]:
    """The image files under ``path``, walked as the JAX package walks it
    (each directory's names sorted).  BMP and WebP are listed, and the
    decoder refuses them by name."""
    out = []
    for root, _, names in os.walk(path):
        for n in sorted(names):
            if os.path.splitext(n)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(root, n))
    return out


def resize_bilinear_torch_np(img: np.ndarray, out_h: int,
                             out_w: int) -> np.ndarray:
    """One HWC image resized with torch's bilinear kernel
    (``align_corners=False``, no antialias), computed in float64 and
    rounded once to float32 (within a few float32 steps of any float32
    evaluation of the same filter, the JAX package's matrix form
    included)."""
    x = torch.from_numpy(np.asarray(img, np.float64))
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).float().numpy()


def _decode_for_fid(path: str, size: int) -> np.ndarray:
    """One file -> [0, 1] float32 HWC at ``size`` (pytorch-fid's
    ImagePathDataset + ToTensor + the model's resize)."""
    arr = native.decode_image(path).astype(np.float32) / 255.0
    if arr.shape[:2] != (size, size):
        arr = resize_bilinear_torch_np(arr, size, size)
    return arr


def chunked(files: Sequence[str], batch_size: int, make,
            num_workers: int = 6) -> Iterator[np.ndarray]:
    """``make(path)`` of every file on ``num_workers`` threads, stacked
    ``batch_size`` at a time, the next chunk made while the current one is
    consumed."""
    chunks = [files[s:s + batch_size]
              for s in range(0, len(files), batch_size)]
    # Two pools, so the chunk ahead never waits on its own decode workers.
    with ThreadPoolExecutor(max(1, num_workers)) as pool, \
            ThreadPoolExecutor(1) as ahead:

        def make_chunk(chunk):
            return list(pool.map(make, chunk))

        pending = None
        for i, chunk in enumerate(chunks):
            items = make_chunk(chunk) if pending is None \
                else pending.result()
            pending = (ahead.submit(make_chunk, chunks[i + 1])
                       if i + 1 < len(chunks) else None)
            yield items


def image_batches(files: List[str], batch_size: int, size: int = 299,
                  num_workers: int = 6) -> Iterator[np.ndarray]:
    """[B, size, size, 3] float32 [0, 1] batches of ``files``, decoded and
    resized from each file's own size (one resample, so mixed sizes batch
    together)."""
    for items in chunked(files, batch_size,
                         lambda f: _decode_for_fid(f, size), num_workers):
        yield np.stack(items)


def statistics_of_path(path: str, activation_fn, batch_size: int = 50):
    """(mu, sigma) of a directory of images, or of a precomputed ``.npz``
    (keys ``mu`` and ``sigma``)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    files = list_images(path)
    if not files:
        raise ValueError(f"no images under {path}")
    return compute_statistics(activation_fn, image_batches(files, batch_size))


def calculate_fid_given_paths(paths, activation_fn,
                              batch_size: int = 50) -> float:
    """FID between two image directories (or ``.npz`` statistics)."""
    m1, s1 = statistics_of_path(paths[0], activation_fn, batch_size)
    m2, s2 = statistics_of_path(paths[1], activation_fn, batch_size)
    return frechet_distance(m1, s1, m2, s2)


def make_gen_activation_fn(cfg: Config, clip: ClipWithRegionHead, gen: GNet,
                           inception: InceptionV3
                           ) -> Callable[..., torch.Tensor]:
    """The gen+eval path (the JAX bench's ``--mode geneval``): captions
    through the sampler, its finest image rescaled from [-1, 1] to [0, 1]
    in the generator's dtype, bilinear-resized to 299, then Inception-v3
    ``pool3``.  The returned ``run(ids, mask, z, eps)`` takes the sampler's
    arguments and returns [B, 2048] under ``torch.inference_mode()``."""
    sample = make_sampler(cfg, clip, gen)
    dtype = next(gen.parameters()).dtype

    def run(ids, mask, z, eps) -> torch.Tensor:
        with torch.inference_mode():
            img01 = ((sample(ids, mask, z, eps)[-1] + 1.0) * 0.5).to(dtype)
            return inception(preprocess(img01))["pool3"]

    return run
