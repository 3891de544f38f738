"""FID of the port: Inception activations, Gaussian statistics, the
Fréchet distance, and the gen+eval path.

Port of :mod:`t2igan.evaluation.fid` (its directory walking and CLI are not
ported yet).  Activations come from :class:`InceptionV3` on the device the
model lies on; the statistics and the distance are float64 numpy on the
host, copies of the JAX package's ``_sqrtm_psd`` and ``frechet_distance``.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch

from t2igan_torch.config import Config
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
