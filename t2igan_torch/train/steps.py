"""Inference step of the port (``t2igan.train.steps.make_sampler``)."""

from __future__ import annotations

from typing import Callable, List

import torch

from t2igan_torch.config import Config
from t2igan_torch.models.clip import ClipWithRegionHead
from t2igan_torch.models.generator import GNet


def make_sampler(cfg: Config, clip: ClipWithRegionHead,
                 gen: GNet) -> Callable[..., List[torch.Tensor]]:
    """Text -> image pyramid: the CLIP text tower, then the generator in
    eval mode with the memory read through the K1 kernel on a card (the
    plain version on the CPU) and no attention maps.

    The returned ``sample(ids, mask, z, eps)`` takes token ids and the
    attention mask [B, L] (1 = real token), ``z`` [B, Z_DIM] and the
    conditioning noise ``eps`` [B, CONDITION_DIM], as arrays or tensors; it
    moves them to the generator's device and returns the images
    [B, s, s, 3] in [-1, 1], one per pyramid size, computed under
    ``torch.inference_mode()``.  ``cfg`` is taken for the JAX sampler's
    signature; the modules carry their widths.
    """
    del cfg
    device = next(gen.parameters()).device

    def sample(ids, mask, z, eps) -> List[torch.Tensor]:
        with torch.inference_mode():
            ids = torch.as_tensor(ids, device=device)
            mask = torch.as_tensor(mask, device=device)
            words, sent = clip.encode_text_verbose(ids, mask)
            fakes, _, _, _ = gen(torch.as_tensor(z, device=device), sent,
                                 words, mask == 0,
                                 torch.as_tensor(eps, device=device),
                                 return_attn=False)
        return fakes

    return sample
