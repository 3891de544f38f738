"""The generator as one ``.npz`` (port of :mod:`t2igan.train.export`),
numpy only.

The artifact holds the EMA parameters and the trained G's BatchNorm
running statistics under the JAX ``GNet``'s (or ``GDCGan``'s) names,
``/``-joined:
``params/<path>`` and ``batch_stats/<path>``.  The JAX package's
``save_generator`` writes it and its ``load_generator`` reads it, so a
generator trained with either package samples in the other, and the port
reads it on a machine without JAX.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Union

import numpy as np

from t2igan_torch.models.convert import (jax_generator_variables,
                                         load_generator_pth,
                                         load_jax_generator)
from t2igan_torch.models.generator import GDCGan, GNet

Generator = Union[GNet, GDCGan]


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_generator_npz(path: str, gen_ema: Generator,
                       gen: Generator = None) -> str:
    """Write ``gen_ema``'s parameters with ``gen``'s running statistics
    (default ``gen_ema``'s) as ``path`` (``.npz`` appended when missing);
    returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    variables = jax_generator_variables(gen_ema, stats_from=gen)
    np.savez(path, **_flatten(variables["params"], "params/"),
             **_flatten(variables["batch_stats"], "batch_stats/"))
    return path


def load_generator_npz(path: str) -> Dict[str, Any]:
    """``{"params": ..., "batch_stats": ...}`` from a generator artifact,
    nested dicts of numpy arrays: what
    :func:`t2igan_torch.models.convert.load_jax_generator` takes."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return {c: _unflatten({k[len(c) + 1:]: v for k, v in flat.items()
                           if k.startswith(c + "/")})
            for c in ("params", "batch_stats")}


def load_generator_weights(gen: Generator, path: str) -> Generator:
    """Fill ``gen`` from a ``netG_epoch_%d.pth`` (the reference's names) or
    a ``.npz`` generator export (the JAX package's names), in place; a file
    of the other generator class raises naming ``GAN.B_DCGAN``."""
    if path.endswith(".npz"):
        return load_jax_generator(gen, load_generator_npz(path))
    if path.endswith(".pth"):
        return load_generator_pth(gen, path)
    raise ValueError(f"generator weights {path!r}: expected a .pth or a "
                     f".npz file")
