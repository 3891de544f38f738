"""The port's CLIP text tower against the JAX package's, on the CPU.

JAX parameters come from ``.init`` and cross through the weight bridge
(``load_jax_clip_text``); the same ids and masks go to both sides.
Tolerance 1e-4 absolute and relative in f32, as ``tests/test_clip.py``
holds the JAX tower to HuggingFace's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.models import clip as jclip
from t2igan_torch.models import clip as tclip
from t2igan_torch.models.convert import load_jax_clip_text


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-4, atol=1e-4)


def _tiny(max_positions):
    """TINY_CLIP of tests/test_train_steps.py, at ``max_positions``."""
    return dict(vocab_size=512, max_positions=max_positions, eos_token_id=511,
                projection_dim=32, image_size=32, patch_size=16,
                region_dim=32)


def _configs(max_positions):
    kw = _tiny(max_positions)
    j = jclip.ClipConfig(**kw, text=jclip.ClipTowerConfig(32, 2, 2, 64),
                         vision=jclip.ClipTowerConfig(48, 2, 2, 96))
    t = tclip.ClipConfig(**kw, text=tclip.ClipTowerConfig(32, 2, 2, 64),
                         vision=tclip.ClipTowerConfig(48, 2, 2, 96))
    return j, t


def _captions(rng, b, l, vocab=512, eos=511):
    ids = np.zeros((b, l), dtype=np.int32)
    mask = np.zeros((b, l), dtype=np.int32)
    lens = rng.integers(4, l + 1, size=b)
    lens[0] = l  # one caption with no padding
    for i, n in enumerate(lens):
        ids[i, 0] = vocab - 2
        ids[i, 1:n - 1] = rng.integers(1, 400, n - 2)
        ids[i, n - 1] = eos
        ids[i, n:] = eos
        mask[i, :n] = 1
    return ids, mask


@functools.lru_cache(maxsize=None)
def _pair(max_positions):
    jcfg, tcfg = _configs(max_positions)
    jmodel = jclip.ClipWithRegionHead(jcfg)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, max_positions), jnp.int32),
        jnp.ones((1, max_positions), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = load_jax_clip_text(tclip.ClipWithRegionHead(tcfg).eval(), params)
    return jmodel, variables, tmodel, params


def _encode(jmodel, variables, ids, mask):
    fn = jax.jit(lambda v, i, m: jmodel.apply(
        v, i, m, method=jclip.ClipWithRegionHead.encode_text_verbose))
    return fn(variables, jnp.asarray(ids),
              None if mask is None else jnp.asarray(mask))


@pytest.mark.parametrize("max_positions", [16, 77])
def test_text_tower_parity(rng, max_positions):
    jmodel, variables, tmodel, _ = _pair(max_positions)
    ids, mask = _captions(rng, 3, max_positions)
    ids[2, 5] = 700  # out of the 512-id vocabulary: clamped on both sides
    jw, js = _encode(jmodel, variables, ids, mask)
    with torch.no_grad():
        tw, ts = tmodel.encode_text_verbose(torch.from_numpy(ids),
                                            torch.from_numpy(mask))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_text_tower_without_mask(rng):
    jmodel, variables, tmodel, _ = _pair(16)
    ids, _ = _captions(rng, 2, 16)
    jw, js = _encode(jmodel, variables, ids, None)
    with torch.no_grad():
        tw, ts = tmodel.encode_text_verbose(torch.from_numpy(ids), None)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_padding_bias_overflows_to_minus_inf_as_in_jax():
    """Causal fill + padding fill (both -3.4e38) is -inf in f32 on both
    sides; the tower stays finite because every row keeps slot 0."""
    with np.errstate(over="ignore"):
        assert np.isinf(np.float32(jclip.NEG) + np.float32(jclip.NEG))
    assert torch.isinf(torch.tensor(tclip.NEG) + torch.tensor(tclip.NEG))


def test_bridge_rejects_missing_and_misshaped(rng):
    _, _, _, params = _pair(16)
    _, tcfg = _configs(16)
    broken = jax.tree.map(lambda a: a, params)
    del broken["text_model"]["layers_1"]["fc2"]
    with pytest.raises(KeyError, match="layers_1/fc2"):
        load_jax_clip_text(tclip.ClipWithRegionHead(tcfg), broken)
    broken = jax.tree.map(lambda a: a, params)
    broken["text_projection"]["kernel"] = np.zeros((32, 16), np.float32)
    with pytest.raises(ValueError, match="text_projection"):
        load_jax_clip_text(tclip.ClipWithRegionHead(tcfg), broken)
    one_layer = dataclasses.replace(
        tcfg, text=tclip.ClipTowerConfig(32, 1, 2, 64))
    with pytest.raises(ValueError, match="layers_1"):
        load_jax_clip_text(tclip.ClipWithRegionHead(one_layer), params)
