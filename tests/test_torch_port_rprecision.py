"""CLIP R-precision of the port against the JAX package's, on the CPU:
the rank function's scores and hits, the mis-caption bank, the bootstrap
and the synthetic dataset's mis-caption draws.

The rank function runs on ``TINY_CLIP`` (two 2-layer towers, 32 px) with
the JAX weights bridged into the port, on the same images and captions.
Tolerances: scores 1e-5 absolute (cosines in [-1, 1] through two small
towers in f32); a hit flag must agree wherever the top two scores are
more than 1e-5 apart.  The bank, the bootstrap and the dataset's draws
are numpy on both sides and must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_modules import TCFG, port_clip_cfg
from test_train_steps import CFG, TINY_CLIP
from t2igan.data.synthetic import SyntheticDataset as JDataset
from t2igan.data.tokenizer import ClipTokenizer as JTokenizer
from t2igan.evaluation import rprecision as jr
from t2igan.models import clip as jclip
from t2igan_torch.data.synthetic import SyntheticDataset
from t2igan_torch.data.tokenizer import ClipTokenizer
from t2igan_torch.evaluation import rprecision as tr
from t2igan_torch.models.convert import load_jax_clip
from t2igan_torch.models.factory import build_clip


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCORE_TOL = 1e-5


def _captions(rng, n, l=16, vocab=512, eos=511):
    ids = np.full((n, l), eos, dtype=np.int32)
    mask = np.zeros((n, l), dtype=np.int32)
    for i, k in enumerate(rng.integers(4, l + 1, size=n)):
        ids[i, 0] = vocab - 2
        ids[i, 1:k - 1] = rng.integers(1, 400, k - 2)
        mask[i, :k] = 1
    return ids, mask


@pytest.fixture(scope="module")
def rank_case():
    model = jclip.ClipWithRegionHead(TINY_CLIP)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    rng = np.random.default_rng(2)
    b, n_mis = 4, 9
    images = np.tanh(rng.standard_normal((b, 32, 32, 3))).astype(np.float32)
    ids, mask = _captions(rng, b)
    mis_ids, mis_mask = (x.reshape(b, n_mis, 16)
                         for x in _captions(rng, b * n_mis))
    args = (images, ids, mask, mis_ids, mis_mask)
    flags = np.asarray(jr.make_rank_fn(model, variables)(*args))

    def scores(params, images, ids, mask, mis_ids, mis_mask):
        """The JAX rank function's scores, as its ``run`` computes them."""
        v = {"params": params}
        _, img = model.apply(v, images,
                             method=jclip.ClipWithRegionHead
                             .encode_image_verbose)
        _, sent = model.apply(v, ids, mask, method=jclip.ClipWithRegionHead
                              .encode_text_verbose)
        _, mis = model.apply(v, mis_ids.reshape(b * n_mis, -1),
                             mis_mask.reshape(b * n_mis, -1),
                             method=jclip.ClipWithRegionHead
                             .encode_text_verbose)
        cands = jnp.concatenate([sent[:, None], mis.reshape(b, n_mis, -1)],
                                axis=1)
        img = img / jnp.clip(jnp.linalg.norm(img, axis=-1, keepdims=True),
                             min=1e-8)
        cands = cands / jnp.clip(jnp.linalg.norm(cands, axis=-1,
                                                 keepdims=True), min=1e-8)
        return jnp.einsum("bd,bnd->bn", img, cands)

    ref = np.asarray(jax.jit(scores)(variables["params"], *args))
    clip = load_jax_clip(build_clip(port_clip_cfg(TINY_CLIP)),
                         jax.tree.map(np.asarray, variables["params"]))
    return args, flags, ref, clip


def test_rank_fn_matches_jax(rank_case):
    args, flags, ref, clip = rank_case
    hits, scores = tr.make_rank_fn(clip)(*args)
    assert scores.shape == (4, 10) and hits.dtype == torch.bool
    np.testing.assert_allclose(scores.numpy(), ref, rtol=0, atol=SCORE_TOL)
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > SCORE_TOL
    np.testing.assert_array_equal(hits.numpy()[clear], flags[clear])
    np.testing.assert_array_equal(hits.numpy(),
                                  scores.numpy().argmax(1) == 0)


def _datasets(seed=0, size=64):
    return (SyntheticDataset(TCFG, size=size, seed=seed),
            JDataset(CFG, size=size, seed=seed))


def test_dataset_mis_captions_are_the_jax_ones():
    ours, ref = _datasets(seed=3)
    for cls in (0, 5, 5):
        assert ours.mis_captions(cls, 7) == ref.mis_captions(cls, 7)
    caps, cls = ours.caption_bank()
    rcaps, rcls = ref.caption_bank()
    assert caps == rcaps
    np.testing.assert_array_equal(cls, rcls)


@pytest.mark.parametrize("words", [16, 77])
def test_mis_caption_bank_is_the_jax_one(words):
    ours, ref = _datasets()
    bank = tr.MisCaptionBank(ours, ClipTokenizer.load(), words)
    jbank = jr.MisCaptionBank(ref, JTokenizer.load(), words)
    rng = np.random.default_rng(4)
    for n_mis in (99, 5, 99):
        class_ids = rng.integers(0, 8, 6)
        (ids, mask), (jids, jmask) = (bank.sample(class_ids, n_mis),
                                      jbank.sample(class_ids, n_mis))
        assert ids.shape == (6, n_mis, words)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)


def test_mis_caption_bank_refuses_a_one_class_split():
    ours, ref = _datasets(size=8)
    ours.class_id[:] = 0
    ref.class_id[:] = 0
    errors = []
    for bank_cls, ds, tok in ((tr.MisCaptionBank, ours, ClipTokenizer),
                              (jr.MisCaptionBank, ref, JTokenizer)):
        with pytest.raises(ValueError) as e:
            bank_cls(ds, tok.load(), 16).sample(np.zeros(2, np.int64), 3)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("n", [1, 7, 10, 2999, 30000, 30001, 45017])
@pytest.mark.parametrize("seed", [0, 5])
def test_bootstrap_is_the_jax_one(n, seed):
    hits = np.random.default_rng(n).random(n) < 0.3
    assert tr.bootstrap_r_precision(hits, seed=seed) == \
        jr.bootstrap_r_precision(hits, seed=seed)
    assert tr.bootstrap_r_precision(hits, 4, 5, seed) == \
        jr.bootstrap_r_precision(hits, 4, 5, seed)


def test_port_dataset_record_fields_are_unchanged():
    """The mis-caption stream is the dataset's own and leaves the records
    (drawn from per-index generators) as they were."""
    ours, _ = _datasets()
    before = ours[3]
    ours.mis_captions(1, 20)
    after = ours[3]
    assert dataclasses.asdict(before).keys() == dataclasses.asdict(
        after).keys()
    assert (before.caption, before.caption_2) == (after.caption,
                                                  after.caption_2)
    for x, y in zip(before.images, after.images):
        np.testing.assert_array_equal(x, y)
