"""The COCO configuration in the port against the JAX package, on the CPU.

``eval_clip_coco.yml`` and ``clip_coco_dmgan.yml`` differ from the bird
configs in ``R_NUM: 3`` (three ResBlocks a refinement stage, so K3 loops
over three), five captions an image, ``LAMBDA: 50`` and the dataset's
``train2014``/``val2014`` layout without bounding boxes.

* ``GNet`` built from ``eval_clip_coco.yml`` with its widths cut (GF 16,
  EMBEDDING 24, CONDITION 20; R 3 and the three branches kept), eval
  mode, against the JAX generator built from the same config, with the
  plain tail and with ``GAN.FUSED_TAIL`` (the port's tail through its
  plain version on the CPU, JAX's through its folded XLA reference): every
  image 1e-4 (``tests/test_torch_port_generator.py``'s bound).
* One adversarial step at ``clip_coco_dmgan.yml``'s R 3 and LAMBDA 50 at
  ``tests/test_train_steps.py``'s widths, against the JAX step with SGD
  at lr 0.01 (``tests/test_torch_port_gan_step.py``'s bounds).
* The dataset and its loader on a COCO-shaped tree the test writes (no
  bbox, ``train2014``/``val2014``, 5 captions an image, no class file)
  against the JAX package's: paths, records and two epochs of batches at
  ``tests/test_torch_port_data.py``'s bounds (1e-6).
"""

import functools
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_native_build import build_jax_native
from test_torch_port_data import (assert_batches, assert_images, datasets,
                                  write_sources)
from test_torch_port_gan_step import _port_ds
from test_torch_port_generator import _inputs, _randomize_bn
from test_torch_port_train_modules import port_clip_cfg
from test_train_steps import TINY_CLIP, _gan_batch
from t2igan import config as jconfig
from t2igan.data import pipeline as jpipe
from t2igan.data import tokenizer as jtok
from t2igan.models import clip as jclip
from t2igan.models.factory import (build_discriminators as jbuild_ds,
                                   build_generator as jbuild_gen)
from t2igan.train.state import init_gan_state as jinit_state
from t2igan.train.steps import make_gan_step as jmake_step
from t2igan_torch import config as tconfig
from t2igan_torch.data import pipeline as tpipe
from t2igan_torch.data import tokenizer as ttok
from t2igan_torch.models.convert import load_jax_clip, load_jax_generator
from t2igan_torch.models.factory import build_clip, build_generator
from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.steps import make_gan_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "t2igan_torch", "configs")
TOL = dict(rtol=1e-4, atol=1e-4)
CUT = dict(GAN={"GF_DIM": 16, "CONDITION_DIM": 20},
           TEXT={"EMBEDDING_DIM": 24})
CAPTIONS = 5
# SGD's rate in the step test: LAMBDA 50 gives G gradients of ~35 at these
# widths, so at ``test_torch_port_gan_step.py``'s lr 1 the step itself
# would be ~35 and its f32 rounding alone ~1e-4 of that.
LR = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(name, **over):
    """(JAX, port) configs of ``configs/<name>`` with ``over`` merged."""
    path = os.path.join(CONFIGS, name)
    return (jconfig.cfg_replace(jconfig.cfg_from_file(path), **over),
            tconfig.cfg_replace(tconfig.cfg_from_file(path), **over))


@pytest.mark.parametrize("fused", [False, True])
def test_coco_generator_matches_jax(rng, fused):
    jcfg, tcfg = _both("eval_clip_coco.yml", **CUT)
    jcfg = jconfig.cfg_replace(jcfg, GAN={"FUSED_TAIL": fused})
    tcfg = tconfig.cfg_replace(tcfg, GAN={"FUSED_TAIL": fused})
    assert (tcfg.GAN.R_NUM, tcfg.TREE.BRANCH_NUM) == (3, 3)
    z, sent, words, pad, eps = _inputs(rng)
    model = jbuild_gen(jcfg)
    v = _randomize_bn(jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
        z, sent, words, pad, ca_eps=eps))
    ref, _, _, _ = jax.jit(functools.partial(
        model.apply, train=False, return_attn=False))(
        v, z, sent, words, pad, ca_eps=eps)
    gen = load_jax_generator(build_generator(tcfg), v)
    assert gen.fused_tail == fused
    assert [len(s.residual) for s in gen.next_stages] == [3, 3]
    LAUNCHES.clear()
    with torch.no_grad():
        imgs, _, _, _ = gen(*map(torch.from_numpy, (z, sent, words, pad,
                                                    eps)),
                            return_attn=False)
    assert dict(LAUNCHES) == {}  # the plain versions on the CPU
    assert [tuple(i.shape) for i in imgs] == [(2, s, s, 3)
                                              for s in (64, 128, 256)]
    for a, b in zip(imgs, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_coco_train_step_matches_jax():
    """``clip_coco_dmgan.yml``'s R 3 and LAMBDA 50 at the test widths."""
    small = dict(TREE={"BASE_SIZE": 64, "BRANCH_NUM": 2},
                 GAN={"GF_DIM": 8, "DF_DIM": 4, "Z_DIM": 16,
                      "CONDITION_DIM": 16},
                 TEXT={"EMBEDDING_DIM": 32, "WORDS_NUM": 16},
                 TRAIN={"BATCH_SIZE": 4})
    jcfg, tcfg = _both("clip_coco_dmgan.yml", **small)
    assert (tcfg.GAN.R_NUM, tcfg.TRAIN.SMOOTH.LAMBDA) == (3, 50.0)
    clip_model = jclip.ClipWithRegionHead(TINY_CLIP)
    clip_vars = jax.jit(clip_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    gen, ds = jbuild_gen(jcfg), jbuild_ds(jcfg)
    state = jax.jit(lambda r: jinit_state(jcfg, gen, ds, r))(
        jax.random.PRNGKey(1))
    tx = optax.sgd(LR)
    state = state.replace(g_opt_state=tx.init(state.g_params),
                          d_opt_states=[tx.init(p) for p in state.d_params])
    batch = _gan_batch(np.random.default_rng(1))
    rng = jax.random.PRNGKey(2)
    new, ref = jax.jit(jmake_step(jcfg, clip_model, gen, ds, tx, tx))(
        state, clip_vars["params"], batch, rng)
    rz, r1, r2 = jax.random.split(rng, 3)
    noise = [torch.from_numpy(np.array(jax.random.normal(r, (4, d))))
             for r, d in ((rz, 16), (r1, 16), (r2, 16))]

    np_tree = functools.partial(jax.tree.map, np.asarray)
    before, after = np_tree(state), np_tree(new)
    clip = load_jax_clip(build_clip(port_clip_cfg(TINY_CLIP)),
                         np_tree(clip_vars["params"])).requires_grad_(False)
    tgen = load_jax_generator(build_generator(tcfg), {
        "params": before.g_params, "batch_stats": before.g_batch_stats})
    assert [len(s.residual) for s in tgen.next_stages] == [3]
    sgd = functools.partial(torch.optim.SGD, lr=LR)
    tstate = init_gan_state(tcfg, tgen, _port_ds(before.d_params,
                                                 before.d_spectral),
                            sgd, sgd)
    metrics = make_gan_step(tcfg, clip)(tstate, batch, *noise)
    assert metrics.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    want = load_jax_generator(build_generator(tcfg), {
        "params": after.g_params, "batch_stats": after.g_batch_stats})
    for (name, a), b in zip(tstate.gen.state_dict().items(),
                            want.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)
    for d, w in zip(tstate.ds, _port_ds(after.d_params, after.d_spectral)):
        for (name, a), b in zip(d.state_dict().items(),
                                w.state_dict().values()):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       err_msg=name, **TOL)


# --------------------------------------------------------------- data ----

def make_coco_tree(root, n_train=12, n_test=8):
    """A COCO-2014-shaped tree under ``root/coco``: ``train2014`` and
    ``val2014`` images named as COCO names them, ``train``/``test``
    ``filenames.pickle`` and ``captions.pickle`` (5 captions an image),
    no bounding boxes and no class file."""
    sources = write_sources(str(root))
    data = os.path.join(str(root), "coco")
    rng = np.random.default_rng(0)
    words = ["a", "man", "dog", "red", "bus", "on", "the", "street",
             "kitchen", "table", "with", "two", "people", "riding"]
    caps = []
    for split, sub, first, n in (("train", "train2014", 0, n_train),
                                 ("test", "val2014", n_train, n_test)):
        keys = [f"COCO_{sub}_{i:012d}" for i in range(first, first + n)]
        os.makedirs(os.path.join(data, sub))
        os.makedirs(os.path.join(data, split))
        for i, key in enumerate(keys):
            shutil.copyfile(sources[i % len(sources)],
                            os.path.join(data, sub, key + ".jpg"))
        with open(os.path.join(data, split, "filenames.pickle"), "wb") as f:
            pickle.dump(keys, f, protocol=2)
        caps.append([" ".join(rng.choice(words, rng.integers(4, 10)))
                     for _ in range(n * CAPTIONS)])
    with open(os.path.join(data, "captions.pickle"), "wb") as f:
        pickle.dump(caps, f, protocol=2)
    return data


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    build_jax_native()
    data = make_coco_tree(tmp_path_factory.mktemp("mscoco"))
    d = {"DATA_DIR": data, "WORKERS": 2, "DATASET_NAME": "coco",
         "TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 16},
         "TEXT": {"CAPTIONS_PER_IMAGE": CAPTIONS}}
    return jconfig.cfg_from_dict(d), tconfig.cfg_from_dict(d)


@pytest.mark.parametrize("split,sub", [("train", "train2014"),
                                       ("test", "val2014")])
def test_coco_records_match_jax(coco, split, sub):
    jd, td = datasets(coco, split, seed=4)
    assert jd.bbox is None and td.bbox is None
    assert len(td) == len(jd) == (12 if split == "train" else 8)
    for i in range(len(td)):
        key = td.filenames[i]
        assert td.image_path(key) == jd.image_path(key) == os.path.join(
            coco[1].DATA_DIR, sub, key + ".jpg")
    np.testing.assert_array_equal(td.class_id, np.arange(len(td)))
    np.testing.assert_array_equal(td.class_id, jd.class_id)
    (jc, jcls), (tc, tcls) = jd.caption_bank(), td.caption_bank()
    assert jc == tc and len(tc) == len(td) * CAPTIONS
    np.testing.assert_array_equal(jcls, tcls)
    for i in list(range(len(td))) + [3, 0]:
        a, b = jd[i], td[i]
        assert_images(a.images, b.images)
        assert (a.caption, a.caption_2, a.class_id, a.key) == \
            (b.caption, b.caption_2, b.class_id, b.key)
    assert jd.rng.bit_generator.state == td.rng.bit_generator.state


@pytest.mark.parametrize("engine", ["native", "thread"])
def test_coco_loader_epochs_match_jax(coco, engine):
    jd, td = datasets(coco)
    jl = jpipe.DataLoader(jd, jtok.ClipTokenizer.fallback(), 4, 77,
                          num_workers=1, engine=engine, host_index=0,
                          host_count=1)
    tl = tpipe.DataLoader(td, ttok.ClipTokenizer.load(), 4, 77,
                          num_workers=1, engine=engine)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            assert_batches(a, b)
    assert jl.dataset.rng.bit_generator.state == \
        tl.dataset.rng.bit_generator.state
    jl.close()
    tl.close()
