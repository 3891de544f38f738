"""The port's data layer against the JAX package's, on the CPU, on a
CUB-shaped tree the tests write (``t2igan_torch.data.cub_tree`` from
Pillow JPEGs, one of them CMYK, which the JAX native engine hands to PIL).

Held equal: the bbox table, ``crop_to_bbox``, ``caption_text`` (plain
strings and the legacy ``ixtoword`` lists), ``caption_bank`` with its size
check, ``mis_captions``, ``ClipTokenDataset``; records of the same seed
(1e-6 on the CLIP-normalised pyramid, the same C++ triangle filter) from
``engine="native"`` (JAX ``plan_record`` + its ``AsyncExecutor``),
``engine="thread"`` (JAX ``__getitem__``) and ``deterministic_record``;
two whole epochs of ``DataLoader`` batches in order, native at 1 and 4
workers and thread at 1 (the JAX thread engine draws inside its workers,
so at 4 workers the port's thread engine is held to its own 1-worker
stream).  Also: ``peek`` moves no stream, the executor is reused across
epochs in FIFO order, a bad file raises naming itself, the pinned device
feed keeps order, ``caption_batches`` draws as iteration draws, and
``make_dataset`` reads the tree.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from make_torch_port_fixtures import smooth
from test_native_build import build_jax_native
from t2igan import config as jconfig
from t2igan import native as jnative
from t2igan.data import clip_dataset as jclipds
from t2igan.data import dataset as jds
from t2igan.data import pipeline as jpipe
from t2igan.data import tokenizer as jtok
from t2igan_torch import config as tconfig
from t2igan_torch.data import clip_dataset as tclipds
from t2igan_torch.data import dataset as tds
from t2igan_torch.data import native
from t2igan_torch.data import pipeline as tpipe
from t2igan_torch.data import tokenizer as ttok
from t2igan_torch.data.cub_tree import write_cub_tree
from t2igan_torch.train.pretrain_damsm import make_dataset

TOL = 1e-6
# 4:2:0, 4:2:2, progressive 4:4:4, grayscale and CMYK sources.
SOURCES = [((45, 60), "RGB", dict(subsampling=2)),
           ((70, 52), "RGB", dict(subsampling=1)),
           ((50, 50), "RGB", dict(progressive=True, subsampling=0)),
           ((40, 64), "L", {}),
           ((48, 64), "CMYK", {})]


def write_sources(root):
    paths = []
    for i, ((h, w), mode, kw) in enumerate(SOURCES):
        img = smooth(h, w, i, texture=8.0)
        if mode == "CMYK":
            img = np.concatenate([img, smooth(h, w, i + 50)[..., :1]], 2)
        im = Image.fromarray(img, "CMYK") if mode == "CMYK" else \
            Image.fromarray(img).convert(mode)
        path = os.path.join(root, f"src{i}.jpg")
        im.save(path, "JPEG", quality=80, **kw)
        paths.append(path)
    return paths


def make_tree(root, **kw):
    """A CUB-shaped tree under ``root`` (12 train and 8 test records over
    4 classes, 3 captions an image unless ``kw`` says otherwise)."""
    os.makedirs(root, exist_ok=True)
    kw = dict(dict(n_train=12, n_test=8, n_classes=4, captions_per_image=3),
              **kw)
    return write_cub_tree(str(root), write_sources(str(root)), **kw)


def configs(data_dir, **extra):
    d = dict({"DATA_DIR": data_dir, "WORKERS": 2,
              "TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 16},
              "TEXT": {"CAPTIONS_PER_IMAGE": 3}}, **extra)
    return jconfig.cfg_from_dict(d), tconfig.cfg_from_dict(d)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native libraries, built whole before first use
    (ROADMAP F9; ``tests/test_native_build.py``)."""
    build_jax_native()
    assert jnative.exec_available()
    return jnative


@pytest.fixture(scope="module")
def tree(tmp_path_factory, jax_native):
    return make_tree(tmp_path_factory.mktemp("cub"))


@pytest.fixture(scope="module")
def cfgs(tree):
    return configs(tree)


@pytest.fixture(scope="module")
def tokenizers():
    return jtok.ClipTokenizer.fallback(), ttok.ClipTokenizer.load()


def datasets(cfgs, split="train", seed=0):
    jc, tc = cfgs
    return jds.TextImageDataset(jc, split, seed), \
        tds.TextImageDataset(tc, split, seed)


def assert_images(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.numpy() if torch.is_tensor(x) else x
        y = y.numpy() if torch.is_tensor(y) else y
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)


def assert_batches(jb, tb):
    assert jb.keys == tb.keys
    assert_images(jb.images, tb.images)
    for name in ("input_ids", "attention_mask", "input_ids_2",
                 "attention_mask_2", "class_ids"):
        np.testing.assert_array_equal(getattr(jb, name), getattr(tb, name))


# ------------------------------------------------------------- index ----

def test_tree_layout(tree):
    assert os.path.basename(tree) == "birds"
    for split, n in (("train", 12), ("test", 8)):
        with open(os.path.join(tree, split, "filenames.pickle"), "rb") as f:
            keys = pickle.load(f)
        assert len(keys) == n
        for k in keys:
            assert os.path.isfile(os.path.join(tree, "CUB_200_2011", "images",
                                               k + ".jpg"))
    with open(os.path.join(tree, "captions.pickle"), "rb") as f:
        train, test = pickle.load(f)
    assert len(train) == 36 and len(test) == 24


def test_bbox_table_matches_jax(tree):
    assert tds.load_bbox_table(tree) == jds.load_bbox_table(tree)


@pytest.mark.parametrize("bbox", [[5, 6, 20, 30], [0, 0, 64, 48],
                                  [50, 40, 30, 30], [-4, 3, 10, 60]])
def test_crop_to_bbox_matches_jax(bbox):
    img = smooth(48, 64, 3)
    want = np.asarray(jds.crop_to_bbox(Image.fromarray(img), bbox))
    np.testing.assert_array_equal(tds.crop_to_bbox(img, bbox), want)


@pytest.fixture(scope="module")
def legacy_tree(tmp_path_factory, tree):
    """The tree with captions as legacy word-index lists and ixtoword."""
    root = tmp_path_factory.mktemp("legacy") / "birds"
    shutil.copytree(tree, root)
    with open(root / "captions.pickle", "rb") as f:
        train, test = pickle.load(f)
    words = sorted({w for c in train + test for w in c.split()})
    wordtoix = {w: i for i, w in enumerate(words)}
    ixtoword = {i: w for w, i in wordtoix.items()}
    as_ix = [[[wordtoix[w] for w in c.split()] for c in caps]
             for caps in (train, test)]
    with open(root / "captions.pickle", "wb") as f:
        pickle.dump(as_ix + [ixtoword, wordtoix], f, protocol=2)
    return str(root)


@pytest.mark.parametrize("kind", ["plain", "legacy"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_caption_text_and_bank_match_jax(request, kind, split):
    data_dir = request.getfixturevalue("tree" if kind == "plain"
                                       else "legacy_tree")
    jd, td = datasets(configs(data_dir), split)
    n = len(td.captions)
    assert n == len(jd.captions) > 0
    assert [td.caption_text(i) for i in range(n)] == \
        [jd.caption_text(i) for i in range(n)]
    (jc, jcls), (tc, tcls) = jd.caption_bank(), td.caption_bank()
    assert jc == tc
    np.testing.assert_array_equal(jcls, tcls)


def test_caption_bank_refuses_a_misaligned_caption_count(cfgs):
    jd, td = datasets(cfgs)
    for d in (jd, td):
        d.captions = d.captions[:-1]
        with pytest.raises(ValueError, match="would misalign classes"):
            d.caption_bank()


def test_mis_captions_match_jax(cfgs):
    jd, td = datasets(cfgs, seed=5)
    for cls in (1, 2, 1):
        assert td.mis_captions(cls, 7) == jd.mis_captions(cls, 7)


def test_clip_token_dataset_matches_jax(cfgs, tokenizers):
    jc, tc = cfgs
    jt, tt = tokenizers
    jd = jclipds.ClipTokenDataset(jc, "train", tokenizer=jt, seed=3)
    td = tclipds.ClipTokenDataset(tc, "train", tokenizer=tt, seed=3)
    for i in [0, 5, 11, 5]:
        a, b = jd[i], td[i]
        assert_images(a.images, b.images)
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
        assert (a.cap_len, a.class_id, a.key) == (b.cap_len, b.class_id,
                                                  b.key)


# ------------------------------------------------------------ records ----

def test_native_plans_and_executor_match_jax(cfgs):
    """Plans of the same seed equal; both executors turn them into the
    same pyramids (the JAX one hands the CMYK file to PIL)."""
    jd, td = datasets(cfgs, seed=2)
    idx = list(range(len(td))) + [3, 0]
    jplans = [jd.plan_record(i) for i in idx]
    tplans = [td.plan_record(i) for i in idx]
    for a, b in zip(jplans, tplans):
        assert (a.path, a.bbox, a.u, a.v, a.flip, a.caption, a.caption_2,
                a.class_id, a.key) == (b.path, b.bbox, b.u, b.v, b.flip,
                                       b.caption, b.caption_2, b.class_id,
                                       b.key)
    kw = dict(branch_sizes=td.sizes, scale_size=td.transform.scale,
              crop=td.transform.imsize, max_batch=len(idx), n_threads=3,
              n_slots=1)
    outs = []
    for mod, plans in ((jnative, jplans), (native, tplans)):
        ex = mod.AsyncExecutor(**kw)
        uv = np.asarray([[p.u, p.v] for p in plans], np.float32)
        ex.submit(7, [p.path for p in plans], [p.bbox for p in plans], uv,
                  [p.flip for p in plans])
        bid, branches, errs = ex.wait()
        outs.append(([np.array(b) for b in branches], errs.copy()))
        ex.release(bid)
        ex.close()
    (jimg, jerr), (timg, terr) = outs
    assert not terr.any()
    for i, e in enumerate(jerr):
        if e:  # the JAX executor refuses CMYK: its fallback is PIL
            fb = jd.exec_fallback(jplans[i])
            for b in range(len(jimg)):
                jimg[b][i] = fb[b]
    assert_images(jimg, timg)
    assert jerr.any(), "the CMYK source should take the JAX fallback"


def test_thread_records_match_jax_getitem(cfgs):
    """``dataset[i]`` draws integer crops sized from the header: the same
    stream as the JAX ``__getitem__`` (which decodes first)."""
    jd, td = datasets(cfgs, seed=4)
    for i in list(range(len(td))) + [2, 9]:
        a, b = jd[i], td[i]
        assert_images(a.images, b.images)
        assert (a.caption, a.caption_2, a.class_id, a.key) == \
            (b.caption, b.caption_2, b.class_id, b.key)
    assert jd.rng.bit_generator.state == td.rng.bit_generator.state


def test_deterministic_record_matches_jax(cfgs):
    jd, td = datasets(cfgs, "test")
    state = td.rng.bit_generator.state
    for i in range(len(td)):
        a, b = jd.deterministic_record(i), td.deterministic_record(i)
        assert_images(a.images, b.images)
        assert (a.caption, a.caption_2, a.key) == (b.caption, b.caption_2,
                                                   b.key)
    assert td.rng.bit_generator.state == state


# ------------------------------------------------------------- loader ----

def loaders(cfgs, tokenizers, engine, workers, **kw):
    jd, td = datasets(cfgs)
    jt, tt = tokenizers
    jl = jpipe.DataLoader(jd, jt, 4, 77, num_workers=workers, engine=engine,
                          host_index=0, host_count=1, **kw)
    tl = tpipe.DataLoader(td, tt, 4, 77, num_workers=workers, engine=engine,
                          **kw)
    return jl, tl


@pytest.mark.parametrize("engine,workers", [("native", 1), ("native", 4),
                                            ("thread", 1)])
def test_loader_epochs_match_jax(cfgs, tokenizers, engine, workers):
    jl, tl = loaders(cfgs, tokenizers, engine, workers)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl) == 3
        for a, b in zip(jb, tb):
            assert_batches(a, b)
    assert jl.epoch == tl.epoch == 2
    assert jl.dataset.rng.bit_generator.state == \
        tl.dataset.rng.bit_generator.state
    jl.close()
    tl.close()


def test_thread_engine_at_four_workers_is_its_one_worker_stream(
        cfgs, tokenizers):
    one = tpipe.DataLoader(datasets(cfgs)[1], tokenizers[1], 4, 77,
                           num_workers=1, engine="thread")
    four = tpipe.DataLoader(datasets(cfgs)[1], tokenizers[1], 4, 77,
                            num_workers=4, engine="thread", pin_memory=False)
    for _ in range(2):
        for a, b in zip(list(one), list(four)):
            assert_batches(a, b)
            np.testing.assert_array_equal(a.images[0], b.images[0])


def test_peek_moves_neither_epoch_nor_generator(cfgs, tokenizers):
    jl, tl = loaders(cfgs, tokenizers, "native", 2)
    list(tl)
    state = tl.dataset.rng.bit_generator.state
    for with_images in (True, False):
        b = tl.peek(with_images=with_images)
        assert tl.epoch == 1 and tl.dataset.rng.bit_generator.state == state
        want = jl.peek()
        assert b.keys == want.keys
        np.testing.assert_array_equal(b.input_ids, want.input_ids)
        if with_images:
            assert_images(want.images, b.images)
        else:
            assert b.images is None


@pytest.mark.parametrize("engine", ["native", "thread"])
def test_caption_batches_draw_as_iteration_draws(cfgs, tokenizers, engine):
    """The sweep's captions without pixels: the same captions, and the
    generator left where iterating the loader leaves it."""
    _, a = loaders(cfgs, tokenizers, engine, 2)
    _, b = loaders(cfgs, tokenizers, engine, 2)
    for _ in range(2):
        full, caps = list(a), list(b.caption_batches())
        assert len(full) == len(caps)
        for x, y in zip(full, caps):
            assert y.images is None and x.keys == y.keys
            np.testing.assert_array_equal(x.input_ids, y.input_ids)
            np.testing.assert_array_equal(x.input_ids_2, y.input_ids_2)
            assert x.rng_state == y.rng_state
    assert a.epoch == b.epoch == 2


def test_native_executor_is_reused_in_fifo_order(cfgs, tokenizers):
    _, tl = loaders(cfgs, tokenizers, "native", 3, prefetch=1)
    list(tl)
    ex = tl._exec
    list(tl)
    assert tl._exec is ex
    # Interrupted mid-epoch, the executor drains and serves the next one.
    it = iter(tl)
    next(it)
    it.close()
    assert ex.inflight() == 0
    assert len(list(tl)) == 3
    td = tl.dataset
    plans = [td.plan_record(i) for i in range(6)]

    def submit(bid):
        p = plans[2 * (bid - 11): 2 * (bid - 10)]
        ex.submit(bid, [q.path for q in p], [q.bbox for q in p],
                  np.zeros((2, 2), np.float32), [False, False])

    order = []
    submit(11)
    submit(12)  # both slots (prefetch + 1) in flight
    for nxt in (13, None, None):
        bid, _, errs = ex.wait()
        order.append(bid)
        ex.release(bid)
        if nxt:
            submit(nxt)
    assert order == [11, 12, 13]
    tl.close()
    assert tl._exec is None


@pytest.mark.parametrize("engine", ["native", "thread"])
def test_a_bad_file_raises_naming_itself(tmp_path, tokenizers, engine):
    data_dir = make_tree(tmp_path, n_train=4, n_test=0, n_classes=2)
    td = tds.TextImageDataset(configs(data_dir)[1], "train")
    bad = td.image_path(td.filenames[2])
    with open(bad, "r+b") as f:
        f.truncate(200)
    tl = tpipe.DataLoader(td, tokenizers[1], 2, 77, num_workers=2,
                          engine=engine, shuffle=False)
    with pytest.raises(native.DecodeError) as e:
        list(tl)
    assert bad in str(e.value) and "error code 2" in str(e.value)
    os.remove(bad)
    with pytest.raises(native.DecodeError, match="cannot read"):
        list(tl)
    tl.close()


def test_prefetch_to_device_keeps_order():
    batches = [{"images": [np.full((2, 3, 3, 3), i, np.float32)],
                "ids": np.full((2, 4), i, np.int32), "keys": [f"k{i}"] * 2}
               for i in range(7)]
    out = list(tpipe.prefetch_to_device(iter(batches), "cpu", depth=2))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert torch.is_tensor(b["ids"]) and int(b["ids"][0, 0]) == i
        assert float(b["images"][0][0, 0, 0, 0]) == i
        assert b["keys"] == [f"k{i}"] * 2


def test_make_dataset_reads_the_tree(tree, capsys):
    _, tc = configs(tree)
    ds = make_dataset(tc, "train")
    assert isinstance(ds, tds.TextImageDataset) and len(ds) == 12
    syn = make_dataset(tc, "val")  # not in the tree: synthetic, as in JAX
    assert not isinstance(syn, tds.TextImageDataset)
    assert "not found; using synthetic data" in capsys.readouterr().out
    tc = tconfig.cfg_replace(tc, DATA_DIR="")
    assert not isinstance(make_dataset(tc, "train"), tds.TextImageDataset)


@pytest.mark.parametrize("call", ["resize_rgb", "pyramid", "pyramid_batch",
                                  "normalize_clip"])
def test_host_transforms_match_jax(call, jax_native):
    """The copied C++ transforms (and the numpy normalisation) against the
    JAX package's, on images of three shapes."""
    imgs = [smooth(h, w, h, texture=10.0) for h, w in
            ((45, 60), (70, 52), (33, 33))]
    sizes, scale, crop = (16, 32), 38, 32
    if call == "resize_rgb":
        for im in imgs:
            np.testing.assert_allclose(native.resize_rgb(im, 21, 17),
                                       jnative.resize_rgb(im, 21, 17),
                                       rtol=0, atol=TOL)
    elif call == "pyramid":
        for im in imgs:
            assert_images(native.pyramid(im, scale, crop, 2, 3, True, sizes),
                          jnative.pyramid(im, scale, crop, 2, 3, True, sizes))
    elif call == "pyramid_batch":
        xy, flips = [(0, 1), (4, 0), (6, 6)], [False, True, True]
        got = native.pyramid_batch(imgs, scale, crop, xy, flips, sizes)
        want = jnative.pyramid_batch(imgs, scale, crop, xy, flips, sizes)
        for g, w in zip(got, want):
            assert_images(g, w)
        with pytest.raises(ValueError, match="invalid crop window"):
            native.pyramid_batch(imgs, scale, crop, [(99, 0)] * 3, flips,
                                 sizes)
    else:
        np.testing.assert_allclose(tds.normalize_clip(imgs[0]),
                                   jds.normalize_clip(imgs[0]), rtol=0,
                                   atol=TOL)
