"""FID and IS from image directories: the port against the JAX package on
the CPU.

A directory of mixed sizes and formats (PNG and JPEG, square and not; the
JAX package decodes with libjpeg/libpng, the port with its own decoder):
``list_images`` gives the JAX order and ``image_batches`` its arrays
(1e-6: both resize to 299 with torch's bilinear filter, the JAX package as
float32 matrices, the port in float64 rounded once).  With
the JAX Inception-v3's random variables (moved batch statistics) carried
into the port by ``load_jax_inception``: ``statistics_of_path`` and
``calculate_fid_given_paths`` agree to 1e-4 relative on mu and sigma (each
against its largest entry; at the 64 tap, and on unlike pictures, so that
the covariance is not all cancellation) and 1e-3 on their FID, also from
``.npz`` statistics; ``scale32_batches`` (PIL's
``Scale(32)`` reproduced without PIL) is bitwise the JAX package's;
``make_pred_fn`` and ``inception_score`` agree to 1e-4.  Both CLIs run
with ``--device cpu``.  The Inception models are built once per module.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from make_torch_port_fixtures import smooth
from test_torch_port_data import jax_native  # noqa: F401
from test_torch_port_inception import _randomize_stats
from t2igan.evaluation import fid as jfid
from t2igan.evaluation import inception_score as jis
from t2igan.models import inception as jinc
from t2igan_torch import fid_score as tfid_cli
from t2igan_torch import inception_score as tis_cli
from t2igan_torch.evaluation import fid as tfid
from t2igan_torch.evaluation import inception_score as tis
from t2igan_torch.models import inception as tinc
from t2igan_torch.models.convert import load_jax_inception


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


def contents(h, w, seed):
    """Four unlike pictures (smooth, noise, stripes, flat), so that the
    Inception features differ well beyond their rounding."""
    rng = np.random.default_rng(seed)
    stripes = np.zeros((h, w, 3), np.uint8)
    stripes[::4] = (250, 30, 30)
    flat = np.full((h, w, 3), (20, 140, 220), np.uint8)
    return [smooth(h, w, seed, 12.0),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8), stripes, flat]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, jax_native):
    """``gen``: 4 square PNGs (a sweep's output); ``real``: JPEGs and PNGs
    of mixed sizes in two subdirectories, plus a file that is not an
    image."""
    root = tmp_path_factory.mktemp("fid")
    gen, real = root / "gen", root / "real"
    for d in (gen, real / "a", real / "b"):
        d.mkdir(parents=True)
    for i, img in enumerate(contents(64, 64, 0)):
        Image.fromarray(img).save(gen / f"{i}_0.png")
    shapes = [(75, 100), (100, 75), (299, 299), (40, 56)]
    for i, (h, w) in enumerate(shapes):
        im = Image.fromarray(contents(h, w, 10)[i])
        sub = real / ("a" if i % 2 else "b")
        if i == 3:
            im.save(sub / f"img{i}.PNG")
        else:
            im.save(sub / f"img{i}.jpg", quality=85, subsampling=i % 3)
    (real / "a" / "notes.txt").write_text("not an image")
    return str(gen), str(real)


@pytest.fixture(scope="module")
def fid_models():
    model = jinc.InceptionV3(variant="fid", num_classes=1008)
    v = _randomize_stats(jax.jit(model.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 75, 75, 3))), 5)
    port = load_jax_inception(tinc.InceptionV3("fid").eval(), v)
    return v, port


@pytest.fixture(scope="module")
def is_models():
    model = jinc.InceptionV3(variant="torchvision", num_classes=1000)
    v = _randomize_stats(jax.jit(model.init)(jax.random.PRNGKey(4),
                                    jnp.zeros((1, 75, 75, 3))), 6)
    port = load_jax_inception(tinc.InceptionV3("torchvision").eval(), v)
    return v, port


def test_list_images_and_batches_match_jax(dirs):
    for d in dirs:
        files = tfid.list_images(d)
        assert files == jfid.list_images(d) and len(files) == 4
        jb = list(jfid.image_batches(files, 3))
        tb = list(tfid.image_batches(files, 3))
        assert [b.shape for b in tb] == [(3, 299, 299, 3), (1, 299, 299, 3)]
        for a, b in zip(jb, tb):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def stats(dirs, fid_models):
    """(JAX, port) statistics of both directories at the 64 tap (pool1,
    ``--dims 64``: XLA compiles the JAX network only that far), batches of
    4 (one compiled shape)."""
    v, port = fid_models
    jfn = jfid.make_activation_fn(v, dims=64)
    tfn = tfid.make_activation_fn(port, dims=64)
    return ([jfid.statistics_of_path(d, jfn, 4) for d in dirs],
            [tfid.statistics_of_path(d, tfn, 4) for d in dirs], tfn)


def test_statistics_of_path_match_jax(stats):
    jst, tst, _ = stats
    for (jm, js), (tm, ts) in zip(jst, tst):
        assert tm.shape == (64,) and ts.shape == (64, 64)
        scale = np.abs(jm).max()
        np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_allclose(ts, js, rtol=1e-4,
                                   atol=1e-4 * np.abs(js).max())


def test_fid_of_paths_and_of_npz_match_jax(stats, dirs, tmp_path):
    jst, tst, tfn = stats
    want = jfid.frechet_distance(*jst[0], *jst[1])
    got = tfid.frechet_distance(*tst[0], *tst[1])
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    npz = tmp_path / "real.npz"
    np.savez(npz, mu=tst[1][0], sigma=tst[1][1])
    m, s = tfid.statistics_of_path(str(npz), tfn)
    np.testing.assert_array_equal(m, tst[1][0])
    assert tfid.calculate_fid_given_paths([dirs[0], str(npz)], tfn, 3) == \
        pytest.approx(got, rel=1e-9)


def test_empty_directory_raises(tmp_path, stats):
    with pytest.raises(ValueError, match="no images under"):
        tfid.statistics_of_path(str(tmp_path), stats[2])


def test_scale32_batches_are_jax_bitwise(dirs):
    files = tfid.list_images(dirs[0])
    jb = list(jis.scale32_batches(files, 3))
    tb = list(tis.scale32_batches(files, 3))
    assert [b.shape for b in tb] == [(3, 32, 32, 3), (1, 32, 32, 3)]
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)
    # Non-square files: the shorter side to 32, as Scale(32).
    for f in tfid.list_images(dirs[1]):
        np.testing.assert_array_equal(tis.scale32(f), jis._scale32_one(f, 32))
    with pytest.raises(ValueError, match="mixed post-Scale"):
        list(tis.scale32_batches(tfid.list_images(dirs[1]), 4))


def test_pred_fn_and_inception_score_match_jax(dirs, is_models):
    """One compiled JAX network (batches of 4): its predictions on random
    inputs and on the directory's Scale(32) batches, and the score of
    ``t2igan.evaluation.inception_score.inception_score``'s arithmetic."""
    v, port = is_models
    jfn, tfn = jis.make_pred_fn(v), tis.make_pred_fn(port)
    x = np.random.default_rng(0).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    got = tfn(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    files = tfid.list_images(dirs[0])
    preds = np.concatenate([np.asarray(jfn(jnp.asarray(b)))
                            for b in jis.scale32_batches(files, 4)])
    want = jis.inception_score_from_preds(preds, 2)
    got = tis.inception_score(dirs[0], port, batch_size=4, splits=2)
    np.testing.assert_allclose(got, want, **TOL)


def test_inception_score_from_preds_matches_jax():
    p = np.random.default_rng(1).dirichlet(np.ones(10) * 0.3, 40)
    assert tis.inception_score_from_preds(p, 4) == \
        jis.inception_score_from_preds(p, 4)


def test_fid_cli_runs_on_the_cpu(dirs, capsys, fid_models, tmp_path):
    ckpt = tmp_path / "fid.pt"
    torch.save(fid_models[1].state_dict(), ckpt)
    fid = tfid_cli.main(["--path", *dirs, "--dims", "64", "--batch_size",
                         "4", "--device", "cpu", "--inception_ckpt",
                         str(ckpt)])
    out = capsys.readouterr().out
    assert f"Loaded inception weights: {ckpt}" in out
    assert "FID: " in out and np.isfinite(fid)
    with pytest.raises(SystemExit):
        tfid_cli.main(["--device", "cpu"])


def test_is_cli_runs_on_the_cpu(dirs, capsys):
    mean, std = tis_cli.main(["--path", dirs[0], "--splits", "2",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "WARNING: no inception checkpoint found" in out
    assert f"IS mean: {mean:.4f} std: {std:.4f}" in out
    assert mean >= 1.0


def test_clis_default_to_the_card(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfid_cli.main(["--path", *dirs])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tis_cli.main(["--path", dirs[0]])
