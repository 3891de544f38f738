"""The port's FID Inception-v3 and FID helpers against the JAX package's,
on the CPU.

Both variants are initialised in JAX with random BatchNorm statistics and
cross through ``load_jax_inception``; inputs are numpy arrays from a seed,
at batch 2 and 99 px, which keeps every tap non-empty (the smallest such
input is 75 px) and the test fast.  Tolerances, f32: every tap and the
logits to 1e-4 of their largest magnitude, relative 1e-4 (~95 convs in
another summation order); ``preprocess`` to 4 * size * 2^-24 (torch
takes the source coordinates of the bilinear resize in f32);
``frechet_distance`` to 1e-9 relative (the same float64 numpy code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.evaluation import fid as jfid
from t2igan.models import inception as jinc
from t2igan_torch.evaluation import fid as tfid
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


SIZE = 99


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, variables)

    def walk(tree):
        out = {}
        for k, val in tree.items():
            if isinstance(val, dict):
                out[k] = walk(val)
            elif k == "mean":
                out[k] = rng.normal(0, 0.1, val.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
        return out

    v["batch_stats"] = walk(v["batch_stats"])
    return v


_VARIABLES = {}


def _pair(variant):
    """(JAX model, its variables, the port model loaded from them)."""
    model = jinc.InceptionV3(variant=variant,
                             num_classes=1008 if variant == "fid" else 1000)
    if variant not in _VARIABLES:
        _VARIABLES[variant] = _randomize_stats(
            model.init(jax.random.PRNGKey(7),
                       jnp.zeros((1, SIZE, SIZE, 3))), 3)
    v = _VARIABLES[variant]
    port = load_jax_inception(tinc.InceptionV3(variant).eval(), v)
    return model, v, port


@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_every_tap_matches_jax(variant):
    model, v, port = _pair(variant)
    x = np.random.default_rng(0).uniform(
        -1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = model.apply(v, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert sorted(out) == sorted(ref) == ["logits", "mixed6e", "pool1",
                                          "pool2", "pool3"]
    assert out["logits"].shape == (2, 1008 if variant == "fid" else 1000)
    for tap, r in ref.items():
        r = np.asarray(r)
        assert tuple(out[tap].shape) == r.shape, tap
        np.testing.assert_allclose(out[tap].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=tap)


def test_the_variants_differ_in_their_pools():
    """The FID patches change the output: the same weights give other
    features under the torchvision pooling."""
    _, v, fid = _pair("fid")
    tv = tinc.InceptionV3("torchvision").eval()
    sd = {k: t for k, t in fid.state_dict().items() if not k.startswith("fc")}
    tv.load_state_dict(sd, strict=False)
    x = torch.rand((1, SIZE, SIZE, 3)) * 2 - 1
    with torch.no_grad():
        a, b = fid(x)["pool3"], tv(x)["pool3"]
    assert not torch.allclose(a, b)


def test_parameter_names_are_torchvisions():
    names = tinc.InceptionV3("fid").state_dict()
    for key in ("Mixed_5b.branch1x1.conv.weight",
                "Mixed_5b.branch5x5_1.bn.running_var",
                "Mixed_6e.branch7x7dbl_5.conv.weight",
                "Mixed_7a.branch7x7x3_4.bn.weight",
                "Mixed_7c.branch3x3dbl_3b.conv.weight", "fc.weight"):
        assert key in names
    assert not any("fused1x1" in k for k in names)


def test_bridge_rejects_a_mismatched_tree():
    _, v, _ = _pair("fid")
    with pytest.raises((KeyError, ValueError)):
        load_jax_inception(tinc.InceptionV3("torchvision"), v)
    bad = jax.tree.map(lambda a: a, v)
    k = bad["params"]["Mixed_5b"]["fused1x1"]["conv"]["kernel"]
    bad["params"]["Mixed_5b"]["fused1x1"]["conv"]["kernel"] = k[..., :-1]
    with pytest.raises(ValueError, match="Mixed_5b"):
        load_jax_inception(tinc.InceptionV3("fid"), bad)


@pytest.mark.parametrize("size", [256, 64])
def test_preprocess_matches_jax(size):
    x = np.random.default_rng(size).uniform(
        0, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jinc.preprocess(jnp.asarray(x)))
    out = tinc.preprocess(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape == (2, 299, 299, 3)
    # torch takes each source coordinate in f32: up to size * 2^-24 off in
    # a bilinear weight, doubled by the rescale to [-1, 1], twice (rows
    # and columns).
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=4 * size * 2.0 ** -24)


def test_preprocess_keeps_a_299_input():
    x = torch.rand((1, 299, 299, 3))
    torch.testing.assert_close(tinc.preprocess(x), 2 * x - 1, rtol=0,
                               atol=1e-6)


def test_frechet_distance_matches_jax(rng):
    a = rng.standard_normal((40, 8))
    b = rng.standard_normal((50, 8)) * 1.3 + 0.2
    stats = [(x.mean(0), np.cov(x, rowvar=False)) for x in (a, b)]
    got = tfid.frechet_distance(*stats[0], *stats[1])
    want = jfid.frechet_distance(*stats[0], *stats[1])
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert abs(tfid.frechet_distance(*stats[0], *stats[0])) < 1e-9
    # A singular covariance takes the same path on both sides.
    flat = np.zeros((8, 8))
    np.testing.assert_allclose(
        tfid.frechet_distance(stats[0][0], flat, stats[1][0], flat),
        jfid.frechet_distance(stats[0][0], flat, stats[1][0], flat),
        rtol=1e-9)


def test_taps_by_dim_match_jax():
    assert tfid.TAP_BY_DIM == jfid.TAP_BY_DIM


@pytest.mark.parametrize("dims", [64, 2048])
def test_activation_fn_averages_the_tap(dims):
    port = tinc.init_inception_(tinc.InceptionV3("fid").eval(),
                                torch.Generator().manual_seed(0))
    x = torch.rand((2, 80, 80, 3))
    got = tfid.make_activation_fn(port, dims)(x)
    with torch.no_grad():
        feat = port(tinc.preprocess(x))[tfid.TAP_BY_DIM[dims]]
    want = feat.mean(dim=(1, 2)) if feat.dim() == 4 else feat
    assert got.shape == (2, dims)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dims"):
        tfid.make_activation_fn(port, 100)


def test_compute_statistics(rng):
    acts = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2)]
    mu, sigma = tfid.compute_statistics(torch.from_numpy, acts)
    a = np.concatenate(acts).astype(np.float64)
    np.testing.assert_allclose(mu, a.mean(0))
    np.testing.assert_allclose(sigma, np.cov(a, rowvar=False))


def test_random_init_keeps_the_scale():
    port = tinc.init_inception_(tinc.InceptionV3("fid").eval(),
                                torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = port(torch.rand((2, SIZE, SIZE, 3)) * 2 - 1)
    assert all(torch.isfinite(t).all() for t in out.values())
    assert 1e-2 < out["pool3"].abs().mean() < 1e2

