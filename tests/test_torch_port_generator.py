"""The port's generator (eval mode) against the JAX package's, on the CPU.

Each part (UpBlock, ResBlock, CANet, InitStageG, NextStageG) and the whole
``GNet`` is initialised in JAX, its batch statistics and BN shifts are
randomised (so eval BN is not the identity), and the variables cross
through ``load_jax_generator``.  Inputs are numpy arrays from a seed.
Tolerance 1e-4 absolute and relative in f32: the JAX package's UpBlock
variants and phased tail are reassociations of the port's plain
upsample + conv, which ``tests/test_models_gan.py`` holds to 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.models import generator as jgen
from t2igan_torch.config import Config, cfg_replace
from t2igan_torch.models import generator as tgen
from t2igan_torch.models.convert import load_jax_generator
from t2igan_torch.models.factory import build_generator


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
B, L = 2, 8
# SMALL of tests/test_models_gan.py.
SMALL = dict(gf_dim=16, nef=24, condition_dim=20, branch_num=3,
             num_residual=2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for name in ("T2IGAN_UPBLOCK", "T2IGAN_PHASED_TAIL", "T2IGAN_RESCHAIN",
                 "T2IGAN_MEMREAD"):
        monkeypatch.delenv(name, raising=False)


def _randomize_bn(variables, seed=7):
    """Random running statistics and BN shifts, the same on both sides."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, variables)

    def walk(tree, stats):
        out = {}
        for k, val in tree.items():
            if isinstance(val, dict):
                out[k] = walk(val, stats)
            elif stats and k == "mean":
                out[k] = rng.normal(0, 0.3, val.shape).astype(np.float32)
            elif stats and k == "var":
                out[k] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
            else:
                out[k] = val
        return out

    v["batch_stats"] = walk(v.get("batch_stats", {}), True)
    return v


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _inputs(rng):
    z = rng.standard_normal((B, 100)).astype(np.float32)
    sent = rng.standard_normal((B, 24)).astype(np.float32)
    words = rng.standard_normal((B, L, 24)).astype(np.float32)
    pad = np.array([[False] * 5 + [True] * 3, [False] * 7 + [True] * 1])
    eps = rng.standard_normal((B, 20)).astype(np.float32)
    return z, sent, words, pad, eps


@pytest.mark.parametrize("variant", ["dilated", "naive", "subpixel"])
def test_upblock(rng, variant):
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    block = jgen.UpBlock(features=4, variant=variant)
    v = _randomize_bn(jax.jit(functools.partial(block.init, train=False))(
        jax.random.PRNGKey(0), x))
    ref = jax.jit(functools.partial(block.apply, train=False))(v, x)
    port = load_jax_generator(tgen.UpBlock(8, 4, variant), v)
    with torch.no_grad():
        out = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **TOL)


def test_resblock(rng):
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    block = jgen.ResBlock(features=8)
    v = _randomize_bn(jax.jit(functools.partial(block.init, train=False))(
        jax.random.PRNGKey(0), x))
    ref = jax.jit(functools.partial(block.apply, train=False))(v, x)
    port = load_jax_generator(tgen.ResBlock(8), v)
    with torch.no_grad():
        out = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **TOL)


def test_canet_with_explicit_eps(rng):
    _, sent, _, _, eps = _inputs(rng)
    net = jgen.CANet(condition_dim=20)
    v = net.init(jax.random.PRNGKey(0), sent, eps)
    ref = net.apply(v, sent, eps)
    port = load_jax_generator(tgen.CANet(24, 20), jax.tree.map(np.asarray, v))
    with torch.no_grad():
        out = port(torch.from_numpy(sent), torch.from_numpy(eps))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_init_stage(rng):
    z, _, _, _, eps = _inputs(rng)
    c = eps  # any [B, condition_dim] code
    stage = jgen.InitStageG(ngf=16 * 16)
    v = _randomize_bn(jax.jit(functools.partial(stage.init, train=False))(
        jax.random.PRNGKey(0), z, c))
    ref = jax.jit(functools.partial(stage.apply, train=False))(v, z, c)
    port = load_jax_generator(tgen.InitStageG(16 * 16, 120), v)
    with torch.no_grad():
        out = port(torch.from_numpy(z), torch.from_numpy(c))
    assert out.shape == (B, 16, 64, 64)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("return_attn", [True, False])
def test_next_stage(rng, return_attn):
    _, _, words, pad, _ = _inputs(rng)
    h = rng.standard_normal((B, 16, 16, 16)).astype(np.float32)
    stage = jgen.NextStageG(ngf=16, nef=24, num_residual=2)
    v = _randomize_bn(jax.jit(functools.partial(stage.init, train=False))(
        jax.random.PRNGKey(0), h, words, pad))
    ref, ref_attn = jax.jit(functools.partial(
        stage.apply, train=False, return_attn=return_attn))(v, h, words, pad)
    port = load_jax_generator(tgen.NextStageG(16, 24, 2), v)
    with torch.no_grad():
        out, attn = port(_nchw(h), torch.from_numpy(words),
                         torch.from_numpy(pad), return_attn)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **TOL)
    if return_attn:
        np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), **TOL)
    else:
        assert attn is None and ref_attn is None


@functools.lru_cache(maxsize=None)
def _gnet_variables():
    z, sent, words, pad, eps = _inputs(np.random.default_rng(0))
    init = jax.jit(functools.partial(GNET_PLAIN.init, train=False))
    return _randomize_bn(init({"params": jax.random.PRNGKey(0),
                               "gaussian": jax.random.PRNGKey(1)},
                              z, sent, words, pad, ca_eps=eps))


GNET_PLAIN = jgen.GNet(**SMALL)


@pytest.mark.parametrize("phased_tail, upblock", [
    (True, "dilated"), (False, "dilated"), (True, "naive"), (False, "naive")])
def test_gnet(rng, phased_tail, upblock):
    """Every image of the pyramid, with GAN.PHASED_TAIL on (the default)
    and off and the dilated and naive UpBlocks, against
    ``GNet.apply(train=False, return_attn=False)``."""
    z, sent, words, pad, eps = _inputs(rng)
    v = _gnet_variables()
    model = jgen.GNet(**SMALL, upblock=upblock, phased_tail=phased_tail)
    apply = jax.jit(functools.partial(model.apply, train=False,
                                      return_attn=False))
    ref, atts, ref_mu, _ = apply(v, z, sent, words, pad, ca_eps=eps)
    assert atts == []
    port = load_jax_generator(tgen.GNet(**SMALL, upblock=upblock).eval(), v)
    with torch.no_grad():
        imgs, att_maps, mu, _ = port(
            torch.from_numpy(z), torch.from_numpy(sent),
            torch.from_numpy(words), torch.from_numpy(pad),
            torch.from_numpy(eps), return_attn=False)
    assert att_maps == []
    assert [tuple(i.shape) for i in imgs] == [(B, s, s, 3)
                                              for s in (64, 128, 256)]
    for a, b in zip(imgs, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), **TOL)


def test_gnet_attention_maps(rng):
    z, sent, words, pad, eps = _inputs(rng)
    v = _gnet_variables()
    apply = jax.jit(functools.partial(GNET_PLAIN.apply, train=False))
    _, ref_atts, _, _ = apply(v, z, sent, words, pad, ca_eps=eps)
    port = load_jax_generator(tgen.GNet(**SMALL).eval(), v)
    with torch.no_grad():
        _, atts, _, _ = port(torch.from_numpy(z), torch.from_numpy(sent),
                             torch.from_numpy(words), torch.from_numpy(pad),
                             torch.from_numpy(eps))
    assert [tuple(a.shape) for a in atts] == [(B, 64, 64, L),
                                              (B, 128, 128, L)]
    for a, b in zip(atts, ref_atts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_bridge_rejects_mismatched_branch_count():
    with pytest.raises(ValueError, match="NextStageG_1"):
        load_jax_generator(tgen.GNet(**dict(SMALL, branch_num=2)),
                           _gnet_variables())


def test_bridge_rejects_misshaped_kernel():
    v = jax.tree.map(lambda a: a, _gnet_variables())
    v["params"]["NextStageG_0"]["key"]["kernel"] = np.zeros((16, 16),
                                                            np.float32)
    with pytest.raises(ValueError, match="NextStageG_0/key/kernel"):
        load_jax_generator(tgen.GNet(**SMALL), v)


def test_fused_tail_builds_a_fused_generator():
    """GAN.FUSED_TAIL gives a generator whose refinement stages take the
    fused eval tail (tests/test_torch_port_reschain.py checks its
    outputs); the parameter layout is the plain one."""
    cfg = cfg_replace(Config(), GAN={"FUSED_TAIL": True, "GF_DIM": 16,
                                     "Z_DIM": 10, "CONDITION_DIM": 12},
                      TEXT={"EMBEDDING_DIM": 24})
    gen = build_generator(cfg)
    assert gen.fused_tail and all(s.fused_tail for s in gen.next_stages)
    plain = build_generator(cfg_replace(cfg, GAN={"FUSED_TAIL": False}))
    assert not plain.fused_tail
    assert {k: v.shape for k, v in gen.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}


def test_unknown_upblock_variant_raises():
    with pytest.raises(ValueError, match="UpBlock variant"):
        build_generator(cfg_replace(Config(), GAN={"UPBLOCK": "pallas"}))


@pytest.mark.parametrize("upblock", ["dilated", "naive", "subpixel"])
def test_factory_widths(upblock):
    cfg = cfg_replace(Config(), GAN={"GF_DIM": 16, "UPBLOCK": upblock,
                                     "R_NUM": 1, "Z_DIM": 10,
                                     "CONDITION_DIM": 12},
                      TEXT={"EMBEDDING_DIM": 24}, TREE={"BRANCH_NUM": 2})
    gen = build_generator(cfg)
    assert not gen.training
    assert len(gen.next_stages) == 1 and len(gen.image_heads) == 2
    assert len(gen.next_stages[0].residual) == 1
    assert gen.init_stage.fc.in_features == 22
    assert gen.ca_net.fc.in_features == 24
