"""The train slice's modules against the JAX package's, on the CPU: the
CLIP vision side, spectral-norm convs, the discriminators, the losses, the
generator in train mode and the nearest resize.

Widths are ``TINY_CLIP`` and ``CFG`` of ``tests/test_train_steps.py``.
JAX variables come from ``.init`` and cross through the port's loaders;
inputs are numpy arrays from a seed.  Tolerance 1e-4 absolute and
relative in f32 (the JAX package's own torch-oracle bound), 1e-5 for the
losses and the resize, which are a few elementwise ops and reductions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_train_steps import CFG, TINY_CLIP
from t2igan import losses as jl
from t2igan.models import clip as jclip
from t2igan.models import generator as jgen
from t2igan.models.discriminator import DNetWithHeads as JDNet
from t2igan.models.factory import build_generator as jbuild_generator
from t2igan.ops.image import resize_nearest as jresize
from t2igan.ops.spectral import SNConv as JSNConv
from t2igan_torch import config as tconfig
from t2igan_torch import losses as tl
from t2igan_torch.models import clip as tclip
from t2igan_torch.models import generator as tgen
from t2igan_torch.models.convert import (load_jax_clip, load_jax_discriminator,
                                         load_jax_generator)
from t2igan_torch.models.discriminator import DNetWithHeads
from t2igan_torch.models.factory import (build_clip, build_discriminators,
                                         build_generator)
from t2igan_torch.ops.image import resize_nearest
from t2igan_torch.ops.spectral import SNConv


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
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TCFG = tconfig.cfg_from_dict(dataclasses.asdict(CFG))


def port_clip_cfg(jcfg: jclip.ClipConfig) -> tclip.ClipConfig:
    kw = dataclasses.asdict(jcfg)
    return tclip.ClipConfig(**dict(kw, text=tclip.ClipTowerConfig(**kw["text"]),
                                   vision=tclip.ClipTowerConfig(**kw["vision"])))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- CLIP ----

@functools.lru_cache(maxsize=None)
def _clip_pair():
    jmodel = jclip.ClipWithRegionHead(TINY_CLIP)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    params = _np(variables["params"])
    params["logit_scale"] = np.asarray(1.5, np.float32)  # not the init value
    tmodel = load_jax_clip(build_clip(port_clip_cfg(TINY_CLIP)), params)
    return jmodel, params, tmodel


def test_encode_image_verbose(rng):
    jmodel, params, tmodel = _clip_pair()
    pixels = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    jsubr, jimg = jax.jit(functools.partial(
        jmodel.apply, method=jclip.ClipWithRegionHead.encode_image_verbose))(
        {"params": params}, jnp.asarray(pixels))
    with torch.no_grad():
        subr, img = tmodel.encode_image_verbose(_t(pixels))
    assert subr.shape == (3, 5, 32) and img.shape == (3, 32)
    np.testing.assert_allclose(subr.numpy(), np.asarray(jsubr), **TOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **TOL)
    assert tmodel.logit_scale.item() == 1.5


def test_vision_tower(rng):
    jmodel, params, tmodel = _clip_pair()
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tower = jclip.VisionTower(TINY_CLIP)
    jh, jp = jax.jit(tower.apply)({"params": params["vision_model"]},
                                  jnp.asarray(pixels))
    with torch.no_grad():
        h, p = tmodel.vision_model(_t(pixels))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)


def test_full_clip_loader_keeps_the_text_side(rng):
    jmodel, params, tmodel = _clip_pair()
    ids = rng.integers(1, 511, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    jw, js = jax.jit(functools.partial(
        jmodel.apply, method=jclip.ClipWithRegionHead.encode_text_verbose))(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        w, s = tmodel.encode_text_verbose(_t(ids), _t(mask))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("break_it, match", [
    (lambda p: p["vision_model"].pop("class_embedding"), "missing"),
    (lambda p: p["linear_subr"].update(bias=np.zeros(3, np.float32)),
     "shape"),
    (lambda p: p.update(extra={"kernel": np.zeros(2, np.float32)}),
     "no module"),
])
def test_full_clip_loader_raises(break_it, match):
    _, params, _ = _clip_pair()
    broken = jax.tree.map(lambda x: x, params)
    break_it(broken)
    with pytest.raises((KeyError, ValueError), match=match):
        load_jax_clip(build_clip(port_clip_cfg(TINY_CLIP)), broken)


# ------------------------------------------------------- spectral norm ----

def test_sn_conv_stores_once_and_freezes(rng):
    """A mutable apply stores the new u/v; a frozen one computes the same
    output from the stored u and leaves it."""
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    conv = JSNConv(6, (4, 4), strides=2, padding=1)
    v = _np(conv.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    v["params"]["bias"] = rng.standard_normal(6).astype(np.float32)
    # Not orthogonal: an orthogonal kernel's rows make u a fixed point.
    v["params"]["kernel"] = rng.standard_normal((4, 4, 5, 6)).astype(
        np.float32)
    y_mut, upd = conv.apply(v, jnp.asarray(x), mutable=["spectral"])
    y_frozen = conv.apply(v, jnp.asarray(x))
    port = SNConv(5, 6, 4, stride=2, padding=1)
    with torch.no_grad():
        port.weight.copy_(_t(v["params"]["kernel"]).permute(3, 2, 0, 1))
        port.bias.copy_(_t(v["params"]["bias"]))
        port.u.copy_(_t(v["spectral"]["u"]))
        port.v.copy_(_t(v["spectral"]["v"]))
        xt = _t(x).permute(0, 3, 1, 2)
        frozen = port(xt)
        np.testing.assert_array_equal(port.u.numpy(), v["spectral"]["u"])
        stored = port(xt, update=True)
    np.testing.assert_allclose(frozen.permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_frozen), **TOL)
    np.testing.assert_allclose(stored.permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_mut), **TOL)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(upd["spectral"][name]), **TOL)
        assert not np.allclose(getattr(port, name).numpy(),
                               v["spectral"][name])


def test_sn_conv_gradient_flows_through_sigma(rng):
    """d/dW of sum(conv) through W / sigma(W) against jax.grad."""
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    conv = JSNConv(4, (3, 3))
    v = _np(conv.init(jax.random.PRNGKey(5), jnp.asarray(x)))

    def f(kernel):
        p = dict(v["params"], kernel=kernel)
        return jnp.sum(jnp.tanh(conv.apply({"params": p,
                                            "spectral": v["spectral"]},
                                           jnp.asarray(x))))

    ref = jax.grad(f)(jnp.asarray(v["params"]["kernel"]))
    port = SNConv(3, 4, 3)
    with torch.no_grad():
        port.weight.copy_(_t(v["params"]["kernel"]).permute(3, 2, 0, 1))
        port.u.copy_(_t(v["spectral"]["u"]))
        port.v.copy_(_t(v["spectral"]["v"]))
    torch.tanh(port(_t(x).permute(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(port.weight.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(ref), **TOL)


# ------------------------------------------------------ discriminators ----

@pytest.mark.parametrize("size", [64, 128, 256])
def test_discriminator_with_heads(rng, size):
    x = (rng.standard_normal((3, size, size, 3)) * 0.5).astype(np.float32)
    c = rng.standard_normal((3, 32)).astype(np.float32)
    jd = JDNet(ndf=4, nef=32, img_size=size)
    v = _np(jax.jit(jd.init)(jax.random.PRNGKey(size), jnp.asarray(x),
                             jnp.asarray(c)))

    @jax.jit
    def run(v, x, c):
        h, upd = jd.apply(v, x, method=jd.features, mutable=["spectral"])
        dv = {"params": v["params"], "spectral": upd["spectral"]}
        return (h, upd, jd.apply(dv, h, c, method=jd.cond),
                jd.apply(dv, h, method=jd.uncond))

    h, upd, cond, uncond = run(v, jnp.asarray(x), jnp.asarray(c))

    port = load_jax_discriminator(DNetWithHeads(4, 32, size), v)
    with torch.no_grad():
        th = port.features(_t(x), update_spectral=True)
        tcond, tuncond = port.cond(th, _t(c)), port.uncond(th)
    assert th.shape == (3, 4, 4, 32)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(tcond.numpy(), np.asarray(cond), **TOL)
    np.testing.assert_allclose(tuncond.numpy(), np.asarray(uncond), **TOL)
    # The trunk stored its u/v; the conditional head's never moved.
    again = load_jax_discriminator(DNetWithHeads(4, 32, size),
                                   {"params": v["params"],
                                    "spectral": _np(upd["spectral"])})
    for (name, a), (_, b) in zip(port.state_dict().items(),
                                 again.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)
    head_u = v["spectral"]["cond_head"]["Block3x3Leaky_0"]["SNConv_0"]["u"]
    np.testing.assert_array_equal(port.cond_head.joint.conv.u.numpy(), head_u)


def test_discriminator_loader_and_factory_checks():
    ds = build_discriminators(TCFG)
    assert [d.img_size for d in ds] == [64, 128]
    jd = JDNet(ndf=4, nef=32, img_size=64)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 32)))
    v = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    with pytest.raises(KeyError, match="missing"):
        load_jax_discriminator(DNetWithHeads(4, 32, 128), v)
    with pytest.raises(ValueError, match="no module"):
        load_jax_discriminator(DNetWithHeads(4, 32, 64, b_jcu=False), v)
    with pytest.raises(ValueError, match="shape"):
        load_jax_discriminator(DNetWithHeads(8, 32, 64), v)
    with pytest.raises(ValueError, match="D_NET64 got a 32x32"):
        DNetWithHeads(4, 32, 64).features(torch.zeros(1, 32, 32, 3))
    dc = build_discriminators(tconfig.cfg_replace(TCFG, GAN={"B_DCGAN": True}))
    assert len(dc) == 1 and dc[0].uncond_head is None
    with pytest.raises(ValueError, match="BASE_SIZE"):
        build_discriminators(tconfig.cfg_replace(TCFG,
                                                 TREE={"BASE_SIZE": 32}))


# -------------------------------------------------------------- losses ----

def test_gan_losses(rng):
    lo = [rng.standard_normal(8).astype(np.float32) for _ in range(5)]
    for target in (0.0, 1.0, 0.3):
        np.testing.assert_allclose(
            tl.bce_with_logits(_t(lo[0]), target).item(),
            float(jl.bce_with_logits(jnp.asarray(lo[0]), target)), **LOSS_TOL)
    for uncond in (True, False):
        args = lo if uncond else lo[:3] + [None, None]
        ours, aux = tl.discriminator_loss(*[None if a is None else _t(a)
                                            for a in args])
        ref, raux = jl.discriminator_loss(*[None if a is None
                                            else jnp.asarray(a)
                                            for a in args])
        np.testing.assert_allclose(ours.item(), float(ref), **LOSS_TOL)
        for k in ("real_acc", "fake_acc"):
            np.testing.assert_allclose(aux[k].item(), float(raux[k]),
                                       **LOSS_TOL)
        u = _t(lo[3]) if uncond else None
        np.testing.assert_allclose(
            tl.generator_adv_loss(_t(lo[0]), u).item(),
            float(jl.generator_adv_loss(jnp.asarray(lo[0]),
                                        None if u is None
                                        else jnp.asarray(lo[3]))),
            **LOSS_TOL)
    c = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tl.wrong_pair(_t(c)).numpy(),
                                  np.asarray(jl.wrong_pair(jnp.asarray(c))))


@pytest.mark.parametrize("classes", [None, [0, 1, 0, 2, 1, 3]])
def test_damsm_losses(rng, classes):
    b, l, p, d = 6, 9, 5, 16
    words = rng.standard_normal((b, l, d)).astype(np.float32)
    regions = rng.standard_normal((b, p, d)).astype(np.float32)
    mask = np.arange(l)[None, :] < rng.integers(2, l + 1, b)[:, None]
    cnn = rng.standard_normal((b, d)).astype(np.float32)
    rnn = rng.standard_normal((b, d)).astype(np.float32)
    cls = None if classes is None else np.asarray(classes, np.int32)
    tcls = None if cls is None else _t(cls)
    jcls = None if cls is None else jnp.asarray(cls)
    for m in (mask, None):
        tm = None if m is None else _t(m)
        jm = None if m is None else jnp.asarray(m)
        np.testing.assert_allclose(
            tl.attention_match_scores(_t(words), _t(regions), tm, 4.0,
                                      5.0).numpy(),
            np.asarray(jl.attention_match_scores(
                jnp.asarray(words), jnp.asarray(regions), jm, 4.0, 5.0)),
            **LOSS_TOL)
        for a, r in zip(tl.words_loss(_t(regions), _t(words), tcls, tm,
                                      4.0, 5.0, 10.0),
                        jl.words_loss(jnp.asarray(regions),
                                      jnp.asarray(words), jcls, jm,
                                      4.0, 5.0, 10.0)):
            np.testing.assert_allclose(a.item(), float(r), **LOSS_TOL)
    for a, r in zip(tl.sent_loss(_t(cnn), _t(rnn), tcls, 10.0),
                    jl.sent_loss(jnp.asarray(cnn), jnp.asarray(rnn), jcls,
                                 10.0)):
        np.testing.assert_allclose(a.item(), float(r), **LOSS_TOL)
    np.testing.assert_allclose(
        tl.kl_loss(_t(cnn), _t(rnn) * 0.1).item(),
        float(jl.kl_loss(jnp.asarray(cnn), jnp.asarray(rnn) * 0.1)),
        **LOSS_TOL)
    np.testing.assert_allclose(
        tl.nt_xent_loss(_t(cnn), _t(rnn), 0.5).item(),
        float(jl.nt_xent_loss(jnp.asarray(cnn), jnp.asarray(rnn), 0.5)),
        **LOSS_TOL)


# ------------------------------------------------ generator, train mode ----

def _stats(module):
    return {k: v.numpy().copy() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_batch_norm_train_updates_as_flax(rng):
    """InitStageG's BN runs over [B, features] with n = B = 4: flax's
    running variance takes the biased batch variance, a stock
    ``F.batch_norm(training=True)`` the unbiased one, 4/3 larger."""
    x = (rng.standard_normal((4, 12)) * 2 + 1).astype(np.float32)
    bn = jgen.BatchNorm()
    v = _np(bn.init(jax.random.PRNGKey(0), jnp.asarray(x), True))
    y, upd = bn.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    port = tgen.BatchNorm(12)
    with torch.no_grad():
        port.weight.copy_(_t(v["params"]["BatchNorm_0"]["scale"]))
        out = port(_t(x), train=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(y), **TOL)
    ref = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.running_mean.numpy(), ref["mean"], **TOL)
    np.testing.assert_allclose(port.running_var.numpy(), ref["var"], **TOL)
    stock_var = torch.ones(12)
    F.batch_norm(_t(x), torch.zeros(12), stock_var, training=True,
                 momentum=0.1)
    assert not np.allclose(stock_var.numpy(), ref["var"], **TOL)


@functools.lru_cache(maxsize=None)
def _gen_pair():
    jg = jbuild_generator(CFG)
    b, l = 4, 16
    rng = np.random.default_rng(11)
    z = rng.standard_normal((b, 16)).astype(np.float32)
    sent = rng.standard_normal((b, 32)).astype(np.float32)
    words = rng.standard_normal((b, l, 32)).astype(np.float32)
    pad = np.arange(l)[None, :] >= rng.integers(4, l + 1, b)[:, None]
    eps = rng.standard_normal((b, 16)).astype(np.float32)
    v = _np(jax.jit(jg.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
        z, sent, words, pad, True, eps))
    return jg, v, (z, sent, words, pad, eps)


def test_generator_train_forward():
    """Images, mu/logvar and the updated batch_stats of one train-mode
    forward at B = 4, against the JAX generator (phased train tail on)."""
    jg, v, inputs = _gen_pair()
    (imgs, _, mu, logvar), upd = jax.jit(functools.partial(
        jg.apply, train=True, return_attn=False, mutable=["batch_stats"]))(
        v, *inputs[:4], ca_eps=inputs[4])
    port = load_jax_generator(build_generator(TCFG), v)
    out, atts, tmu, tlogvar = port(*[_t(a) for a in inputs],
                                   return_attn=False, train=True)
    assert atts == []
    for a, r in zip(out, imgs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(tlogvar.detach().numpy(), np.asarray(logvar),
                               **TOL)
    want = _stats(load_jax_generator(
        build_generator(TCFG), {"params": v["params"],
                                "batch_stats": _np(upd["batch_stats"])}))
    got = _stats(port)
    assert got.keys() == want.keys() and len(got) > 0
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_generator_train_detaches_the_pooled_state():
    """The memory write's pooled state h_avg passes no gradient, as the
    JAX package's stop_gradient: what reaches the B and M_r layers does
    not require grad, while the stage input still gets a gradient."""
    _, _, (_, _, words, pad, _) = _gen_pair()
    stage = tgen.NextStageG(8, 32, 1)
    seen = []
    for layer in (stage.B, stage.M_r):
        layer.register_forward_hook(
            lambda m, inp, out: seen.append(inp[0].requires_grad))
    torch.manual_seed(0)
    h = torch.randn(4, 8, 8, 8, requires_grad=True)
    out, _ = stage(h, _t(words), _t(pad), False, train=True)
    (g,) = torch.autograd.grad(out.square().sum(), h)
    assert seen == [False, False]
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_resize_nearest_matches_jax(rng):
    x = rng.standard_normal((2, 256, 256, 3)).astype(np.float32)
    ours = resize_nearest(_t(x), 224).numpy()
    np.testing.assert_allclose(ours, np.asarray(jresize(jnp.asarray(x), 224)),
                               **LOSS_TOL)
    # Torch's default "nearest" takes another source row for 128 of the
    # 224 rows (F2): resize an image whose pixels hold their row index.
    rows = torch.arange(256.0)[None, :, None, None].expand(1, 256, 256, 1)
    exact = resize_nearest(rows, 224)[0, :, 0, 0]
    default = F.interpolate(rows.permute(0, 3, 1, 2), size=(224, 224))
    assert int((default[0, 0, :, 0] != exact).sum()) == 128
