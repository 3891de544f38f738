"""``GAN.B_DCGAN`` in the port: ``GDCGan`` against the JAX package's on the
CPU, its weights in and out (``G_DCGAN`` ``.pth`` under the reference's
names, the ``.npz`` export), the entry points, and what neither package
can do with it.

Widths: the sampler tests' (``WIDTHS``: three branches, GF 8, R 1, a
2-layer CLIP text tower) with ``B_DCGAN`` set, so one refinement stage
runs the fused tail with ``want_h`` and the last folds the RGB head in;
the trainer tests use ``CFG`` (two branches).  Bounds in f32: images and
attention maps 1e-4 absolute and relative (the sampler's), 1e-3 with
``GAN.FUSED_TAIL`` (the JAX package's Pallas kernel in interpret mode
against the port's plain tail, the existing fused-tail tests' bound);
files read back into the port bitwise.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_checkpoint import _clip
from test_torch_port_sampler import CLIP_KW, WIDTHS, _captions
from test_torch_port_train_modules import port_clip_cfg
from test_train_steps import CFG, TINY_CLIP, _gan_batch
from t2igan.config import Config as JConfig
from t2igan.config import cfg_replace as j_cfg_replace
from t2igan.models import clip as jclip
from t2igan.models.factory import build_discriminators as jbuild_ds
from t2igan.models.factory import build_generator as jbuild_gen
from t2igan.models.generator import GDCGan as JGDCGan
from t2igan.train import checkpoint as jckpt
from t2igan.train import export as jexport
from t2igan.train import train_gan as jtrain_gan
from t2igan.train.state import init_gan_state as jinit_state
from t2igan.train.steps import make_gan_step as jmake_step
from t2igan.train.steps import make_sampler as jmake_sampler
from t2igan_torch import config as tconfig
from t2igan_torch import generate as tgenerate
from t2igan_torch.models import clip as tclip
from t2igan_torch.models.convert import (jax_generator_variables,
                                         load_generator_pth,
                                         load_jax_clip_text,
                                         load_jax_generator,
                                         save_generator_pth)
from t2igan_torch.models.factory import build_generator
from t2igan_torch.models.generator import (BatchNorm, GDCGan, GNet,
                                           init_generator_)
from t2igan_torch.train import train_gan as ttrain_gan
from t2igan_torch.train.export import (load_generator_weights,
                                       save_generator_npz)
from t2igan_torch.train.steps import make_gan_step, make_sampler

TOL = dict(rtol=1e-4, atol=1e-4)
FUSED_TOL = dict(rtol=1e-3, atol=1e-3)
B = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _widths(fused=False):
    return dict(WIDTHS, GAN=dict(WIDTHS["GAN"], B_DCGAN=True,
                                 FUSED_TAIL=fused))


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX CLIP model, its params, JAX GDCGan variables with batch
    statistics moved off 0 and 1, the port's CLIP text side, inputs)."""
    jcfg = j_cfg_replace(JConfig(), **_widths())
    clip_model = jclip.ClipWithRegionHead(jclip.ClipConfig(
        **CLIP_KW, text=jclip.ClipTowerConfig(32, 2, 2, 64),
        vision=jclip.ClipTowerConfig(48, 2, 2, 96)))
    gen = jbuild_gen(jcfg)
    assert isinstance(gen, JGDCGan)
    rng = np.random.default_rng(3)
    ids, mask = _captions(rng, B)
    z = rng.standard_normal((B, 16)).astype(np.float32)
    eps = rng.standard_normal((B, 16)).astype(np.float32)
    clip_vars = jax.jit(clip_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), ids[:1], mask[:1])
    g_vars = _np(jax.jit(gen.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(1), "gaussian": jax.random.PRNGKey(2)},
        z, np.zeros((B, 32), np.float32), np.zeros((B, 16, 32), np.float32),
        mask == 0, False, eps))
    g_vars["batch_stats"] = jax.tree.map(
        lambda x: (x + rng.uniform(0.0, 0.3, x.shape)).astype(np.float32),
        g_vars["batch_stats"])
    port_clip = load_jax_clip_text(
        tclip.ClipWithRegionHead(tclip.ClipConfig(
            **CLIP_KW, text=tclip.ClipTowerConfig(32, 2, 2, 64))),
        _np(clip_vars["params"])).eval()
    return clip_model, clip_vars["params"], g_vars, port_clip, \
        (ids, mask, z, eps)


def _jax_sample(variables, fused=False, return_attn=False):
    clip_model, clip_params, _, _, inputs = _setup()
    jcfg = j_cfg_replace(JConfig(), **_widths(fused))
    fakes, atts = jmake_sampler(jcfg, clip_model, jbuild_gen(jcfg),
                                return_attn=return_attn)(
        clip_params, variables["params"], variables["batch_stats"], *inputs)
    return [np.asarray(f) for f in fakes], [np.asarray(a) for a in atts]


def _port_gen(fused=False, seed=None):
    """The port's GDCGan, with random weights from ``seed`` (and batch
    statistics off 0 and 1) when one is given."""
    cfg = tconfig.cfg_replace(tconfig.Config(), **_widths(fused))
    gen = build_generator(cfg)
    assert isinstance(gen, GDCGan)
    if seed is not None:
        g = torch.Generator().manual_seed(seed)
        init_generator_(gen, g)
        for m in gen.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return cfg, gen.to(memory_format=torch.channels_last)


def _port_sample(cfg, gen, return_attn=False):
    out = make_sampler(cfg, _setup()[3], gen, return_attn)(*_setup()[4])
    fakes, atts = out if return_attn else (out, [])
    return [f.numpy() for f in fakes], [a.numpy() for a in atts]


def _assert_close(port, ref, tol=TOL):
    assert len(port) == len(ref)
    for a, r in zip(port, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a, r, **tol)


@pytest.mark.parametrize("fused", [False, True])
def test_gdcgan_sampler_matches_jax(fused):
    """One 256 px image and two attention maps (64 and 128 px stages);
    the images without maps (K1's path on a card), then with them."""
    g_vars = _setup()[2]
    cfg, gen = _port_gen(fused)
    load_jax_generator(gen, g_vars)
    tol = FUSED_TOL if fused else TOL
    port, _ = _port_sample(cfg, gen)
    ref, _ = _jax_sample(g_vars, fused)
    assert [p.shape for p in port] == [(B, 256, 256, 3)]
    _assert_close(port, ref, tol)
    port, patts = _port_sample(cfg, gen, return_attn=True)
    ref, jatts = _jax_sample(g_vars, fused, return_attn=True)
    assert [a.shape for a in patts] == [(B, 64, 64, 16), (B, 128, 128, 16)]
    _assert_close(port, ref, tol)
    _assert_close(patts, jatts, tol)


def test_gdcgan_has_the_jax_names_with_one_head():
    g_vars = _setup()[2]
    assert sorted(k for k in g_vars["params"] if k.startswith("GetImage")) \
        == ["GetImageG_0"]
    _, gen = _port_gen()
    load_jax_generator(gen, g_vars)
    back = jax_generator_variables(gen)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(g_vars)]
    for (_, a), (_, b) in zip(flat(back), flat(g_vars)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_g_dcgan_pth_both_ways(tmp_path, direction):
    """A ``G_DCGAN`` ``.pth`` written by the port, read by the JAX
    package's ``load_torch_generator(dcgan=True)``, samples as the port
    does; read back by the port, it is bitwise the same generator.  The
    reverse: the JAX package's variables written under the reference's
    names (a reference ``G_DCGAN`` file) sample alike in both packages."""
    path = str(tmp_path / "netG_epoch_4.pth")
    if direction == "port_to_jax":
        cfg, gen = _port_gen(seed=5)
    else:
        cfg, gen = _port_gen()
        load_jax_generator(gen, _setup()[2])
    save_generator_pth(gen, path)
    sd = torch.load(path, weights_only=True)
    assert "img_net.img.0.weight" in sd and \
        not any(k.startswith("img_net1") for k in sd)
    jv = _np(jckpt.load_torch_generator(path, branch_num=3, num_residual=1,
                                        dcgan=True))
    _assert_close(_port_sample(cfg, gen)[0], _jax_sample(jv)[0])
    back = load_generator_pth(_port_gen()[1], path)
    for a, b in zip(back.state_dict().values(), gen.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_gdcgan_npz_both_ways(tmp_path, direction):
    if direction == "port_to_jax":
        cfg, gen = _port_gen(seed=6)
        path = save_generator_npz(str(tmp_path / "G"), gen)
        params, stats = jexport.load_generator(path)
        _assert_close(_port_sample(cfg, gen)[0],
                      _jax_sample({"params": params,
                                   "batch_stats": stats})[0])
    else:
        g_vars = _setup()[2]
        path = jexport.save_generator(str(tmp_path / "G"),
                                      g_vars["params"],
                                      g_vars["batch_stats"])
        cfg, gen = _port_gen()
        load_generator_weights(gen, path)
        _assert_close(_port_sample(cfg, gen)[0], _jax_sample(g_vars)[0])


@pytest.mark.parametrize("kind", ["pth", "npz"])
def test_generator_class_mismatch_raises(tmp_path, kind):
    """A ``G_NET`` file into a ``GDCGan`` and a ``G_DCGAN`` file into a
    ``GNet`` raise, naming ``GAN.B_DCGAN``."""
    cfg_net = tconfig.cfg_replace(tconfig.Config(), **WIDTHS)
    gnet = init_generator_(build_generator(cfg_net),
                           torch.Generator().manual_seed(0))
    _, gdc = _port_gen(seed=1)
    assert isinstance(gnet, GNet)
    for src, dst, what in ((gnet, _port_gen()[1], "G_NET"),
                           (gdc, build_generator(cfg_net), "G_DCGAN")):
        path = str(tmp_path / f"{what}.{kind}")
        if kind == "pth":
            save_generator_pth(src, path)
        else:
            save_generator_npz(path, src)
        with pytest.raises(ValueError, match=f"holds a {what}.*B_DCGAN"):
            load_generator_weights(dst, path)


DCFG = j_cfg_replace(CFG, GAN={"B_DCGAN": True})
TDCFG = tconfig.cfg_from_dict(dataclasses.asdict(DCFG))


def test_b_dcgan_training_raises_in_both_packages(tmp_path):
    """The JAX step feeds the 64 px real images beside the single
    discriminator's 128 px fakes and fails; the port's step and trainer
    refuse before any step."""
    model, clip_params, clip = _clip()
    gen, ds = jbuild_gen(DCFG), jbuild_ds(DCFG)
    assert len(ds) == 1 and isinstance(gen, JGDCGan)
    # Shapes only: the step fails while it is traced.
    state = jax.eval_shape(lambda r: jinit_state(DCFG, gen, ds, r),
                           jax.random.PRNGKey(1))
    tx = optax.sgd(0.1)
    with pytest.raises(TypeError, match="Cannot concatenate"):
        jax.eval_shape(jmake_step(DCFG, model, gen, ds, tx, tx), state,
                       clip_params, _gan_batch(np.random.default_rng(0)),
                       jax.random.PRNGKey(2))
    with pytest.raises(NotImplementedError, match="B_DCGAN"):
        make_gan_step(TDCFG, clip)
    cfg = tconfig.cfg_replace(TDCFG, DATA_DIR="", TRAIN={
        "FLAG": True, "CLIP_MODEL_CHECKPOINT": ""})
    with pytest.raises(NotImplementedError, match="B_DCGAN"):
        ttrain_gan.CondGanTrainer(cfg, "cpu",
                                  clip_cfg=port_clip_cfg(TINY_CLIP),
                                  output_dir=str(tmp_path / "t"))
    evaluator = ttrain_gan.CondGanTrainer(
        tconfig.cfg_replace(cfg, TRAIN={"FLAG": False}), "cpu",
        clip_cfg=port_clip_cfg(TINY_CLIP), output_dir=str(tmp_path / "e"))
    with pytest.raises(NotImplementedError, match="B_DCGAN"):
        evaluator.train_steps(1)


class _Tokens:
    """A tokenizer of the tiny CLIP's 512 ids for the JAX trainer."""

    def __call__(self, captions, max_length):
        ids, mask = _captions(np.random.default_rng(len(captions)),
                              len(captions), max_length)
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids):
        return f"w{ids[0]}"


def test_b_dcgan_gen_example_raises_in_both_packages(tmp_path):
    """The JAX gen_example pairs attention map k with image k + 1 and
    fails on GDCGan's one image after writing its stage images (its loop
    driven by the JAX sampler of the GDCGan above); the port raises before
    writing anything."""
    clip_model, clip_params, g_vars, _, _ = _setup()
    jt = object.__new__(jtrain_gan.CondGanTrainer)
    jt.cfg = j_cfg_replace(JConfig(), **_widths())
    jt.clip_model, jt.clip_params = clip_model, clip_params
    jt.gen_model, jt._sampler_attn = jbuild_gen(jt.cfg), None
    jt.state = types.SimpleNamespace(g_ema_params=g_vars["params"],
                                     g_batch_stats=g_vars["batch_stats"])
    jt.tokenizer, jt.output_dir = _Tokens(), str(tmp_path / "jax")
    captions = {"demo": ["a bird with red wings", "a small blue bird"]}
    with pytest.raises(IndexError):
        jt.gen_example(captions)
    assert sorted(os.listdir(tmp_path / "jax" / "demo")) == [
        "0_s_0_g0.png", "0_s_1_g0.png"]
    cfg = tconfig.cfg_replace(TDCFG, DATA_DIR="", WORKERS=1, TRAIN={
        "FLAG": False, "CLIP_MODEL_CHECKPOINT": ""})
    pt = ttrain_gan.CondGanTrainer(cfg, "cpu",
                                   clip_cfg=port_clip_cfg(TINY_CLIP),
                                   output_dir=str(tmp_path / "port"),
                                   split="test")
    with pytest.raises(NotImplementedError, match="B_DCGAN"):
        pt.gen_example(captions)
    assert not os.path.exists(tmp_path / "port" / "demo")


def test_b_dcgan_entry_points(tmp_path, capsys):
    """``generate --weights`` with a ``G_DCGAN`` ``.pth`` writes one 128 px
    image per caption, the file's generator's; ``TRAIN.NET_G`` puts it
    behind ``sampling()``, which writes one PNG a record and an R in
    [0, 1]."""
    from PIL import Image

    cfg = tconfig.cfg_replace(TDCFG, DATA_DIR="", WORKERS=1, TRAIN={
        "FLAG": False, "CLIP_MODEL_CHECKPOINT": ""})
    src = init_generator_(build_generator(cfg),
                          torch.Generator().manual_seed(8))
    path = str(tmp_path / "netG_epoch_2.pth")
    save_generator_pth(src, path)
    clip_cfg = tclip.ClipConfig(max_positions=16, projection_dim=32,
                                text=tclip.ClipTowerConfig(32, 2, 2, 64))
    out = tgenerate.generate(cfg, ["a red bird", "a blue bird"],
                             str(tmp_path / "gen"), batch=2, device="cpu",
                             clip_cfg=clip_cfg, weights=path)
    assert [f.shape for f in out[0]] == [(2, 128, 128, 3)]
    assert sorted(os.listdir(tmp_path / "gen")) == ["0_g0.png", "1_g0.png"]
    png = np.asarray(Image.open(tmp_path / "gen" / "1_g0.png"))
    assert png.shape == (128, 128, 3)

    trainer = ttrain_gan.CondGanTrainer(
        tconfig.cfg_replace(cfg, TRAIN={"NET_G": path}), "cpu",
        clip_cfg=port_clip_cfg(TINY_CLIP), output_dir=str(tmp_path / "ev"),
        split="test")
    assert f"Loaded generator weights: {path}" in capsys.readouterr().out
    for a, b in zip(trainer.state.gen_ema.state_dict().values(),
                    src.state_dict().values()):
        assert torch.equal(a, b)
    trainer.dataset.n = 8
    trainer.dataset.class_id = trainer.dataset.class_id[:8]
    mean, _ = trainer.sampling("valid", num_rounds=1, n_mis=3)
    assert 0.0 <= mean <= 1.0
    single = tmp_path / "ev" / "valid" / "single" / "synthetic"
    assert len(os.listdir(single)) == 8
