"""The gen+eval path of the port (the JAX bench's ``--mode geneval``):
captions through the sampler, the finest image rescaled to [0, 1],
bilinear-resized to 299 and through the FID Inception-v3 to ``pool3``,
against the same composition in the JAX package, with the plain and the
fused eval tail, on the CPU at small widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.models import inception as jinc
from t2igan_torch.evaluation import fid as tfid
from test_torch_port_inception import _pair


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fused_tail", [False, True])
def test_gen_eval_matches_jax(fused_tail):
    """The gen+eval path (sampler, rescale to [0, 1], bilinear 299, FID
    Inception pool3) at small widths, batch 1, against the same
    composition in the JAX package (bench.py's ``--mode geneval``), with
    the plain and the fused tail.  Tolerance 1e-4 of pool3's largest
    magnitude: the sampler's 1e-4 carried through the Inception trunk."""
    from t2igan.config import Config as JConfig
    from t2igan.config import cfg_replace as j_cfg_replace
    from t2igan.models import clip as jclip
    from t2igan.models.factory import build_generator as j_build_generator
    from t2igan.train.steps import make_sampler as j_make_sampler
    from t2igan_torch.config import Config, cfg_replace
    from t2igan_torch.models import clip as tclip
    from t2igan_torch.models.convert import (load_jax_clip_text,
                                             load_jax_generator)
    from t2igan_torch.models.factory import build_generator
    from test_torch_port_sampler import CLIP_KW, WIDTHS, _captions

    widths = dict(WIDTHS, GAN=dict(WIDTHS["GAN"], FUSED_TAIL=fused_tail,
                                   GF_DIM=8))
    rng = np.random.default_rng(5)
    jcfg = j_cfg_replace(JConfig(), **widths)
    jclip_model = jclip.ClipWithRegionHead(jclip.ClipConfig(
        **CLIP_KW, text=jclip.ClipTowerConfig(32, 2, 2, 64),
        vision=jclip.ClipTowerConfig(48, 2, 2, 96)))
    jgen_model = j_build_generator(jcfg)
    ids, mask = _captions(rng, 1)
    z = rng.standard_normal((1, 16)).astype(np.float32)
    eps = rng.standard_normal((1, 16)).astype(np.float32)
    clip_vars = jax.jit(jclip_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), ids, mask)
    g_vars = jax.jit(jgen_model.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(1), "gaussian": jax.random.PRNGKey(2)},
        z, np.zeros((1, 32), np.float32), np.zeros((1, 16, 32), np.float32),
        mask == 0, False, eps)
    inc_model, inc_vars, inception = _pair("fid")
    fakes = j_make_sampler(jcfg, jclip_model, jgen_model)(
        clip_vars["params"], g_vars["params"], g_vars["batch_stats"],
        ids, mask, z, eps)[0]
    ref = np.asarray(inc_model.apply(
        inc_vars, jinc.preprocess((fakes[-1] + 1.0) * 0.5))["pool3"])

    cfg = cfg_replace(Config(), **widths)
    clip = load_jax_clip_text(
        tclip.ClipWithRegionHead(tclip.ClipConfig(
            **CLIP_KW, text=tclip.ClipTowerConfig(32, 2, 2, 64))),
        jax.tree.map(np.asarray, clip_vars["params"])).eval()
    gen = load_jax_generator(build_generator(cfg),
                             jax.tree.map(np.asarray, g_vars))
    gen = gen.to(memory_format=torch.channels_last)
    assert gen.fused_tail == fused_tail
    out = tfid.make_gen_activation_fn(cfg, clip, gen, inception)(
        ids, mask, z, eps)
    assert tuple(out.shape) == (1, 2048)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
