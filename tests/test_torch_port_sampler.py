"""The port's sampler and generate flow against the JAX package's, on the
CPU.

The JAX ``make_sampler`` and the port's run on the same ids, masks, ``z``
and ``eps`` with the JAX weights bridged into the port.  Tolerance 1e-4
absolute and relative in f32 on all three images, the generator's bound
(``tests/test_torch_port_generator.py``); the CLIP tower in front of it is
held to the same bound in ``tests/test_torch_port_clip.py``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2igan.config import Config as JConfig
from t2igan.config import cfg_replace as j_cfg_replace
from t2igan.models import clip as jclip
from t2igan.models.factory import build_generator as j_build_generator
from t2igan.train.steps import make_sampler as j_make_sampler
from t2igan_torch import generate as tgenerate
from t2igan_torch.config import Config, cfg_replace
from t2igan_torch.models import clip as tclip
from t2igan_torch.models.convert import load_jax_clip_text, load_jax_generator
from t2igan_torch.models.factory import build_generator
from t2igan_torch.ops.image import uint8_from_tanh
from t2igan_torch.train.steps import make_sampler


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
CONFIGS = Path(tgenerate.__file__).parent / "configs"
WIDTHS = dict(TREE={"BRANCH_NUM": 3},
              GAN={"GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16,
                   "R_NUM": 1},
              TEXT={"EMBEDDING_DIM": 32, "WORDS_NUM": 16})
CLIP_KW = dict(vocab_size=512, max_positions=16, eos_token_id=511,
               projection_dim=32, image_size=32, patch_size=16, region_dim=32)


def _captions(rng, b, l=16, vocab=512, eos=511):
    ids = np.full((b, l), eos, dtype=np.int32)
    mask = np.zeros((b, l), dtype=np.int32)
    for i, n in enumerate(rng.integers(4, l + 1, size=b)):
        ids[i, 0] = vocab - 2
        ids[i, 1:n - 1] = rng.integers(1, 400, n - 2)
        mask[i, :n] = 1
    return ids, mask


def test_sampler_matches_jax(rng):
    jcfg = j_cfg_replace(JConfig(), **WIDTHS)
    jclip_model = jclip.ClipWithRegionHead(jclip.ClipConfig(
        **CLIP_KW, text=jclip.ClipTowerConfig(32, 2, 2, 64),
        vision=jclip.ClipTowerConfig(48, 2, 2, 96)))
    jgen_model = j_build_generator(jcfg)
    b = 2
    ids, mask = _captions(rng, b)
    z = rng.standard_normal((b, 16)).astype(np.float32)
    eps = rng.standard_normal((b, 16)).astype(np.float32)
    clip_vars = jax.jit(jclip_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), ids[:1], mask[:1])
    g_vars = jax.jit(jgen_model.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(1), "gaussian": jax.random.PRNGKey(2)},
        z, np.zeros((b, 32), np.float32), np.zeros((b, 16, 32), np.float32),
        mask == 0, False, eps)
    ref = j_make_sampler(jcfg, jclip_model, jgen_model)(
        clip_vars["params"], g_vars["params"], g_vars["batch_stats"],
        ids, mask, z, eps)[0]

    cfg = cfg_replace(Config(), **WIDTHS)
    clip = load_jax_clip_text(
        tclip.ClipWithRegionHead(tclip.ClipConfig(
            **CLIP_KW, text=tclip.ClipTowerConfig(32, 2, 2, 64))),
        jax.tree.map(np.asarray, clip_vars["params"])).eval()
    gen = load_jax_generator(build_generator(cfg),
                             jax.tree.map(np.asarray, g_vars))
    gen = gen.to(memory_format=torch.channels_last)
    out = make_sampler(cfg, clip, gen)(ids, mask, z, eps)
    assert [tuple(o.shape) for o in out] == [(b, s, s, 3)
                                             for s in (64, 128, 256)]
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def _tiny_generate_setup():
    cfg = cfg_replace(Config(), **WIDTHS)
    clip_cfg = tclip.ClipConfig(
        max_positions=16, projection_dim=32,
        text=tclip.ClipTowerConfig(32, 2, 2, 64))  # full 49408-id vocabulary
    return cfg, clip_cfg


def test_generate_writes_each_stage_as_png(tmp_path):
    from PIL import Image

    cfg, clip_cfg = _tiny_generate_setup()
    captions = ["a small bird with a red head", "this bird is yellow",
                "a bird"]
    out = tgenerate.generate(cfg, captions, str(tmp_path), batch=2,
                             device="cpu", clip_cfg=clip_cfg)
    assert [len(batch) for batch in out] == [3, 3]
    assert out[1][2].shape == (1, 256, 256, 3)
    for i in range(3):
        for k, size in enumerate((64, 128, 256)):
            png = np.asarray(Image.open(tmp_path / f"{i}_g{k}.png"))
            want = uint8_from_tanh(out[i // 2][k][i % 2]).numpy()
            assert png.shape == (size, size, 3)
            np.testing.assert_array_equal(png, want)


def test_generate_is_deterministic_in_seed(tmp_path):
    cfg, clip_cfg = _tiny_generate_setup()
    run = [tgenerate.generate(cfg, ["a red bird"], None, 1, seed=s,
                              device="cpu", clip_cfg=clip_cfg)[0][2]
           for s in (3, 3, 4)]
    torch.testing.assert_close(run[0], run[1], rtol=0, atol=0)
    assert not torch.equal(run[0], run[2])


def test_generate_defaults_to_the_card(tmp_path, monkeypatch):
    """Without a card the entry point raises; it never falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    captions = tmp_path / "captions.txt"
    captions.write_text("a red bird\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgenerate.main(["--cfg", str(CONFIGS / "eval_clip_bird.yml"),
                        "--captions", str(captions)])
