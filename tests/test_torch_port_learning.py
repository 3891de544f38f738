"""The learning proof of ``tests/test_learning_proof.py`` on the port, on
the CPU: the adversarial loop learns, not just survives.

The same fixture as the JAX proof: ``CFG`` (``BRANCH_NUM 1``, GF 8, DF 4,
batch 8, ``LAMBDA 1``), 8 flat-colour targets, one caption batch, the
CLIP of ``PRNGKey(2)`` and the G/D state of ``PRNGKey(1)``, built by the
JAX package's ``.init`` and carried across by
``t2igan_torch.models.convert``.  The port trains with its own Adam
(``gan_optimizers``) and ``ema_decay=0.98``; every step takes its noise
from the JAX proof's key chain (``key, sub = split(key)``, then ``rz, r1,
r2 = split(sub, 3)``), so its first steps are the JAX steps:

* the first 10 steps' metrics against the JAX step on the same noise,
  1e-3 relative (Adam's first steps act like a sign, ROADMAP F14);
* then the proof's five assertions with its thresholds unchanged: G's
  and the EMA G's distance to the targets below 0.65x their start, the
  last 50 steps' w + s loss below 0.7x the first 50's, D's loss falling,
  G's loss falling from steps 100-200 to the last 100, every value finite.

At ``BRANCH_NUM 1`` the generator has no refinement stage, so the proof
launches no memory read (K1, K2) on a card either.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_learning_proof import B, CFG, STEPS
from test_torch_port_train_modules import port_clip_cfg
from test_train_steps import TINY_CLIP, _caption_batch
from t2igan.models.clip import ClipWithRegionHead
from t2igan.models.factory import build_discriminators, build_generator
from t2igan.train.state import gan_optimizers, init_gan_state
from t2igan.train.steps import make_gan_step
from t2igan_torch import config as tconfig
from t2igan_torch.models.convert import (load_jax_clip, load_jax_discriminator,
                                         load_jax_generator)
from t2igan_torch.models import factory
from t2igan_torch.train import state as tstate
from t2igan_torch.train import steps as tsteps

TCFG = tconfig.cfg_from_dict(dataclasses.asdict(CFG))
CHECKED = 10  # steps held to the JAX step
# JAX's own trajectory, recorded in tests/test_learning_proof.py:96-101.
JAX_RECORDED = "distance 0.232 -> ~0.05, w + s ~15 -> ~6"


@jax.jit
def _draw(key):
    """The JAX proof's noise for one step: (next key, z, eps1, eps2) and
    the step's key."""
    key, sub = jax.random.split(key)
    rz, r1, r2 = jax.random.split(sub, 3)
    return (key, sub, jax.random.normal(rz, (B, CFG.GAN.Z_DIM)),
            jax.random.normal(r1, (B, CFG.GAN.CONDITION_DIM)),
            jax.random.normal(r2, (B, CFG.GAN.CONDITION_DIM)))


def _fixture():
    """The JAX proof's batch, CLIP, models and state."""
    rng = np.random.default_rng(0)
    colors = np.linspace(-0.8, 0.8, B * 3).reshape(B, 3).astype(np.float32)
    targets = np.broadcast_to(colors[:, None, None, :],
                              (B, 64, 64, 3)).copy()
    ids, mask = _caption_batch(rng, B, 16)
    batch = {"images": [targets], "ids": ids, "mask": mask,
             "ids_2": ids.copy(), "mask_2": mask.copy(),
             "class_ids": np.arange(B, dtype=np.int32)}
    clip_model = ClipWithRegionHead(TINY_CLIP)
    clip_vars = jax.jit(clip_model.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    gen, ds = build_generator(CFG), build_discriminators(CFG)
    state = jax.jit(lambda r: init_gan_state(CFG, gen, ds, r))(
        jax.random.PRNGKey(1))
    return batch, targets, clip_model, clip_vars, gen, ds, state


def _port(clip_vars, state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    clip = load_jax_clip(factory.build_clip(port_clip_cfg(TINY_CLIP)),
                         np_tree(clip_vars["params"])).requires_grad_(False)
    gen = load_jax_generator(factory.build_generator(TCFG), {
        "params": np_tree(state.g_params),
        "batch_stats": np_tree(state.g_batch_stats)})
    ds = [load_jax_discriminator(d, {"params": p, "spectral": s})
          for d, p, s in zip(factory.build_discriminators(TCFG),
                             np_tree(state.d_params),
                             np_tree(state.d_spectral))]
    return clip, tstate.init_gan_state(TCFG, gen.train(), ds)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def proof():
    batch, targets, clip_model, clip_vars, gen, ds, state = _fixture()
    g_tx, d_tx = gan_optimizers(CFG)
    jstep = jax.jit(make_gan_step(CFG, clip_model, gen, ds, g_tx, d_tx,
                                  ema_decay=0.98))
    clip, pstate = _port(clip_vars, state)
    step = tsteps.make_gan_step(TCFG, clip, ema_decay=0.98)
    z = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(7), (B, CFG.GAN.Z_DIM))))
    eps = torch.zeros((B, CFG.GAN.CONDITION_DIM))
    want = torch.from_numpy(targets)

    def dist(gen):
        fakes = tsteps.make_sampler(TCFG, clip, gen)(batch["ids"],
                                                     batch["mask"], z, eps)
        return float(torch.mean((fakes[-1] - want) ** 2))

    start = dist(pstate.gen), dist(pstate.gen_ema)
    key = jax.random.PRNGKey(3)
    jax_metrics, port_metrics = [], []
    d_losses, g_losses, ws_losses = [], [], []
    for i in range(STEPS):
        key, sub, *noise = _draw(key)
        if i < CHECKED:
            state, m = jstep(state, clip_vars["params"], batch, sub)
            jax_metrics.append({k: float(v) for k, v in m.items()})
        m = step(pstate, batch, *(torch.from_numpy(np.array(n))
                                  for n in noise))
        m = {k: float(v) for k, v in m.items()}
        if i < CHECKED:
            port_metrics.append(m)
        d_losses.append(m["d_loss0"])
        g_losses.append(m["g_loss"])
        ws_losses.append(m["w_loss"] + m["s_loss"])
    end = dist(pstate.gen), dist(pstate.gen_ema)
    print(f"port learning proof, {STEPS} steps: distance G {start[0]:.4f} "
          f"-> {end[0]:.4f}, EMA G {start[1]:.4f} -> {end[1]:.4f}; w + s "
          f"{np.mean(ws_losses[:50]):.3f} -> {np.mean(ws_losses[-50:]):.3f}"
          f" (JAX, recorded: {JAX_RECORDED})")
    return dict(start=start, end=end, d=d_losses, g=g_losses, ws=ws_losses,
                jax=jax_metrics, port=port_metrics, state=pstate)


def test_first_steps_are_the_jax_steps(proof):
    assert len(proof["jax"]) == len(proof["port"]) == CHECKED
    for i, (want, got) in enumerate(zip(proof["jax"], proof["port"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       err_msg=f"step {i} {k}")


def test_every_value_stays_finite(proof):
    assert np.isfinite(proof["d"]).all() and np.isfinite(proof["g"]).all()
    assert np.isfinite(proof["ws"]).all()
    for p in proof["state"].gen.parameters():
        assert torch.isfinite(p).all()


def test_generator_and_ema_approach_the_targets(proof):
    (g0, e0), (g1, e1) = proof["start"], proof["end"]
    assert g1 < 0.65 * g0, (g0, g1)
    assert e1 < 0.65 * e0, (e0, e1)


def test_damsm_alignment_improves(proof):
    ws = proof["ws"]
    assert np.mean(ws[-50:]) < 0.7 * np.mean(ws[:50]), (
        np.mean(ws[:50]), np.mean(ws[-50:]))


def test_adversarial_game_moves_toward_equilibrium(proof):
    d, g = proof["d"], proof["g"]
    assert np.mean(d[-50:]) < np.mean(d[:50])
    assert np.mean(g[-100:]) < np.mean(g[100:200])
