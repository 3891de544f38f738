"""The long-horizon stability check of ``tests/test_training_stability.py``
on the port, on the CPU: 60 adversarial steps on tiny models stay finite,
with bounded losses and a healthy spectral norm.

The JAX check's fixture: ``tests/test_train_steps.py``'s ``CFG`` (two
scales, GF 8, DF 4, batch 4), the CLIP of ``PRNGKey(0)`` and the G/D state
of ``PRNGKey(1)`` built by the JAX package's ``.init`` and carried across
by ``t2igan_torch.models.convert``, a fresh ``_gan_batch`` a step from
``default_rng(0)``, and each step's noise from the JAX check's key chain
(``PRNGKey(7)``; ``key, sub = split(key)``, then ``rz, r1, r2 = split(sub,
3)``).  The port's own Adam (``gan_optimizers``) and EMA.  Its
thresholds, unchanged: every loss finite, ``min(D loss)`` over the last 10
steps above 1e-3, every G parameter finite, and every spectral-norm
vector (``u`` and ``v`` of each SN conv) of unit norm within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_train_steps import CFG, TINY_CLIP, _gan_batch
from test_torch_port_train_modules import port_clip_cfg
from t2igan.models.clip import ClipWithRegionHead
from t2igan.models.factory import build_discriminators, build_generator
from t2igan.train.state import init_gan_state
from t2igan_torch import config as tconfig
from t2igan_torch.models import factory
from t2igan_torch.models.convert import (load_jax_clip, load_jax_discriminator,
                                         load_jax_generator)
from t2igan_torch.ops.spectral import SNConv
from t2igan_torch.train import state as tstate
from t2igan_torch.train import steps as tsteps

TCFG = tconfig.cfg_from_dict(dataclasses.asdict(CFG))
STEPS, B = 60, 4


@jax.jit
def _draw(key):
    """The JAX check's noise for one step: (next key, z, eps1, eps2)."""
    key, sub = jax.random.split(key)
    rz, r1, r2 = jax.random.split(sub, 3)
    return (key, jax.random.normal(rz, (B, CFG.GAN.Z_DIM)),
            jax.random.normal(r1, (B, CFG.GAN.CONDITION_DIM)),
            jax.random.normal(r2, (B, CFG.GAN.CONDITION_DIM)))


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
def run():
    clip_vars = jax.jit(ClipWithRegionHead(TINY_CLIP).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    gen, ds = build_generator(CFG), build_discriminators(CFG)
    state = jax.tree.map(np.asarray, jax.jit(
        lambda r: init_gan_state(CFG, gen, ds, r))(
            jax.random.PRNGKey(1)))
    clip = load_jax_clip(factory.build_clip(port_clip_cfg(TINY_CLIP)),
                         jax.tree.map(np.asarray, clip_vars["params"]))
    gen = load_jax_generator(factory.build_generator(TCFG), {
        "params": state.g_params, "batch_stats": state.g_batch_stats})
    ds = [load_jax_discriminator(d, {"params": p, "spectral": s})
          for d, p, s in zip(factory.build_discriminators(TCFG),
                             state.d_params, state.d_spectral)]
    pstate = tstate.init_gan_state(TCFG, gen.train(), ds)
    step = tsteps.make_gan_step(TCFG, clip.requires_grad_(False))
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(7)
    g_losses, d_losses = [], []
    for _ in range(STEPS):
        batch = _gan_batch(rng)
        key, *noise = _draw(key)
        m = step(pstate, batch, *(torch.from_numpy(np.array(n))
                                  for n in noise))
        g_losses.append(float(m["g_loss"]))
        d_losses.append(float(m["d_loss0"]) + float(m["d_loss1"]))
    print(f"port stability, {STEPS} steps: G loss {g_losses[0]:.3f} -> "
          f"{g_losses[-1]:.3f}, D loss {d_losses[0]:.3f} -> "
          f"{d_losses[-1]:.3f}, min D over the last 10 "
          f"{min(d_losses[-10:]):.4f}")
    return dict(g=g_losses, d=d_losses, state=pstate)


def test_losses_stay_finite(run):
    assert np.isfinite(run["g"]).all(), run["g"][-5:]
    assert np.isfinite(run["d"]).all(), run["d"][-5:]


def test_discriminator_does_not_collapse(run):
    assert min(run["d"][-10:]) > 1e-3


def test_generator_parameters_stay_finite(run):
    for name, p in run["state"].gen.named_parameters():
        assert torch.isfinite(p).all(), name


def test_spectral_vectors_stay_unit_norm(run):
    convs = [m for d in run["state"].ds for m in d.modules()
             if isinstance(m, SNConv)]
    assert convs
    for conv in convs:
        for vec in (conv.u, conv.v):
            np.testing.assert_allclose(float(vec.norm()), 1.0, rtol=1e-3)
