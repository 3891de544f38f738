"""The port's adversarial step against the JAX package's, on the CPU.

At the widths of ``tests/test_train_steps.py`` (``TINY_CLIP``, ``CFG``:
two 2-layer towers, GF 8, DF 4, two scales, batch 4) the JAX step is
initialised and its variables cross to the port through the loaders.  Both
sides get the same batch and the same z / eps (the values
``jax.random.split(rng, 3)`` gives), and SGD as the optimizer, so that the
updated parameters compare the gradients.  The JAX result is loaded into
second port modules and compared ``state_dict`` against ``state_dict``.

Tolerances in f32: metrics 1e-4 relative (the JAX package's own bound
for its step); parameters and spectral vectors after one step 1e-4
absolute plus 1e-4 relative; the running statistics 1e-4.  The JAX step
runs the phased train tail (its default), a reassociation of the port's
plain tail.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_train_steps import CFG, TINY_CLIP, _gan_batch
from test_torch_port_train_modules import TCFG, port_clip_cfg
from t2igan.models import clip as jclip
from t2igan.models.factory import (build_discriminators as jbuild_ds,
                                   build_generator as jbuild_gen)
from t2igan.train.state import gan_optimizers as jgan_optimizers
from t2igan.train.state import init_gan_state as jinit_state
from t2igan.train.steps import make_gan_step as jmake_step
from t2igan_torch.models.convert import (load_jax_clip, load_jax_discriminator,
                                         load_jax_generator)
from t2igan_torch.models.factory import (build_clip, build_discriminators,
                                         build_generator)
from t2igan_torch.train import train_gan
from t2igan_torch.train.state import gan_optimizers, init_gan_state
from t2igan_torch.train.steps import make_gan_step

LR = 1.0
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step with SGD, from fixed variables: (before, after,
    metrics, batch, noise)."""
    clip_model = jclip.ClipWithRegionHead(TINY_CLIP)
    clip_vars = jax.jit(clip_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    gen, ds = jbuild_gen(CFG), jbuild_ds(CFG)
    state = jax.jit(lambda r: jinit_state(CFG, gen, ds, r))(
        jax.random.PRNGKey(1))
    tx = optax.sgd(LR)
    state = state.replace(g_opt_state=tx.init(state.g_params),
                          d_opt_states=[tx.init(p) for p in state.d_params])
    step = jax.jit(jmake_step(CFG, clip_model, gen, ds, tx, tx))
    batch = _gan_batch(np.random.default_rng(1))
    rng = jax.random.PRNGKey(2)
    new, metrics = step(state, clip_vars["params"], batch, rng)
    rz, r1, r2 = jax.random.split(rng, 3)
    noise = (jax.random.normal(rz, (4, CFG.GAN.Z_DIM)),
             jax.random.normal(r1, (4, CFG.GAN.CONDITION_DIM)),
             jax.random.normal(r2, (4, CFG.GAN.CONDITION_DIM)))
    return dict(clip=_np(clip_vars["params"]), before=_np(state),
                after=_np(new), metrics=_np(metrics), batch=batch,
                noise=[np.asarray(n) for n in noise])


def _port_gen(params, stats):
    return load_jax_generator(build_generator(TCFG),
                              {"params": params, "batch_stats": stats})


def _port_ds(params, spectral):
    return [load_jax_discriminator(d, {"params": p, "spectral": s})
            for d, p, s in zip(build_discriminators(TCFG), params, spectral)]


@pytest.fixture(scope="module")
def port_step(jax_step):
    before = jax_step["before"]
    clip = load_jax_clip(build_clip(port_clip_cfg(TINY_CLIP)),
                         jax_step["clip"]).requires_grad_(False)
    gen = _port_gen(before.g_params, before.g_batch_stats)
    ds = _port_ds(before.d_params, before.d_spectral)
    sgd = functools.partial(torch.optim.SGD, lr=LR)
    state = init_gan_state(TCFG, gen, ds, sgd, sgd)
    step = make_gan_step(TCFG, clip)
    metrics = step(state, jax_step["batch"], *map(torch.tensor,
                                                  jax_step["noise"]))
    return state, {k: float(v) for k, v in metrics.items()}


def _assert_same_state(a, b, buffers=True):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    params = {n for n, _ in a.named_parameters()}
    for name in sa:
        if buffers or name in params:
            np.testing.assert_allclose(sa[name].detach().numpy(),
                                       sb[name].numpy(), err_msg=name, **TOL)


def test_step_metrics(jax_step, port_step):
    _, metrics = port_step
    ref = jax_step["metrics"]
    assert metrics.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(metrics[k], float(ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_step_metrics_rows_match_the_jax_logger(jax_step, port_step,
                                                tmp_path):
    """The step's metrics through each package's ``MetricsLogger`` (the
    port's as 0-dim tensors, the step's return type): rows with the same
    keys, values within the step bound above."""
    import json

    from t2igan.utils.logging import MetricsLogger as JLogger
    from t2igan_torch.utils.logging import MetricsLogger

    rows = []
    for logger, metrics in (
            (JLogger(str(tmp_path / "jax")), jax_step["metrics"]),
            (MetricsLogger(str(tmp_path / "port")),
             {k: torch.tensor(v) for k, v in port_step[1].items()})):
        logger.log(1, dict(metrics, images_per_sec=3.0))
        logger.close()
        with open(logger.path) as f:
            rows.append(json.loads(f.read()))
    want, got = rows
    assert list(got) == ["step", "time", "prefix"] + list(port_step[1]) + [
        "images_per_sec"]
    assert set(got) == set(want)
    for k in set(want) - {"time", "prefix"}:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_step_generator_and_batch_stats(jax_step, port_step):
    state, _ = port_step
    after = jax_step["after"]
    assert state.step == 1
    _assert_same_state(state.gen, _port_gen(after.g_params,
                                            after.g_batch_stats))


def test_step_ema(jax_step, port_step):
    state, _ = port_step
    after = jax_step["after"]
    _assert_same_state(state.gen_ema,
                       _port_gen(after.g_ema_params, after.g_batch_stats),
                       buffers=False)
    # 0.999 * old + 0.001 * new for one tensor, exactly as ema_update.
    old = torch.tensor(jax_step["before"].g_params["CANet_0"]["Dense_0"]
                       ["kernel"].T)
    new = state.gen.ca_net.fc.weight.detach()
    torch.testing.assert_close(state.gen_ema.ca_net.fc.weight,
                               0.999 * old + 0.001 * new, rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("scale", [0, 1])
def test_step_discriminators_and_spectral(jax_step, port_step, scale):
    state, _ = port_step
    after, before = jax_step["after"], jax_step["before"]
    want = _port_ds(after.d_params, after.d_spectral)[scale]
    _assert_same_state(state.ds[scale], want)
    # The trunk's u moved; the conditional head's stayed.
    was = _port_ds(before.d_params, before.d_spectral)[scale]
    d = state.ds[scale]
    assert not torch.equal(d.trunk.encode.blocks[1].conv.u,
                           was.trunk.encode.blocks[1].conv.u)
    assert torch.equal(d.cond_head.joint.conv.u, was.cond_head.joint.conv.u)


def test_adam_matches_optax():
    """``gan_optimizers`` against ``optax.adam`` of the JAX package over a
    few steps of fixed gradients."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(4)]
    g_tx, _ = jgan_optimizers(CFG)
    jp, opt = jnp.asarray(p0), g_tx.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    g_factory, d_factory = gan_optimizers(TCFG)
    adam = g_factory([param])
    assert d_factory([param]).defaults["lr"] == CFG.TRAIN.DISCRIMINATOR_LR
    for g in grads:
        upd, opt = g_tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g)
        adam.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def test_noise_comes_from_the_generator_when_not_given(port_step, jax_step):
    state, _ = port_step
    step = make_gan_step(TCFG, load_jax_clip(build_clip(port_clip_cfg(
        TINY_CLIP)), jax_step["clip"]))
    with pytest.raises(ValueError, match="torch.Generator"):
        step(state, jax_step["batch"])


TINY_YAML = """\
TREE: {BASE_SIZE: 64, BRANCH_NUM: 2}
GAN: {GF_DIM: 8, DF_DIM: 4, Z_DIM: 16, CONDITION_DIM: 16, R_NUM: 1}
TEXT: {EMBEDDING_DIM: 32, WORDS_NUM: 16}
TRAIN: {BATCH_SIZE: 4}
"""


def test_train_gan_entry_point_on_cpu(tmp_path, capsys):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    trainer = train_gan.main(["--cfg", str(cfg), "--steps", "2",
                              "--device", "cpu"],
                             clip_cfg=port_clip_cfg(TINY_CLIP))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[")]
    assert [ln.split("]")[0] for ln in lines] == ["[1", "[2"]
    for ln in lines:
        d = float(ln.split("Loss_D: ")[1].split()[0])
        g = float(ln.split("Loss_G: ")[1].split()[0])
        assert np.isfinite(d) and np.isfinite(g)
    assert trainer.state.step == 2


def test_train_gan_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gan.main(["--cfg", str(cfg), "--steps", "1"],
                       clip_cfg=port_clip_cfg(TINY_CLIP))


def test_synthetic_dataset_is_the_jax_one():
    from t2igan.data.synthetic import SyntheticDataset as JDataset
    from t2igan_torch.data.synthetic import SyntheticDataset

    ours, ref = SyntheticDataset(TCFG, seed=3), JDataset(CFG, seed=3)
    for i in (0, 5):
        a, b = ours[i], ref[i]
        assert dataclasses.asdict(a).keys() == {
            "images", "caption", "caption_2", "class_id", "key"}
        assert (a.caption, a.caption_2, a.class_id, a.key) == (
            b.caption, b.caption_2, b.class_id, b.key)
        for x, y in zip(a.images, b.images):
            np.testing.assert_array_equal(x, y)
    assert len(ours) == len(ref)
