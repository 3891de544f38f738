"""Weights in and out of the port, and resume, on the CPU: the EMA
generator's batch statistics (ROADMAP F15), ``netG_epoch_%d.pth`` and
``netD%d.pth`` under the reference's names against the JAX package's
torch converters, the ``.npz`` generator export in both directions, the
loaders' errors, epoch names, and bitwise resume of ``CondGanTrainer`` and
``DamsmTrainer`` from their full train states.

Widths are ``TINY_CLIP`` and ``CFG`` of ``tests/test_train_steps.py``
(two 2-layer towers, GF 8, DF 4, two scales); the generator round trips
also run at three scales with ``R_NUM`` 2 and 3.  JAX variables come from
``.init`` and cross through the port's loaders.  Tolerances in f32:
sampler images and discriminator logits 1e-4 absolute and relative (the
sampler tests' bound: the same weights through two packages' kernels); a
file read back into the port, and a resumed run against an uninterrupted
one, bitwise.
"""

import copy
import dataclasses
import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_damsm import CLI_CLIP
from test_torch_port_damsm import TINY_YAML as DAMSM_YAML
from test_torch_port_train_modules import TCFG, port_clip_cfg
from test_train_steps import CFG, TINY_CLIP, _gan_batch
from t2igan.config import cfg_replace as j_cfg_replace
from t2igan.models import clip as jclip
from t2igan.models.discriminator import DNetWithHeads as JDNet
from t2igan.models.factory import (build_discriminators as jbuild_ds,
                                   build_generator as jbuild_gen)
from t2igan.train import checkpoint as jckpt
from t2igan.train import export as jexport
from t2igan.train.state import init_gan_state as jinit_state
from t2igan.train.steps import make_gan_step as jmake_step
from t2igan.train.steps import make_sampler as jmake_sampler
from t2igan_torch import config as tconfig
from t2igan_torch.models.convert import (
    discriminator_reference_state_dict, generator_reference_state_dict,
    jax_generator_variables, load_discriminator_pth, load_generator_pth,
    load_jax_clip, load_jax_discriminator, load_jax_generator,
    load_reference_discriminator_state, load_reference_generator_state,
    save_discriminator_pth, save_generator_pth)
from t2igan_torch.models.discriminator import (DNetWithHeads,
                                               init_discriminator_)
from t2igan_torch.models.factory import (build_clip, build_discriminators,
                                         build_generator)
from t2igan_torch.models.generator import BatchNorm, init_generator_
from t2igan_torch.train import checkpoint as tckpt
from t2igan_torch.train.export import load_generator_npz, save_generator_npz
from t2igan_torch.train.pretrain_damsm import DamsmTrainer
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.steps import make_gan_step, make_sampler
from t2igan_torch.train.train_gan import CondGanTrainer

TOL = dict(rtol=1e-4, atol=1e-4)
LR = 0.1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _clip():
    """(JAX model, its params as numpy, the port's text side)."""
    model = jclip.ClipWithRegionHead(TINY_CLIP)
    v = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    params = _np(v["params"])
    port = load_jax_clip(build_clip(port_clip_cfg(TINY_CLIP)),
                         params).requires_grad_(False)
    return model, params, port


def _inputs(seed=5, b=3):
    rng = np.random.default_rng(seed)
    batch = _gan_batch(rng, b=b)
    z = rng.standard_normal((b, CFG.GAN.Z_DIM)).astype(np.float32)
    eps = rng.standard_normal((b, CFG.GAN.CONDITION_DIM)).astype(np.float32)
    return batch["ids"], batch["mask"], z, eps


def _jax_images(jcfg, variables, inputs):
    model, params, _ = _clip()
    gen = jbuild_gen(jcfg)
    return [np.asarray(x) for x in jmake_sampler(jcfg, model, gen)(
        params, variables["params"], variables["batch_stats"], *inputs)[0]]


def _port_images(cfg, gen, inputs):
    return [x.numpy() for x in make_sampler(cfg, _clip()[2], gen)(*inputs)]


def _assert_images(port, ref):
    assert len(port) == len(ref)
    for a, r in zip(port, ref):
        np.testing.assert_allclose(a, r, **TOL)


def _assert_same_modules(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


# ------------------------------------------------------ F15: EMA stats ----

@pytest.fixture(scope="module")
def two_steps():
    """Two JAX steps and two port steps (SGD) from the same variables,
    batches and noise."""
    model, clip_params, clip = _clip()
    gen, ds = jbuild_gen(CFG), jbuild_ds(CFG)
    state = jax.jit(lambda r: jinit_state(CFG, gen, ds, r))(
        jax.random.PRNGKey(1))
    tx = optax.sgd(LR)
    state = state.replace(g_opt_state=tx.init(state.g_params),
                          d_opt_states=[tx.init(p) for p in state.d_params])
    before = _np(state)
    jstep = jax.jit(jmake_step(CFG, model, gen, ds, tx, tx))

    pgen = load_jax_generator(build_generator(TCFG), {
        "params": before.g_params, "batch_stats": before.g_batch_stats})
    pds = [load_jax_discriminator(d, {"params": p, "spectral": s})
           for d, p, s in zip(build_discriminators(TCFG), before.d_params,
                              before.d_spectral)]
    sgd = functools.partial(torch.optim.SGD, lr=LR)
    pstate = init_gan_state(TCFG, pgen, pds, sgd, sgd)
    pstep = make_gan_step(TCFG, clip)
    rng = np.random.default_rng(1)
    for k in range(2):
        batch = _gan_batch(rng)
        key = jax.random.PRNGKey(2 + k)
        state, _ = jstep(state, clip_params, batch, key)
        noise = [torch.tensor(np.asarray(jax.random.normal(
            r, (4, CFG.GAN.Z_DIM if i == 0 else CFG.GAN.CONDITION_DIM))))
            for i, r in enumerate(jax.random.split(key, 3))]
        pstep(pstate, batch, *noise)
    return _np(state), pstate


def test_ema_generator_samples_with_the_trained_statistics(two_steps):
    """F15: the EMA G samples with G's running statistics, as the JAX
    sampler fed ``(g_ema_params, g_batch_stats)``; before the repair its
    statistics stayed at their initial 0 and 1."""
    after, pstate = two_steps
    inputs = _inputs()
    ref = _jax_images(CFG, {"params": after.g_ema_params,
                            "batch_stats": after.g_batch_stats}, inputs)
    _assert_images(_port_images(TCFG, pstate.gen_ema, inputs), ref)
    for e, g in zip(pstate.gen_ema.buffers(), pstate.gen.buffers()):
        assert torch.equal(e, g) and e.data_ptr() != g.data_ptr()


def test_ema_checkpoint_and_export_agree_with_the_ema_sampler(two_steps,
                                                              tmp_path):
    """The EMA sampler, ``netG_epoch_%d.pth`` and the ``.npz`` hold the
    same generator: EMA parameters with G's statistics."""
    _, pstate = two_steps
    inputs = _inputs()
    want = _port_images(TCFG, pstate.gen_ema, inputs)
    save_generator_pth(pstate.gen_ema, str(tmp_path / "netG_epoch_1.pth"),
                       stats_from=pstate.gen)
    path = save_generator_npz(str(tmp_path / "netG_epoch_1"), pstate.gen_ema,
                              pstate.gen)
    from_pth = load_generator_pth(build_generator(TCFG),
                                  str(tmp_path / "netG_epoch_1.pth"))
    from_npz = load_jax_generator(build_generator(TCFG),
                                  load_generator_npz(path))
    for gen in (from_pth, from_npz):
        for a, b in zip(_port_images(TCFG, gen, inputs), want):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------ generator .pth / .npz ----

def _jcfg(r_num, branches=3):
    return j_cfg_replace(CFG, TREE={"BRANCH_NUM": branches},
                         GAN={"R_NUM": r_num})


def _tcfg(jcfg):
    return tconfig.cfg_from_dict(dataclasses.asdict(jcfg))


@torch.no_grad()
def _random_port_gen(cfg, seed):
    """A port G with random weights and non-trivial running statistics."""
    g = torch.Generator().manual_seed(seed)
    gen = init_generator_(build_generator(cfg), g)
    for m in gen.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return gen


@pytest.mark.parametrize("r_num", [2, 3])
def test_port_generator_pth_loads_in_jax(tmp_path, r_num):
    """Port EMA G (with G's statistics) -> netG_epoch_3.pth -> the JAX
    package's ``load_torch_generator`` (R_NUM inferred from the keys) ->
    the JAX sampler equals the port's."""
    jcfg = _jcfg(r_num)
    cfg = _tcfg(jcfg)
    gen, ema = _random_port_gen(cfg, 1), _random_port_gen(cfg, 2)
    path = str(tmp_path / "Model" / "netG_epoch_3.pth")
    save_generator_pth(ema, path, stats_from=gen)
    variables = jckpt.load_torch_generator(path, branch_num=3)
    want = copy.deepcopy(ema)
    with torch.no_grad():
        for w, g in zip(want.buffers(), gen.buffers()):
            w.copy_(g)
    inputs = _inputs()
    _assert_images(_port_images(cfg, want, inputs),
                   _jax_images(jcfg, variables, inputs))
    _assert_same_modules(load_generator_pth(build_generator(cfg), path), want)
    assert tckpt.parse_epoch_from_path(path) == 3


def test_jax_generator_through_the_port_pth(tmp_path):
    """JAX variables -> port G -> netG_epoch_0.pth -> a fresh port G: the
    sampler still equals the JAX one."""
    jcfg = _jcfg(2)
    cfg = _tcfg(jcfg)
    inputs = _inputs()
    variables = _np(jax.jit(jbuild_gen(jcfg).init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(4), "gaussian": jax.random.PRNGKey(5)},
        inputs[2], np.zeros((3, 32), np.float32),
        np.zeros((3, 16, 32), np.float32), inputs[1] == 0, False, inputs[3]))
    rng = np.random.default_rng(6)
    variables["batch_stats"] = jax.tree.map(
        lambda x: (x + rng.uniform(0.0, 0.2, x.shape)).astype(np.float32),
        variables["batch_stats"])
    path = str(tmp_path / "netG_epoch_0.pth")
    save_generator_pth(load_jax_generator(build_generator(cfg), variables),
                       path)
    gen = load_generator_pth(build_generator(cfg), path)
    _assert_images(_port_images(cfg, gen, inputs),
                   _jax_images(jcfg, variables, inputs))


def test_jax_npz_export_loads_in_the_port(tmp_path):
    """The JAX package's ``save_generator`` -> ``load_generator_npz`` (numpy
    only) -> the port's sampler equals the JAX one."""
    jcfg = _jcfg(2)
    cfg = _tcfg(jcfg)
    variables = jax_generator_variables(_random_port_gen(cfg, 7))
    path = jexport.save_generator(str(tmp_path / "G"), variables["params"],
                                  variables["batch_stats"])
    loaded = load_generator_npz(path)
    assert jax.tree.structure(loaded) == jax.tree.structure(variables)
    port = load_jax_generator(build_generator(cfg), loaded)
    inputs = _inputs()
    _assert_images(_port_images(cfg, port, inputs),
                   _jax_images(jcfg, variables, inputs))


def test_port_npz_export_loads_in_jax(tmp_path):
    """``save_generator_npz`` (EMA params, G's statistics) -> the JAX
    package's ``load_generator`` -> the JAX sampler equals the port's."""
    jcfg = _jcfg(3)
    cfg = _tcfg(jcfg)
    gen, ema = _random_port_gen(cfg, 8), _random_port_gen(cfg, 9)
    path = save_generator_npz(str(tmp_path / "netG_epoch_2"), ema, gen)
    assert path.endswith("netG_epoch_2.npz")
    params, stats = jexport.load_generator(path)
    want = copy.deepcopy(ema)
    with torch.no_grad():
        for w, g in zip(want.buffers(), gen.buffers()):
            w.copy_(g)
    inputs = _inputs()
    _assert_images(_port_images(cfg, want, inputs),
                   _jax_images(jcfg, {"params": params,
                                      "batch_stats": stats}, inputs))


# ---------------------------------------------------- discriminators ----

@pytest.mark.parametrize("size", [64, 128, 256])
def test_port_discriminator_pth_loads_in_jax(tmp_path, size):
    """Port D -> netD%d.pth -> the JAX package's ``load_torch_discriminator``:
    the same logits, and the spectral vectors equal after the permutation
    of ``v`` (read back into a port D, every tensor bitwise)."""
    d = init_discriminator_(DNetWithHeads(4, 32, size),
                            torch.Generator().manual_seed(size))
    path = str(tmp_path / "netD0.pth")
    save_discriminator_pth(d, path)
    variables = _np(jckpt.load_torch_discriminator(path, img_size=size))
    _assert_same_modules(load_jax_discriminator(DNetWithHeads(4, 32, size),
                                                variables), d)
    _assert_same_modules(load_discriminator_pth(DNetWithHeads(4, 32, size),
                                                path), d)
    rng = np.random.default_rng(size)
    x = (rng.standard_normal((2, size, size, 3)) * 0.5).astype(np.float32)
    c = rng.standard_normal((2, 32)).astype(np.float32)
    jd = JDNet(ndf=4, nef=32, img_size=size)
    h = jd.apply(variables, x, method=jd.features)
    with torch.no_grad():
        th = d.features(torch.from_numpy(x))
        got = (th, d.cond(th, torch.from_numpy(c)), d.uncond(th))
    for a, r in zip(got, (h, jd.apply(variables, h, c, method=jd.cond),
                          jd.apply(variables, h, method=jd.uncond))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    # The reference keeps v in (in, kh, kw) order.
    sd = discriminator_reference_state_dict(d)
    w = d.trunk.encode.blocks[1].conv.weight
    np.testing.assert_array_equal(
        sd["img_code_s16.2.module.weight_v"].numpy().reshape(
            w.shape[1], 4, 4).transpose(1, 2, 0).reshape(-1),
        d.trunk.encode.blocks[1].conv.v.numpy())


# ---------------------------------------------------- loader errors ----

def _break(kind, sd):
    key = next(k for k in sd if k.endswith("weight"))
    if kind == "missing":
        sd.pop(key)
    elif kind == "extra":
        sd["extra.weight"] = torch.zeros(1)
    else:
        sd[key] = torch.zeros(3, 3)
    return sd


@pytest.mark.parametrize("kind, error", [("missing", KeyError),
                                         ("extra", ValueError),
                                         ("shape", ValueError)])
@pytest.mark.parametrize("net", ["G", "D"])
def test_reference_loaders_raise(net, kind, error):
    if net == "G":
        module = _random_port_gen(TCFG, 0)
        sd, load = generator_reference_state_dict(module), \
            load_reference_generator_state
    else:
        module = init_discriminator_(DNetWithHeads(4, 32, 128),
                                     torch.Generator().manual_seed(0))
        sd, load = discriminator_reference_state_dict(module), \
            load_reference_discriminator_state
    with pytest.raises(error):
        load(copy.deepcopy(module), _break(kind, sd))


@pytest.mark.parametrize("dcgan", [False, True])
def test_reference_loaders_take_the_dataparallel_prefix_and_refuse_dcgan(
        dcgan):
    """A ``G_NET`` (or, under ``GAN.B_DCGAN``, ``G_DCGAN``) dict with
    DataParallel's prefix reads back bitwise; another ``R_NUM`` raises,
    and so does the other generator class's dict, naming the config
    key."""
    cfg = tconfig.cfg_replace(TCFG, GAN={"B_DCGAN": dcgan})
    other = tconfig.cfg_replace(TCFG, GAN={"B_DCGAN": not dcgan})
    gen = _random_port_gen(cfg, 3)
    assert type(gen).__name__ == ("GDCGan" if dcgan else "GNet")
    sd = {f"module.{k}": v for k, v in
          generator_reference_state_dict(gen).items()}
    assert ("module.img_net.img.0.weight" in sd) == dcgan
    _assert_same_modules(load_reference_generator_state(
        build_generator(cfg), sd), gen)
    with pytest.raises(KeyError):  # another R_NUM
        load_reference_generator_state(build_generator(
            tconfig.cfg_replace(cfg, GAN={"R_NUM": 2})), sd)
    with pytest.raises(ValueError, match="GAN.B_DCGAN"):
        load_reference_generator_state(build_generator(other), sd)


@pytest.mark.parametrize("path", [
    "output/Model/netG_epoch_550.pth", "netG_epoch_0.pth", "clip45",
    "clip12.pth", "models/netG_bird", "netD2.pth", "G_epoch_7.npz",
    "run_3/netG.pth", ""])
def test_parse_epoch_from_path_is_the_jax_one(path):
    assert tckpt.parse_epoch_from_path(path) == \
        jckpt.parse_epoch_from_path(path)


# ------------------------------------------------------------ resume ----

GAN_CFG = tconfig.cfg_replace(
    TCFG, DATA_DIR="", TRAIN={"CLIP_MODEL_CHECKPOINT": "", "MAX_EPOCH": 2,
                              "SNAPSHOT_INTERVAL": 1})


def _trainer(out, cfg=GAN_CFG):
    t = CondGanTrainer(cfg, "cpu", clip_cfg=port_clip_cfg(TINY_CLIP),
                       output_dir=str(out))
    t.dataset.n = 8  # 2 steps an epoch
    t.dataset.class_id = t.dataset.class_id[:8]
    return t


def _gan_tensors(t):
    s = t.state
    out = {}
    for name, m in [("G", s.gen), ("EMA", s.gen_ema)] + [
            (f"D{i}", d) for i, d in enumerate(s.ds)]:
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    for name, opt in [("g_opt", s.g_opt)] + [
            (f"d_opt{i}", o) for i, o in enumerate(s.d_opts)]:
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """2 epochs without a stop, written under ``a/``."""
    out = tmp_path_factory.mktemp("straight") / "a"
    t = _trainer(out)
    t.train(2)
    return t, out


def _assert_same_run(straight, resumed, out_b):
    t, out_a = straight
    a, b = _gan_tensors(t), _gan_tensors(resumed)
    assert a.keys() == b.keys() and len(a) > 100
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert t.state.step == resumed.state.step == 4
    assert t.noise.get_state().equal(resumed.noise.get_state())
    for name in ("netG_epoch_0.pth", "netG_epoch_1.pth", "netD1.pth"):
        sa = torch.load(out_a / "Model" / name, weights_only=True)
        sb = torch.load(out_b / "Model" / name, weights_only=True)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_gan_resume_is_bitwise(tmp_path, straight):
    """2 epochs straight against 1 epoch, a fresh trainer resuming from
    the full state, then the second epoch: every parameter, buffer,
    spectral vector and Adam moment bitwise equal, and the same files."""
    first = _trainer(tmp_path / "b")
    first.train(1)
    resumed = _trainer(tmp_path / "b")
    assert (resumed.epoch, resumed.state.step) == (1, 2)
    resumed.train(2)
    _assert_same_run(straight, resumed, tmp_path / "b")
    for out in (straight[1], tmp_path / "b"):
        model = sorted(os.listdir(out / "Model"))
        assert model == ["netD0.pth", "netD1.pth", "netG_epoch_0.pth",
                         "netG_epoch_1.pth", "state_00000002.pt",
                         "state_00000004.pt"]
        assert sorted(os.listdir(out / "Image")) == [
            "G_0.png", "G_0_attn.png", "G_1.png", "G_1_attn.png"]
    rows = [[{k: v for k, v in json.loads(line).items()
              if k not in ("time", "sec_per_step", "images_per_sec")}
             for line in open(out / "metrics.jsonl")]
            for out in (straight[1], tmp_path / "b")]
    assert [r["step"] for r in rows[1]] == [1, 2, 3, 4]
    assert rows[0] == rows[1]


@pytest.mark.parametrize("stop_after", [1, 2, 3])
def test_gan_stop_resumes_at_the_next_batch(tmp_path, straight,
                                            stop_after):
    """A SIGTERM during step ``stop_after`` (mid epoch 0, at its end, mid
    epoch 1; 2 steps an epoch) saves the full state with the epoch's
    order and the batches done and returns; a fresh trainer resuming from
    it takes the rest of that epoch, then the next: bitwise equal to 2
    epochs without a stop, with the same weight files."""
    first = _trainer(tmp_path / "b")
    step_fn = first.step_fn

    def stopping(state, batch, **kwargs):
        out = step_fn(state, batch, **kwargs)
        if state.step == stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    first.step_fn = stopping
    handler = signal.getsignal(signal.SIGTERM)
    first.train(2)
    assert signal.getsignal(signal.SIGTERM) is handler
    assert first.state.step == stop_after
    resumed = _trainer(tmp_path / "b")
    assert (resumed.epoch, resumed.state.step) == ((stop_after - 1) // 2,
                                                   stop_after)
    resumed.train(2)
    _assert_same_run(straight, resumed, tmp_path / "b")


def test_gan_state_keeps_the_newest_five(tmp_path):
    t = _trainer(tmp_path)
    t.dataset.n = 4  # 1 step an epoch
    t.train(7)
    assert tckpt.CheckpointManager(str(tmp_path / "Model")).steps() == [
        3, 4, 5, 6, 7]


def test_gan_pth_resume_sets_g_and_ema_without_aliasing(tmp_path):
    src = _trainer(tmp_path / "src")
    src.train(1)
    path = str(tmp_path / "src" / "Model" / "netG_epoch_0.pth")
    cfg = tconfig.cfg_replace(GAN_CFG, TRAIN={"NET_G": path})
    t = _trainer(tmp_path / "dst", cfg)
    want = load_generator_pth(build_generator(TCFG), path)
    _assert_same_modules(t.state.gen, want)
    _assert_same_modules(t.state.gen_ema, want)
    for d, s in zip(t.state.ds, src.state.ds):
        _assert_same_modules(d, s)
    assert t.epoch == 1
    for a, b in zip(t.state.gen.state_dict().values(),
                    t.state.gen_ema.state_dict().values()):
        assert a.data_ptr() != b.data_ptr()
    with torch.no_grad():
        t.state.gen.ca_net.fc.weight.add_(1.0)
    assert not torch.equal(t.state.gen.ca_net.fc.weight,
                           t.state.gen_ema.ca_net.fc.weight)


def test_gan_npz_resume(tmp_path):
    gen = _random_port_gen(TCFG, 11)
    path = save_generator_npz(str(tmp_path / "netG_epoch_4"), gen)
    cfg = tconfig.cfg_replace(GAN_CFG, TRAIN={"NET_G": path})
    t = _trainer(tmp_path / "out", cfg)
    _assert_same_modules(t.state.gen, gen)
    _assert_same_modules(t.state.gen_ema, gen)
    assert t.epoch == 5


def _damsm_trainer(out, lrs):
    cfg_path = out.parent / "damsm.yml"
    cfg_path.write_text(DAMSM_YAML)
    cfg = tconfig.cfg_replace(tconfig.cfg_from_file(str(cfg_path)),
                              TRAIN={"BATCH_SIZE": 32})
    t = DamsmTrainer(cfg, str(out), "cpu", clip_cfg=CLI_CLIP)
    step = t.step_fn

    def recording(batch):
        lrs.append((t.state.opt.count, {g["name"]: g["lr"] for g in
                                        t.state.opt.adam.param_groups}))
        out = step(batch)
        lrs[-1] = (lrs[-1][0], {g["name"]: g["lr"] for g in
                                t.state.opt.adam.param_groups})
        return out

    t.step_fn = recording
    return t


def test_damsm_resume_is_bitwise(tmp_path):
    """DamsmTrainer: 2 epochs straight against 1 + a fresh trainer that
    resumes + 1: CLIP, both Adam groups' moments, ``count`` and the lr
    each group saw at every step all equal."""
    lrs_a, lrs_b = [], []
    straight = _damsm_trainer(tmp_path / "a", lrs_a)
    straight.train(2)
    first = _damsm_trainer(tmp_path / "b", lrs_b)
    first.train(1)
    resumed = _damsm_trainer(tmp_path / "b", lrs_b)
    assert (resumed.epoch, resumed.state.step) == (1, 2)
    resumed.train(2)
    assert lrs_a == lrs_b and len(lrs_a) == 4
    assert straight.state.opt.count == resumed.state.opt.count == 4
    for (n, a), b in zip(straight.state.clip.state_dict().items(),
                         resumed.state.clip.state_dict().values()):
        assert torch.equal(a, b), n
    sa = straight.state.opt.adam.state_dict()
    sb = resumed.state.opt.adam.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert sorted(os.listdir(tmp_path / "b" / "Model")) == [
        "clip0.pth", "clip1.pth", "state_00000002.pt", "state_00000004.pt"]
