"""A full train state resumed under another data-parallel layout, on the
CPU (ROADMAP F30).

Both trainers keep one dataset generator state per host in their full
state.  Resumed under another host count they restore the model and
optimizer state and the epochs done, start the data streams and any
part-epoch afresh, and print one line naming both counts; under the same
host count (whatever the local rank count) they keep the data state.

* One process with ``DataMesh`` host fields (as the loader-split tests
  use them): a 1-host state resumed on host 1 of 2, a 2-host state (its
  per-host list written as a 2-host run writes it) resumed on 1 host, and
  both controls, for ``CondGanTrainer`` and ``DamsmTrainer``.
* The port's counterpart of ``tests/test_checkpoint.py``'s
  ``test_restore_across_device_counts``: a GAN state saved by 2 gloo
  ranks on 2 hosts, resumed in one process, saved, then resumed by 2
  ranks on one host, one step each, every step held to the JAX step
  chain on the same batches and noise (SGD lr 0.01) at
  ``test_torch_port_gan_step.py``'s bounds: metrics 1e-4 relative,
  parameters, spectral vectors and running statistics 1e-4 absolute +
  1e-4 relative.  The rate is 0.01, not that test's 1: over three steps
  at lr 1 this tiny GAN amplifies f32 rounding past any bound, and the
  port's own one-process chain already reads 6.9 from the JAX chain on a
  running variance at step 3 (0.00015 at lr 0.01).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_parallel_workers as workers
from test_torch_port_damsm import PCFG
from test_torch_port_gan_step import _port_ds, _port_gen
from test_torch_port_train_modules import TCFG, port_clip_cfg
from test_train_steps import CFG, TINY_CLIP, _gan_batch
from t2igan.models import clip as jclip
from t2igan.models.factory import (build_discriminators as jbuild_ds,
                                   build_generator as jbuild_gen)
from t2igan.train.state import init_gan_state as jinit_state
from t2igan.train.steps import make_gan_step as jmake_step
from t2igan_torch import config as tconfig
from t2igan_torch.models.convert import load_jax_clip
from t2igan_torch.models.factory import build_clip
from t2igan_torch.parallel.mesh import DataMesh, spawn_local
from t2igan_torch.train import train_gan
from t2igan_torch.train.checkpoint import CheckpointManager
from t2igan_torch.train.pretrain_damsm import DamsmTrainer, data_rng_state
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.train_gan import CondGanTrainer

CLIP_CFG = port_clip_cfg(TINY_CLIP)
TOL = dict(rtol=1e-4, atol=1e-4)
LR = 0.01
GAN_CFG = tconfig.cfg_replace(TCFG, DATA_DIR="", WORKERS=1,
                              TRAIN={"CLIP_MODEL_CHECKPOINT": "",
                                     "BATCH_SIZE": 4})
# 2 steps an epoch of the synthetic 64 records.
DAMSM_CFG = tconfig.cfg_replace(
    PCFG, DATA_DIR="", WORKERS=1, TREE={"BRANCH_NUM": 1, "BASE_SIZE": 32},
    TRAIN={"BATCH_SIZE": 32, "EVAL_MAX_BATCHES": 1, "SNAPSHOT_INTERVAL": 1})
# (hosts in the saved state, the resuming mesh's host_index, host_count)
LAYOUTS = [(1, 1, 2), (2, 0, 1), (1, 0, 1), (2, 1, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(host_index, host_count):
    return DataMesh(host_index=host_index, host_count=host_count)


def _moved(state, n):
    """A dataset generator state ``n`` draws on from ``state``."""
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    rng.random(n)
    return rng.bit_generator.state


def _as_hosts(path, key, hosts):
    """Rewrite a full state's per-host ``key`` list for ``hosts`` hosts, as
    a run on that many hosts writes it (host h's generator h + 1 draws on
    from the saved one); returns the list."""
    payload = torch.load(path, weights_only=True)
    base = payload[key]
    by_host = [_moved(base, h + 1) for h in range(hosts)]
    payload[key + "_by_host"] = by_host
    torch.save(payload, path)
    return by_host


def _tensors(modules, opts):
    out = {}
    for i, m in enumerate(modules):
        out.update({f"{i}.{k}": v for k, v in m.state_dict().items()})
    for i, opt in enumerate(opts):
        for j, st in opt.state_dict()["state"].items():
            out.update({f"opt{i}.{j}.{k}": v for k, v in st.items()})
    return out


def _assert_bitwise(a, b):
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _line(saved, resumed):
    return (f"NOTE: the state was saved on {saved} host(s) and resumes on "
            f"{resumed}")


@pytest.mark.parametrize("saved,host,hosts", LAYOUTS)
def test_gan_trainer_resumes_under_another_host_count(tmp_path, capsys,
                                                      saved, host, hosts):
    first = CondGanTrainer(GAN_CFG, "cpu", clip_cfg=CLIP_CFG,
                           output_dir=str(tmp_path))
    first.train_steps(2)
    first._epoch_left = (first.loader.next_order(), 1)
    first.loader.epoch = 3
    first._data_rng = _moved(data_rng_state(first.dataset), 5)
    path = first.save_state()
    by_host = [first._data_rng]
    if saved == 2:
        by_host = _as_hosts(path, "data_rng", 2)
    capsys.readouterr()

    again = CondGanTrainer(GAN_CFG, "cpu", clip_cfg=CLIP_CFG,
                           output_dir=str(tmp_path),
                           mesh=_mesh(host, hosts))
    out = capsys.readouterr().out
    s, t = first.state, again.state
    _assert_bitwise(_tensors([s.gen, s.gen_ema, *s.ds], [s.g_opt, *s.d_opts]),
                    _tensors([t.gen, t.gen_ema, *t.ds], [t.g_opt, *t.d_opts]))
    assert t.step == 2 and again.epoch == first.epoch
    assert torch.equal(again.noise.get_state(), first.noise.get_state())
    fresh = data_rng_state(train_gan.make_dataset(GAN_CFG, "train"))
    if saved == hosts:
        assert _line(saved, hosts) not in out
        assert again.loader.epoch == 3
        np.testing.assert_array_equal(again._epoch_left[0],
                                      first._epoch_left[0])
        assert again._epoch_left[1] == 1
        assert again._data_rng == by_host[host]
        assert data_rng_state(again.dataset) == by_host[host]
    else:
        assert _line(saved, hosts) in out
        assert again.loader.epoch == 0 and again._epoch_left is None
        assert again._data_rng == fresh
        assert data_rng_state(again.dataset) == fresh
    # Training goes on under the new layout.
    again.train_steps(1)
    assert t.step == 3


def _damsm(out, mesh=None):
    return DamsmTrainer(DAMSM_CFG, str(out), "cpu", clip_cfg=CLIP_CFG,
                        words_num=16, mesh=mesh)


@pytest.mark.parametrize("saved,host,hosts", LAYOUTS)
def test_damsm_trainer_resumes_under_another_host_count(tmp_path, capsys,
                                                        saved, host, hosts):
    first = _damsm(tmp_path)
    first.train_epoch(0)
    first.epoch = 1
    for loader in (first.train_batches, first.val_batches):
        loader.epoch = 3
        loader.dataset.rng.random(4)
    first.snapshot(0)
    path = CheckpointManager(str(tmp_path / "Model")).path(first.state.step)
    rngs = {key: [data_rng_state(loader.dataset)]
            for loader, key in ((first.train_batches, "train_rng"),
                                (first.val_batches, "val_rng"))}
    if saved == 2:
        rngs = {key: _as_hosts(path, key, 2) for key in rngs}
    capsys.readouterr()

    again = _damsm(tmp_path, _mesh(host, hosts))
    out = capsys.readouterr().out
    a, b = first.state, again.state
    _assert_bitwise(_tensors([a.clip], [a.opt.adam]),
                    _tensors([b.clip], [b.opt.adam]))
    assert b.opt.count == a.opt.count > 0 and again.epoch == 1
    fresh = _damsm(tmp_path / "fresh")
    for key, loader, new in (
            ("train_rng", again.train_batches, fresh.train_batches),
            ("val_rng", again.val_batches, fresh.val_batches)):
        if saved == hosts:
            assert loader.epoch == 3
            assert data_rng_state(loader.dataset) == rngs[key][host]
        else:
            assert loader.epoch == 0
            assert data_rng_state(loader.dataset) == data_rng_state(
                new.dataset)
    assert (_line(saved, hosts) in out) == (saved != hosts)
    metrics = again.train_epoch(1)
    assert np.isfinite(metrics["loss"])


# -------------------------------------------- across process layouts ----

@pytest.fixture(scope="module")
def jax_chain():
    """The JAX step (SGD lr 0.01) three times from fixed variables on three
    batches and keys: the batches, each step's noise, the states after
    each step and their metrics; the port's state dicts of the start."""
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
    np_tree = functools.partial(jax.tree.map, np.asarray)
    before = np_tree(state)
    sd = {"clip": load_jax_clip(build_clip(CLIP_CFG),
                                np_tree(clip_vars["params"])).state_dict(),
          "gen": _port_gen(before.g_params,
                           before.g_batch_stats).state_dict(),
          "ds": [d.state_dict() for d in _port_ds(before.d_params,
                                                  before.d_spectral)]}
    batches, noises, afters, metrics = [], [], [], []
    for i in range(3):
        batch = _gan_batch(np.random.default_rng(20 + i))
        rng = jax.random.PRNGKey(30 + i)
        state, m = step(state, clip_vars["params"], batch, rng)
        rz, r1, r2 = jax.random.split(rng, 3)
        noises.append([np.asarray(jax.random.normal(r, (4, dim))) for r, dim
                       in ((rz, CFG.GAN.Z_DIM), (r1, CFG.GAN.CONDITION_DIM),
                           (r2, CFG.GAN.CONDITION_DIM))])
        batches.append(batch)
        afters.append(np_tree(state))
        metrics.append(np_tree(m))
    return dict(sd=sd, batches=batches, noises=noises, afters=afters,
                metrics=metrics)


def _assert_step_matches_jax(got, jax_chain, i):
    ref = jax_chain["metrics"][i]
    assert got["metrics"].keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got["metrics"][k], float(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    after = jax_chain["afters"][i]
    want = [_port_gen(after.g_params, after.g_batch_stats),
            _port_gen(after.g_ema_params, after.g_batch_stats),
            *_port_ds(after.d_params, after.d_spectral)]
    for j, (sd, module) in enumerate(zip(got["after"], want)):
        params = {n for n, _ in module.named_parameters()}
        for name, val in module.state_dict().items():
            # The EMA G keeps G's statistics (ROADMAP F15).
            if j != 1 or name in params:
                np.testing.assert_allclose(sd[name].numpy(),
                                           val.detach().numpy(),
                                           err_msg=name, **TOL)


def test_gan_state_across_two_hosts_one_process_and_two_ranks(
        jax_chain, tmp_path, capsys, monkeypatch):
    """2 gloo ranks, each a host, take step 1 and save; one process
    resumes (another host count: data state dropped), takes step 2 and
    saves; 2 ranks of one host resume (the same host count: data state
    kept) and take step 3.  Every step against the JAX chain."""
    cfg2 = tconfig.cfg_replace(GAN_CFG, TRAIN={"BATCH_SIZE": 2})
    out = str(tmp_path / "run")
    v = jax_chain

    two_hosts = spawn_local(workers.resume_step, 2, "gloo", "cpu",
                            str(tmp_path / "store0"), 120.0,
                            (cfg2, CLIP_CFG, v["sd"], out, v["batches"][0],
                             v["noises"][0], LR, True, 2, 1), 1)
    for rank in two_hosts:
        assert rank["resumed"]["step"] == 0
        _assert_step_matches_jax(rank, v, 0)
    assert two_hosts[0]["saved_rng"] != two_hosts[1]["saved_rng"]
    payload, step = CheckpointManager(out + "/Model").restore()
    assert step == 1 and payload["data_rng_by_host"] == [
        r["saved_rng"] for r in two_hosts]

    # resume_step swaps the trainer's init_gan_state; monkeypatch puts
    # this process's back afterwards.
    monkeypatch.setattr(train_gan, "init_gan_state", init_gan_state)
    capsys.readouterr()
    one = workers.resume_step(DataMesh.single("cpu"), GAN_CFG, CLIP_CFG,
                              v["sd"], out, v["batches"][1], v["noises"][1],
                              LR, loader_epoch=4, draws=3)
    assert _line(2, 1) in capsys.readouterr().out
    fresh = data_rng_state(train_gan.make_dataset(GAN_CFG, "train"))
    assert one["resumed"] == {"step": 1, "loader_epoch": 0,
                              "data_rng": fresh}
    _assert_step_matches_jax(one, v, 1)

    two_ranks = spawn_local(workers.resume_step, 2, "gloo", "cpu",
                            str(tmp_path / "store2"), 120.0,
                            (GAN_CFG, CLIP_CFG, v["sd"], out,
                             v["batches"][2], v["noises"][2], LR), 1)
    for rank in two_ranks:
        assert rank["resumed"] == {"step": 2, "loader_epoch": 4,
                                   "data_rng": one["saved_rng"]}
        _assert_step_matches_jax(rank, v, 2)
