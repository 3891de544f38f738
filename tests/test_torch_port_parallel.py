"""The port's data and tensor parallelism against the JAX package, on the
CPU over gloo.

The rank programs live in ``tests/torch_port_parallel_workers.py`` (torch
and the port only) and run in processes started by
``t2igan_torch.parallel.mesh.spawn_local`` over a ``FileStore`` under
``tmp_path``, each spawn with its own timeout; the JAX references are
computed in this process while the ranks run.  At the widths of
``tests/test_train_steps.py`` (``TINY_CLIP``, ``CFG``), with the JAX
variables carried across by ``models/convert.py``:

* ``ranks_for_batch`` against ``make_mesh_for_batch`` on the 8 virtual
  devices, exactly;
* the loader's (host, local) split against the JAX loader's host batches
  split in device order (records 1e-6, the data tests' bound), and one
  host's local ranks stitched back into today's batches;
* global-batch BatchNorm, 2 ranks against one process on the
  concatenated batch: outputs, gradients, running statistics, 1e-6;
* the GAN step, 2 ranks x 2 rows against the JAX step on the 4-row batch
  (class ids ``[0, 1, 1, 2]``: the wrong pair and a same-class pair cross
  the rank boundary) at ``test_torch_port_gan_step.py``'s bounds: metrics
  1e-4 relative, parameters, spectral vectors and running statistics
  1e-4 absolute + 1e-4 relative; world 1 with a process group bitwise
  equal to the step without one; the ranks bitwise equal after 3 steps;
* the DAMSM step, 2 ranks against JAX at ``test_torch_port_damsm.py``'s
  bounds (loss and gradients 1e-4, the step's metrics 1e-4 relative, the
  parameters after the update within 1e-2 of the learning rate);
* ``sampling()`` over 2 ranks against one process: R, the PNGs' names,
  their pixels within 1 count;
* a 2-rank ``CondGanTrainer`` epoch stopped by a SIGTERM to one rank and
  resumed by fresh trainers, bitwise equal to the epoch straight through;
  ``DamsmTrainer``'s split validation against one process (1e-5);
* ``clip_tp_spec`` against ``_spec_for_path`` for every CLIP parameter
  under the converter's name map; tensor parallelism (data 2 x model 2):
  the DAMSM loss against the replicated port and JAX (1e-5), the sharded
  and replicated gradients against the replicated port (1e-4), and the
  gathered CLIP bitwise the original;
* ``spawn_local`` failing the caller for a rank that raises or outlives
  its timeout, and ``torchrun`` driving ``python -m
  t2igan_torch.train_gan --device cpu`` over 2 gloo ranks.
"""

import io
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from PIL import Image

import torch_port_parallel_workers as workers
from test_torch_port_damsm import (ADAM_MOVE, F32_UNIT, GROUPS, JCFG, LRS,
                                   PCFG, STEPS_PER_EPOCH, _damsm_batch,
                                   _jax_clip, _port_clip)
from test_train_steps import CFG, TINY_CLIP, _gan_batch
from test_torch_port_train_modules import TCFG, port_clip_cfg
from t2igan.models import clip as jclip
from t2igan.models.factory import (build_discriminators as jbuild_ds,
                                   build_generator as jbuild_gen)
from t2igan.parallel.mesh import make_mesh_for_batch
from t2igan.parallel.tp import _spec_for_path
from t2igan.train.state import damsm_optimizer as jdamsm_optimizer
from t2igan.train.state import init_damsm_state as jinit_damsm_state
from t2igan.train.state import init_gan_state as jinit_state
from t2igan.train.steps import make_damsm_loss as jmake_damsm_loss
from t2igan.train.steps import make_damsm_step as jmake_damsm_step
from t2igan.train.steps import make_gan_step as jmake_step
from t2igan_torch import config as tconfig
from t2igan_torch.models.convert import (load_jax_clip, load_jax_discriminator,
                                         load_jax_generator)
from t2igan_torch.models.factory import (build_clip, build_discriminators,
                                         build_generator)
from t2igan_torch.parallel import tp
from t2igan_torch.parallel.mesh import (DataMesh, init_distributed,
                                        ranks_for_batch, spawn_local)
from t2igan_torch.train.schedule import cosine_onecycle

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
SPAWN_TIMEOUT = 120.0
CLIP_CFG = port_clip_cfg(TINY_CLIP)
# Rows 1 and 2 share a class and sit on different ranks; the wrong pair
# of row 1 is row 2, of row 3 row 0.
GAN_CLASSES = np.asarray([0, 1, 1, 2], np.int32)
SWEEP_CFG = tconfig.cfg_replace(TCFG, DATA_DIR="", B_VALIDATION=True,
                                TRAIN={"FLAG": False})
TRAIN_CFG = tconfig.cfg_replace(TCFG, DATA_DIR="",
                                TRAIN={"FLAG": True, "MAX_EPOCH": 1,
                                       "SNAPSHOT_INTERVAL": 1,
                                       "BATCH_SIZE": 8})
DAMSM_CFG = tconfig.cfg_replace(
    PCFG, DATA_DIR="", TREE={"BRANCH_NUM": 1, "BASE_SIZE": 32},
    TRAIN={"BATCH_SIZE": 8, "EVAL_MAX_BATCHES": 2, "SNAPSHOT_INTERVAL": 1})
STOP_AT = 3  # the step after which one rank gets a SIGTERM
EPOCH_STEPS = 8  # the synthetic 64 samples in batches of 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class Background:
    """``fn(*args)`` on a thread; :meth:`result` joins and re-raises."""

    def __init__(self, fn, *args):
        self._out = self._err = None
        self._thread = threading.Thread(target=self._run, args=(fn, args),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._out = fn(*args)
        except BaseException as e:  # re-raised in result()
            self._err = e

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


def _bn_cases():
    rng = np.random.default_rng(11)
    cases = {}
    for name, shape in (("conv", (4, 6, 5, 3)), ("dense", (4, 24))):
        c = shape[1]
        cases[name] = dict(
            x=(rng.standard_normal(shape) * 2 + 0.5).astype(np.float32),
            w=rng.standard_normal(shape).astype(np.float32),
            weight=(1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            bias=(0.1 * rng.standard_normal(c)).astype(np.float32))
    return cases


@pytest.fixture(scope="module")
def jax_vars():
    """The JAX CLIP, G and Ds (SGD), the GAN and DAMSM batches and the
    GAN step's noise; the port's state dicts of the same weights."""
    clip_model = jclip.ClipWithRegionHead(TINY_CLIP)
    clip_vars = jax.jit(clip_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    gen, ds = jbuild_gen(CFG), jbuild_ds(CFG)
    state = jax.jit(lambda r: jinit_state(CFG, gen, ds, r))(
        jax.random.PRNGKey(1))
    tx = optax.sgd(1.0)
    state = state.replace(g_opt_state=tx.init(state.g_params),
                          d_opt_states=[tx.init(p) for p in state.d_params])
    batch = dict(_gan_batch(np.random.default_rng(1)), class_ids=GAN_CLASSES)
    rng = jax.random.PRNGKey(2)
    rz, r1, r2 = jax.random.split(rng, 3)
    noise = [np.asarray(jax.random.normal(r, (4, dim))) for r, dim in
             ((rz, CFG.GAN.Z_DIM), (r1, CFG.GAN.CONDITION_DIM),
              (r2, CFG.GAN.CONDITION_DIM))]
    before = _np(state)
    sd = {"clip": load_jax_clip(build_clip(CLIP_CFG),
                                _np(clip_vars["params"])).state_dict(),
          "gen": _port_gen(before.g_params,
                           before.g_batch_stats).state_dict(),
          "ds": [d.state_dict() for d in _port_ds(before.d_params,
                                                  before.d_spectral)]}
    return dict(clip_model=clip_model, clip=_np(clip_vars["params"]),
                gen=gen, ds=ds, tx=tx, state=state, before=before,
                batch=batch, rng=rng, noise=noise, sd=sd,
                damsm_batch=_damsm_batch(np.random.default_rng(3), b=4))


def _port_gen(params, stats):
    return load_jax_generator(build_generator(TCFG),
                              {"params": params, "batch_stats": stats})


def _port_ds(params, spectral):
    return [load_jax_discriminator(d, {"params": p, "spectral": s})
            for d, p, s in zip(build_discriminators(TCFG), params, spectral)]


@pytest.fixture(scope="module")
def ranks(jax_vars, tmp_path_factory):
    """The 2-rank and the 4-rank programs and the torchrun entry point,
    started together; their results are read where a test needs them."""
    root = tmp_path_factory.mktemp("parallel")
    v = jax_vars
    damsm_clip = _port_clip(_jax_clip()[1]).state_dict()
    jobs = [
        (f"bn_{name}", "batch_norm", case)
        for name, case in _bn_cases().items()] + [
        ("gan", "gan_steps", dict(cfg=TCFG, clip_cfg=CLIP_CFG, sd=v["sd"],
                                  batch=v["batch"], noise=v["noise"])),
        ("damsm", "damsm", dict(cfg=PCFG, clip_cfg=CLIP_CFG,
                                clip_sd=damsm_clip, batch=v["damsm_batch"],
                                steps_per_epoch=STEPS_PER_EPOCH)),
        ("sweep", "sweep", dict(cfg=SWEEP_CFG, clip_cfg=CLIP_CFG,
                                out_dir=str(root / "sweep2"))),
        ("resume", "resume", dict(cfg=TRAIN_CFG, clip_cfg=CLIP_CFG,
                                  root=str(root / "resume"),
                                  stop_at=STOP_AT)),
        ("damsm_trainer", "damsm_trainer",
         dict(cfg=DAMSM_CFG, clip_cfg=CLIP_CFG,
              out_dir=str(root / "damsm2")))]
    two = Background(spawn_local, workers.run_all, 2, "gloo", "cpu",
                     str(root / "store2"), SPAWN_TIMEOUT, (jobs,), 1)
    four = Background(spawn_local, workers.tensor_parallel, 4, "gloo", "cpu",
                      str(root / "store4"), SPAWN_TIMEOUT,
                      (PCFG, CLIP_CFG, damsm_clip, v["damsm_batch"], 2,
                       str(root)), 1)
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "t2igan_torch.train_gan", "--cfg",
         str(_write_cli_cfg(root)), "--steps", "2", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    yield dict(two=two, four=four, cli=cli, root=root)
    if cli.poll() is None:
        cli.kill()


def _write_cli_cfg(root):
    path = root / "tiny.yml"
    path.write_text("TREE: {BASE_SIZE: 64, BRANCH_NUM: 2}\n"
                    "GAN: {GF_DIM: 8, DF_DIM: 4, R_NUM: 1}\n"
                    "TRAIN: {BATCH_SIZE: 4}\n")
    return path


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's torch ops on one thread while the module runs, as
    the ranks': they run beside it, and beside other test processes a
    process that takes every core slows down many times over (ROADMAP
    F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def started(ranks):
    """Start the ranks before the first test of the module."""
    return ranks


@pytest.fixture(scope="module")
def two(ranks, jax_gan_step, jax_damsm):
    """The 2-rank results by job (rank 0, rank 1), read after the JAX
    references (computed while the ranks run)."""
    r0, r1 = ranks["two"].result()
    return {k: (r0[k], r1[k]) for k in r0}


@pytest.fixture(scope="module")
def jax_gan_step(jax_vars, ranks):
    v = jax_vars
    step = jax.jit(jmake_step(CFG, v["clip_model"], v["gen"], v["ds"],
                              v["tx"], v["tx"]))
    new, metrics = step(v["state"], v["clip"], v["batch"], v["rng"])
    return _np(new), _np(metrics)


def _assert_same_state(got, want, buffers=True, params=None):
    assert got.keys() == want.keys()
    for name in got:
        if buffers or name in params:
            np.testing.assert_allclose(got[name].numpy(),
                                       want[name].detach().numpy(),
                                       err_msg=name, **TOL)


def _assert_bitwise(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def _assert_optimizers_bitwise(a, b):
    """Optimizer state dicts equal, every tensor bit for bit."""
    for x, y in zip(a, b):
        assert x["param_groups"] == y["param_groups"]
        assert x["state"].keys() == y["state"].keys()
        for k in x["state"]:
            _assert_bitwise(x["state"][k], y["state"][k], f"state {k}")


# --------------------------------------------------------------- layout --

@pytest.mark.parametrize("batch", range(1, 17))
def test_ranks_for_batch_is_make_mesh_for_batch(batch):
    devices = jax.devices()
    assert len(devices) == 8
    for n in range(1, 9):
        mesh = make_mesh_for_batch(batch, devices[:n])
        assert ranks_for_batch(batch, n) == mesh.devices.size, (batch, n)


def test_single_process_mesh_creates_no_group():
    assert "WORLD_SIZE" not in os.environ and not dist.is_initialized()
    mesh = init_distributed("cpu")
    assert not mesh.distributed and not dist.is_initialized()
    assert (mesh.rank, mesh.world, mesh.device) == (0, 1,
                                                    torch.device("cpu"))
    x = torch.arange(6.0).reshape(3, 2)
    for f in (mesh.local_rows, mesh.gather_rows, mesh.gather_rows_live):
        assert f(x) is x
    assert mesh.for_batch(3) is mesh and mesh.gather_objects(5) == [5]


# --------------------------------------------------------------- loader --

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from test_native_build import build_jax_native
    from test_torch_port_data import configs, make_tree
    build_jax_native()
    return configs(make_tree(tmp_path_factory.mktemp("cub"), n_train=16))


@pytest.mark.parametrize("engine", ["native", "thread"])
@pytest.mark.parametrize("hosts,local", [(1, 2), (2, 2), (2, 1), (1, 4)])
def test_loader_split_is_the_jax_host_batch_in_device_order(
        tree, engine, hosts, local):
    from t2igan.data import pipeline as jpipe
    from t2igan.data.tokenizer import ClipTokenizer as JTok
    from t2igan_torch.data import pipeline as tpipe
    from t2igan_torch.data.tokenizer import ClipTokenizer
    from test_torch_port_data import assert_images, datasets
    for h in range(hosts):
        # One worker: the JAX thread engine draws on its worker threads.
        jl = jpipe.DataLoader(datasets(tree)[0], JTok.fallback(), 4, 77,
                              num_workers=1, engine=engine, host_index=h,
                              host_count=hosts)
        want = [list(jl) for _ in range(2)]
        jl.close()
        for i in range(local):
            tl = tpipe.DataLoader(datasets(tree)[1], ClipTokenizer.load(), 4,
                                  77, num_workers=2, engine=engine,
                                  host_index=h, host_count=hosts,
                                  local_index=i, local_count=local)
            assert len(tl) == len(jl) == 16 // hosts // 4
            rows = slice(i * 4 // local, (i + 1) * 4 // local)
            for epoch in want:
                got = list(tl)
                assert len(got) == len(epoch)
                for jb, tb in zip(epoch, got):
                    assert tb.keys == jb.keys[rows]
                    assert_images([x[rows] for x in jb.images], tb.images)
                    for k in ("input_ids", "attention_mask", "input_ids_2",
                              "attention_mask_2", "class_ids"):
                        np.testing.assert_array_equal(getattr(jb, k)[rows],
                                                      getattr(tb, k))
            # Every local rank drew the whole host batch's plans.
            assert tl.dataset.rng.bit_generator.state == \
                jl.dataset.rng.bit_generator.state
            tl.close()


def test_one_host_split_stitches_into_todays_batches(tree):
    from t2igan_torch.data import pipeline as tpipe
    from t2igan_torch.data.tokenizer import ClipTokenizer
    from test_torch_port_data import assert_batches, datasets

    def loader(**kw):
        return tpipe.DataLoader(datasets(tree)[1], ClipTokenizer.load(), 4,
                                77, num_workers=2, **kw)

    whole = loader()
    parts = [loader(local_index=i, local_count=2) for i in range(2)]
    for _ in range(2):
        want = list(whole)
        got = [list(p) for p in parts]
        for w, a, b in zip(want, *got):
            stitched = tpipe.Batch(
                images=[np.concatenate([x, y]) for x, y in
                        zip(a.images, b.images)],
                keys=a.keys + b.keys, **{
                    k: np.concatenate([getattr(a, k), getattr(b, k)])
                    for k in ("input_ids", "attention_mask", "input_ids_2",
                              "attention_mask_2", "class_ids")})
            assert_batches(w, stitched)
            assert a.rng_state == b.rng_state == w.rng_state
    for i, p in enumerate(parts):
        assert p.peek().keys == whole.peek().keys[2 * i:2 * i + 2]
        assert p.peek(whole=True).keys == whole.peek().keys
    with pytest.raises(ValueError, match="does not split"):
        loader(local_index=0, local_count=3)


# ----------------------------------------------------------- BatchNorm --

@pytest.mark.parametrize("case", ["conv", "dense"])
def test_global_batch_norm_is_the_concatenated_batch(two, case):
    """[B, C, H, W] as in the stages, [B, F] as in ``InitStageG``."""
    want = workers.batch_norm(DataMesh.single("cpu"), **_bn_cases()[case])
    for ours in two[f"bn_{case}"]:
        assert ours.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(ours[k].numpy(),
                                       want[k].detach().numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


# -------------------------------------------------------------- GAN step --

def test_dp_gan_step_metrics_match_jax(two, jax_gan_step):
    _, ref = jax_gan_step
    for rank in two["gan"]:
        assert rank["metrics"].keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(rank["metrics"][k], float(ref[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("module", ["gen", "gen_ema", "d0", "d1"])
def test_dp_gan_step_state_matches_jax(two, jax_gan_step, module):
    after, _ = jax_gan_step
    want = {"gen": _port_gen(after.g_params, after.g_batch_stats),
            "gen_ema": _port_gen(after.g_ema_params, after.g_batch_stats)}
    for i, d in enumerate(_port_ds(after.d_params, after.d_spectral)):
        want[f"d{i}"] = d
    index = ["gen", "gen_ema", "d0", "d1"].index(module)
    params = {n for n, _ in want[module].named_parameters()}
    for rank in two["gan"]:
        # The EMA G keeps G's statistics (ROADMAP F15); JAX keeps one set.
        _assert_same_state(rank["first"][index], want[module].state_dict(),
                           buffers=module != "gen_ema", params=params)


def test_dp_gan_ranks_stay_bitwise_equal(two):
    """Parameters, EMA, spectral vectors and running statistics after 3
    steps; the metrics are the global values on both ranks."""
    r0, r1 = two["gan"]
    for a, b in zip(r0["last"], r1["last"]):
        _assert_bitwise(a, b, "state after 3 steps")
    assert r0["metrics"] == r1["metrics"]
    assert r0["launches"] == r1["launches"] == {}  # plain versions on CPU


def test_world_one_group_is_bitwise_the_plain_step(jax_vars, tmp_path):
    """A process group of one rank runs every collective of the step; the
    result equals the step without a group bit for bit."""
    v = jax_vars
    args = (TCFG, CLIP_CFG, v["sd"], v["batch"], v["noise"])
    plain = workers.gan_steps(DataMesh.single("cpu"), *args)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    try:
        mesh = init_distributed("cpu")
        assert mesh.distributed and mesh.world == 1
        grouped = workers.gan_steps(mesh, *args)
    finally:
        dist.destroy_process_group()
    assert plain["metrics"] == grouped["metrics"]
    for key in ("first", "last"):
        for a, b in zip(plain[key], grouped[key]):
            _assert_bitwise(a, b, key)


# ------------------------------------------------------------ DAMSM step --

@pytest.fixture(scope="module")
def jax_damsm(jax_vars, ranks):
    model, params = _jax_clip()
    batch = jax_vars["damsm_batch"]
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        jmake_damsm_loss(JCFG, model), has_aux=True))(
        jax.tree.map(jnp.asarray, params), batch)
    tx = jdamsm_optimizer(JCFG, STEPS_PER_EPOCH)
    state = jinit_damsm_state(JCFG, {"params": jax.tree.map(jnp.asarray,
                                                            params)}, tx)
    state, step_metrics = jax.jit(jmake_damsm_step(JCFG, model, tx))(
        state, batch)
    return dict(metrics=_np(metrics), grads=_np(grads), params=params,
                step_metrics=_np(step_metrics),
                after=_np(state.clip_params))


def test_dp_damsm_loss_and_gradients_match_jax(two, jax_damsm):
    want = dict(_port_clip(jax_damsm["grads"]).named_parameters())
    for rank in two["damsm"]:
        for k, ref in jax_damsm["metrics"].items():
            np.testing.assert_allclose(rank["metrics"][k], float(ref),
                                       err_msg=k, **TOL)
        for name, g in rank["grads"].items():
            w = want[name].detach().numpy()
            got = np.zeros_like(w) if g is None else g.numpy()
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)


def test_dp_damsm_step_matches_jax(two, jax_damsm):
    """The step's metrics (the global norm of the reduced gradients
    included) and the parameters after the update, at the bounds of
    ``test_torch_port_damsm.py``'s three-step test for one step."""
    r0, r1 = two["damsm"]
    ref = jax_damsm["step_metrics"]
    assert r0["step_metrics"].keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(r0["step_metrics"][k], float(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    want = dict(_port_clip(jax_damsm["after"]).named_parameters())
    was = dict(_port_clip(jax_damsm["params"]).named_parameters())
    total = STEPS_PER_EPOCH * LRS["MAX_EPOCH"]
    for name, got in r0["after"].items():
        group = "linear" if name.split(".")[0] == "linear_subr" \
            else "backbone"
        lr = cosine_onecycle(total, *GROUPS[group])(0)
        got, ref_p = got.numpy(), want[name].detach().numpy()
        start = was[name].detach().numpy()
        tol = 1e-2 * lr + 2 * F32_UNIT * np.abs(ref_p)
        if name.endswith("qkv_proj.bias"):
            k = slice(len(got) // 3, 2 * len(got) // 3)
            for x in (got[k], ref_p[k]):
                assert np.all(np.abs(x - start[k]) <= ADAM_MOVE * lr)
            tol[k] = np.inf
        assert np.all(np.abs(got - ref_p) <= tol), name
    _assert_bitwise(r0["after"], r1["after"], "CLIP after the step")
    assert r0["step_metrics"] == r1["step_metrics"]


# ------------------------------------------------------- trainers, sweep --

def test_dp_sweep_is_the_one_rank_sweep(two, tmp_path):
    one = workers.sweep(DataMesh.single("cpu"), SWEEP_CFG, CLIP_CFG,
                        str(tmp_path / "sweep1"))
    r0, r1 = two["sweep"]
    assert r0["r"] == r1["r"] == one["r"]
    assert 0.0 <= one["r"][0] <= 1.0
    assert len(one["pngs"]) == 64  # the synthetic test split, one round
    assert sorted(r0["pngs"]) == sorted(one["pngs"])
    for name, data in one["pngs"].items():
        # Within 1 count (the bound of test_torch_port_sampling.py): a
        # conv over 2 rows may round apart from one over 4.
        got, want = (np.asarray(Image.open(io.BytesIO(x)), np.int16)
                     for x in (r0["pngs"][name], data))
        assert np.abs(got - want).max() <= 1, name


def test_dp_resume_after_a_sigterm_to_one_rank_is_bitwise(two):
    for rank in two["resume"]:
        stopped = rank["stopped"]
        # Both ranks stopped after the same step and rank 0 wrote once.
        assert stopped["step"] == rank["resumed_at"] == STOP_AT
        assert stopped["epoch"] == 0
        assert stopped["files"] == [f"state_{STOP_AT:08d}.pt"]
        whole, resumed = rank["whole"], rank["resumed"]
        assert whole["step"] == resumed["step"] == EPOCH_STEPS
        for a, b in zip(whole["modules"], resumed["modules"]):
            _assert_bitwise(a, b, "resumed state")
        _assert_optimizers_bitwise(whole["opt"], resumed["opt"])
        assert torch.equal(whole["noise"], resumed["noise"])
        assert whole["data_rng"] == resumed["data_rng"]
        assert rank["files"] == sorted(
            ["netD0.pth", "netD1.pth", "netG_epoch_0.pth",
             f"state_{STOP_AT:08d}.pt", f"state_{EPOCH_STEPS:08d}.pt"])
    for a, b in zip(*(r["resumed"]["modules"] for r in two["resume"])):
        _assert_bitwise(a, b, "ranks")


def test_dp_damsm_trainer_validates_as_one_process(two, tmp_path):
    from t2igan_torch.train.pretrain_damsm import DamsmTrainer
    one = DamsmTrainer(DAMSM_CFG, str(tmp_path), "cpu", clip_cfg=CLIP_CFG,
                       words_num=16)
    want = one.evaluate()
    r0, r1 = two["damsm_trainer"]
    for k in want:
        np.testing.assert_allclose(r0["val"][k], want[k], rtol=1e-5,
                                   err_msg=k)
    assert r0["val"] == r1["val"] and r0["metrics"] == r1["metrics"]
    _assert_bitwise(r0["clip"], r1["clip"], "CLIP after an epoch")
    assert r0["files"] == ["clip0.pth", "state_00000008.pt"]


# ----------------------------------------------------- tensor parallel --

def _jax_leaves(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return flat


def test_clip_tp_spec_is_the_jax_spec_under_the_converter_names():
    """Every JAX leaf labelled with its own flat indices (unique over the
    tree) goes through the converter; each port parameter's labels name
    its JAX leaf, and the labels on model rank m of 2 under
    ``clip_tp_spec`` are those of ``_spec_for_path``'s shard m."""
    _, params = _jax_clip()
    leaves = _jax_leaves(params)
    offset, labelled, ranges = 0, [], []
    for path, leaf in leaves:
        n = int(np.size(leaf))
        labelled.append(np.arange(offset, offset + n, dtype=np.float32)
                        .reshape(np.shape(leaf)))
        ranges.append((offset, offset + n))
        offset += n
    assert offset < 2 ** 24  # exact in f32
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), labelled)
    port = load_jax_clip(build_clip(CLIP_CFG), tree)
    sharded = 0
    for name, p in port.named_parameters():
        first = float(p.detach().reshape(-1)[0])
        leaf_i = next(i for i, (a, b) in enumerate(ranges) if a <= first < b)
        path, leaf = leaves[leaf_i]
        lab = labelled[leaf_i]
        spec = _spec_for_path(path, lab, "model")
        ours = tp.clip_tp_spec(name)
        assert (ours is None) == ("model" not in tuple(spec)), name
        for m in range(2):
            got = tp.shard_tensor(name, p.detach(), m, 2)
            if ours is None:
                want = lab
            else:
                axis = tuple(spec).index("model")
                want = np.split(lab, 2, axis=axis)[m]
                sharded += 1
            assert sorted(got.reshape(-1).tolist()) == \
                sorted(want.reshape(-1).tolist()), (name, m)
    # qkv weight and bias, fc1 weight and bias, out_proj and fc2 weights,
    # over 2 layers of 2 towers, on both ranks.
    assert sharded == 6 * 4 * 2


@pytest.fixture(scope="module")
def four(ranks):
    return ranks["four"].result()


def test_tp_loss_matches_replicated_port_and_jax(four, jax_damsm, jax_vars):
    batch = jax_vars["damsm_batch"]
    clip = _port_clip(_jax_clip()[1]).requires_grad_(True)
    from t2igan_torch.train.steps import make_damsm_loss
    _, want = make_damsm_loss(PCFG, clip)(batch)
    for rank in four:
        for k in want:
            np.testing.assert_allclose(rank["metrics"][k], want[k].item(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(rank["metrics"][k],
                                       float(jax_damsm["metrics"][k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_tp_gradients_match_replicated_port(four, jax_vars):
    from t2igan_torch.train.steps import make_damsm_loss
    clip = _port_clip(_jax_clip()[1]).requires_grad_(True)
    total, _ = make_damsm_loss(PCFG, clip)(jax_vars["damsm_batch"])
    names = [n for n, _ in clip.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        total, list(clip.parameters()), allow_unused=True)))
    heads = {r["model_index"]: r for r in four}
    assert sorted(heads) == [0, 1]
    for rank in four:
        m = rank["model_index"]
        for name, g in grads.items():
            got = rank["grads"][name]
            if g is None:
                assert got is None, name
                continue
            want = tp.shard_tensor(name, g, m, 2)
            assert rank["shapes"][name] == tuple(want.shape), name
            scale = max(1.0, float(want.abs().max()))
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)
        qkv = "text_model.layers.0.self_attn.qkv_proj.weight"
        assert rank["shapes"][qkv] == (3 * 32 // 2, 32)


def test_tp_gathered_clip_is_the_whole_clip(four, ranks):
    """``clip%d.pth`` is written whole: ``save_clip_pth`` refuses a
    sharded module, and the gathered one's file reads back bitwise."""
    from t2igan_torch.models.convert import load_clip_pth
    want = _port_clip(_jax_clip()[1]).state_dict()
    for r, rank in enumerate(four):
        _assert_bitwise(rank["whole"], want, "gathered CLIP")
        assert rank["refused"]
        back = load_clip_pth(build_clip(CLIP_CFG),
                             str(ranks["root"] / f"whole_{r}.pth"))
        _assert_bitwise(back.state_dict(), want, "clip file")


# ------------------------------------------------ spawning, entry point --

def test_spawn_local_fails_for_a_rank_that_raises_or_hangs(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       r"(.|\n)*rank 1 gives up"):
        spawn_local(workers.fail_on_rank, 2, "gloo", "cpu",
                    str(tmp_path / "a"), 60, (1,), 1)
    with pytest.raises(RuntimeError, match="did not finish within 3 s"):
        spawn_local(workers.fail_on_rank, 1, "gloo", "cpu",
                    str(tmp_path / "b"), 3, (None,), 1)


def test_torchrun_drives_train_gan_over_two_gloo_ranks(ranks):
    out, _ = ranks["cli"].communicate(timeout=SPAWN_TIMEOUT)
    assert ranks["cli"].returncode == 0, out
    lines = [ln for ln in out.splitlines()
             if re.match(r"\[\d+\] Loss_D", ln)]
    # Rank 0 alone prints a line a step.
    assert [ln.split("]")[0] for ln in lines] == ["[1", "[2"], out
    for ln in lines:
        assert np.isfinite(float(ln.split("Loss_G: ")[1].split()[0]))
