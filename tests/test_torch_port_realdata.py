"""The port's trainers and CLIs on a CUB-shaped tree of decoded JPEGs, on
the CPU (``TINY_CLIP`` and ``CFG`` widths: two 2-layer towers, GF 8, DF 4,
two scales; 8 train and 8 test records over 4 classes, 3 captions each).

* ``CondGanTrainer`` trains from the tree's loader and resumes bitwise:
  two epochs straight against one epoch and a resume, and against a
  SIGTERM mid-epoch (after step 1 or 3 of 4) and a resume at the next
  batch, with the dataset generator's state carried in the full state.
* ``sampling()`` draws the JAX trainer's captions on the same tree without
  reading pixels, and its hits, (mean, std) and PNGs equal the JAX
  trainer's sweep (the JAX sweep's ``jax.random`` noise fed to the port).
* ``DamsmTrainer`` runs an epoch on the tree; ``python -m
  t2igan_torch.main`` and ``pretrain_damsm`` train on it.
"""

import dataclasses
import os
import signal

import jax
import numpy as np
import pytest
import torch

from test_torch_port_checkpoint import _assert_same_run
from test_torch_port_damsm import CLI_CLIP, TINY_YAML as DAMSM_YAML
from test_torch_port_data import jax_native, make_tree  # noqa: F401
from test_torch_port_sampling import (TINY_YAML as MAIN_YAML, _pngs,
                                      _recording)
from test_torch_port_train_modules import TCFG, port_clip_cfg
from test_train_steps import CFG, TINY_CLIP
from t2igan.config import cfg_replace as j_cfg_replace
from t2igan.train import train_gan as jtrain_gan
from t2igan_torch import config as tconfig
from t2igan_torch import main as tmain
from t2igan_torch.data.dataset import TextImageDataset
from t2igan_torch.models.convert import load_jax_clip, load_jax_generator
from t2igan_torch.train import pretrain_damsm
from t2igan_torch.train import train_gan as ttrain_gan
from t2igan_torch.train.pretrain_damsm import DamsmTrainer


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
def tree(tmp_path_factory, jax_native):
    return make_tree(tmp_path_factory.mktemp("cub"), n_train=8, n_test=8)


def gan_cfg(tree):
    return tconfig.cfg_replace(
        TCFG, DATA_DIR=tree, WORKERS=2, TEXT={"CAPTIONS_PER_IMAGE": 3},
        TRAIN={"CLIP_MODEL_CHECKPOINT": "", "MAX_EPOCH": 2,
               "SNAPSHOT_INTERVAL": 1})


def _trainer(tree, out):
    return ttrain_gan.CondGanTrainer(gan_cfg(tree), "cpu",
                                     clip_cfg=port_clip_cfg(TINY_CLIP),
                                     output_dir=str(out))


@pytest.fixture(scope="module")
def straight(tree, tmp_path_factory):
    """2 epochs on the tree without a stop, written under ``a/``."""
    out = tmp_path_factory.mktemp("straight") / "a"
    t = _trainer(tree, out)
    assert isinstance(t.dataset, TextImageDataset)
    assert t.loader.engine_in_use() == "native"
    seen = []
    step_fn = t.step_fn

    def recording(state, batch, **kwargs):
        seen.append([x.clone() for x in batch["images"]])
        return step_fn(state, batch, **kwargs)

    t.step_fn = recording
    t.train(2)
    t.step_fn = step_fn
    return t, out, seen


def test_gan_trains_on_the_decoded_tree(straight):
    """Each step got the loader's pyramids: CLIP-normalised decoded
    images at both scales, no two batches alike."""
    t, _, seen = straight
    assert t.state.step == 4 and len(seen) == 4
    for images in seen:
        assert [tuple(x.shape) for x in images] == [(4, 64, 64, 3),
                                                    (4, 128, 128, 3)]
        assert all(torch.isfinite(x).all() for x in images)
        assert -2.0 < float(images[1].min()) < float(images[1].max()) < 2.7
    assert not torch.equal(seen[0][1], seen[1][1])


def test_gan_resume_on_the_tree_is_bitwise(tree, tmp_path, straight):
    first = _trainer(tree, tmp_path / "b")
    first.train(1)
    resumed = _trainer(tree, tmp_path / "b")
    assert (resumed.epoch, resumed.state.step) == (1, 2)
    assert resumed.loader.epoch == 1
    assert resumed.dataset.rng.bit_generator.state == \
        first.dataset.rng.bit_generator.state
    resumed.train(2)
    _assert_same_run(straight[:2], resumed, tmp_path / "b")
    assert resumed.dataset.rng.bit_generator.state == \
        straight[0].dataset.rng.bit_generator.state


@pytest.mark.parametrize("stop_after", [1, 3])
def test_gan_stop_on_the_tree_resumes_at_the_next_batch(tree, tmp_path,
                                                        straight,
                                                        stop_after):
    """A SIGTERM mid-epoch, with batches of the epoch already drawn and
    in flight: the resumed run draws what the straight run drew."""
    first = _trainer(tree, tmp_path / "b")
    step_fn = first.step_fn

    def stopping(state, batch, **kwargs):
        out = step_fn(state, batch, **kwargs)
        if state.step == stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    first.step_fn = stopping
    first.train(2)
    assert first.state.step == stop_after
    resumed = _trainer(tree, tmp_path / "b")
    assert resumed.state.step == stop_after
    resumed.train(2)
    _assert_same_run(straight[:2], resumed, tmp_path / "b")


# ------------------------------------------------------------ sweep ----

@pytest.fixture(scope="module")
def sweeps(tree, tmp_path_factory):
    """One round of the JAX and the port sweep on the tree's test split:
    each (captions given to the rank fn, hits, (mean, std), PNGs)."""
    out = tmp_path_factory.mktemp("sweep")
    jcfg = j_cfg_replace(CFG, DATA_DIR=tree, WORKERS=1,
                         TEXT={"CAPTIONS_PER_IMAGE": 3},
                         TRAIN={"FLAG": False, "CLIP_MODEL_CHECKPOINT": ""})
    pcfg = tconfig.cfg_from_dict(dataclasses.asdict(jcfg))
    mp = pytest.MonkeyPatch()
    jt = jtrain_gan.CondGanTrainer(jcfg, str(out / "jax"), clip_cfg=TINY_CLIP,
                                   split="test")
    rng = np.random.default_rng(9)
    stats = jax.tree.map(
        lambda x: (np.asarray(x) + rng.uniform(0.0, 0.3, x.shape)).astype(
            np.float32), jt.state.g_batch_stats)
    jt.state = jt.state.replace(g_batch_stats=stats)
    pt = ttrain_gan.CondGanTrainer(pcfg, "cpu",
                                   clip_cfg=port_clip_cfg(TINY_CLIP),
                                   output_dir=str(out / "port"), split="test")
    load_jax_clip(pt.clip, jax.tree.map(np.asarray, jt.clip_params))
    load_jax_generator(pt.state.gen_ema, {
        "params": jax.tree.map(np.asarray, jt.state.g_ema_params),
        "batch_stats": stats})
    key = [jax.random.PRNGKey(100)]

    def jax_noise(b):
        key[0], rz, re = jax.random.split(key[0], 3)
        return (torch.from_numpy(np.array(jax.random.normal(
                    rz, (b, jcfg.GAN.Z_DIM)))),
                torch.from_numpy(np.array(jax.random.normal(
                    re, (b, jcfg.GAN.CONDITION_DIM)))))

    results = []
    for module, trainer, kwargs in (
            (jtrain_gan, jt, {"data_parallel": False}),
            (ttrain_gan, pt, {"noise": jax_noise})):
        captions = []

        def make_rank(*args, _make=module.make_rank_fn, **kw):
            rank = _make(*args, **kw)

            def run(images, ids, mask, *rest):
                captions.append(np.asarray(ids).copy())
                return rank(images, ids, mask, *rest)

            return run

        hits = []
        mp.setattr(module, "make_rank_fn", _recording(make_rank, hits))
        r = trainer.sampling("valid", num_rounds=1, n_mis=5, **kwargs)
        results.append((captions, hits, r, _pngs(os.path.join(
            trainer.output_dir, "valid", "single"))))
    mp.undo()
    return results, pt


def test_sweep_draws_the_jax_captions_on_the_tree(sweeps):
    (jcaps, jhits, jr, jpngs), (pcaps, phits, pr, ppngs) = sweeps[0]
    assert len(jcaps) == len(pcaps) == 2
    for a, b in zip(jcaps, pcaps):
        np.testing.assert_array_equal(a, b)
    assert len(jhits) == 8 and phits == jhits and pr == jr
    assert sorted(ppngs) == sorted(jpngs) and len(ppngs) == 8
    for name, want in jpngs.items():
        got = ppngs[name]
        assert got.shape == want.shape == (128, 128, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_sweep_reads_no_pixel(sweeps, monkeypatch):
    """The sweep's captions come from the plans alone: no image is
    decoded."""
    _, pt = sweeps
    from t2igan_torch.data import native

    def refuse(*a, **k):
        raise AssertionError("the sweep decoded an image")

    monkeypatch.setattr(native, "load_sample", refuse)
    monkeypatch.setattr(native.AsyncExecutor, "submit", refuse)
    mean, std = pt.sampling("valid_again", num_rounds=1, save_images=False,
                            n_mis=3)
    assert 0.0 <= mean <= 1.0


# ------------------------------------------------------------ DAMSM ----

def damsm_cfg(tree, tmp_path):
    path = tmp_path / "damsm.yml"
    path.write_text(DAMSM_YAML.replace("DATA_DIR: ''",
                                       f"DATA_DIR: '{tree}'"))
    return tconfig.cfg_replace(tconfig.cfg_from_file(str(path)),
                               TEXT={"CAPTIONS_PER_IMAGE": 3},
                               TRAIN={"BATCH_SIZE": 4})


def test_damsm_trainer_runs_an_epoch_on_the_tree(tree, tmp_path, capsys):
    t = DamsmTrainer(damsm_cfg(tree, tmp_path), str(tmp_path / "out"), "cpu",
                     clip_cfg=CLI_CLIP)
    assert isinstance(t.train_batches.dataset, TextImageDataset)
    assert len(t.train_batches) == 2
    shapes = []
    step_fn = t.step_fn

    def recording(batch):
        shapes.append(tuple(batch["images"].shape))
        return step_fn(batch)

    t.step_fn = recording
    metrics = t.train(1)
    assert shapes == [(4, 32, 32, 3)] * 2 and t.state.step == 2
    assert all(np.isfinite(v) for v in metrics.values())
    assert "valid s_loss" in capsys.readouterr().out


def test_entry_points_train_on_the_tree(tree, tmp_path, capsys):
    """``python -m t2igan_torch.main`` and ``pretrain_damsm`` with
    ``DATA_DIR`` at the tree read its images (no synthetic warning for
    the train split)."""
    yml = tmp_path / "gan.yml"
    yml.write_text(MAIN_YAML.format(data=tree, val=False, flag=True,
                                    net_g="").replace(
        "BATCH_SIZE: 32", "BATCH_SIZE: 4").replace(
        "TEXT: {EMBEDDING_DIM: 32,", "TEXT: {CAPTIONS_PER_IMAGE: 3, "
                                     "EMBEDDING_DIM: 32,"))
    trainer = tmain.main(["--cfg", str(yml), "--manualSeed", "1",
                          "--output_dir", str(tmp_path / "gan"),
                          "--device", "cpu"],
                         clip_cfg=port_clip_cfg(TINY_CLIP))
    assert isinstance(trainer.dataset, TextImageDataset)
    assert trainer.state.step == 2
    out = capsys.readouterr().out
    assert "using synthetic data" not in out
    damsm = tmp_path / "damsm.yml"
    damsm.write_text(DAMSM_YAML.replace("DATA_DIR: ''", f"DATA_DIR: '{tree}'")
                     .replace("TREE:", "TEXT: {CAPTIONS_PER_IMAGE: 3}\nTREE:"))
    t = pretrain_damsm.main(["--cfg", str(damsm), "--max_epochs", "1",
                             "--batch", "4", "--device", "cpu",
                             "--output_dir", str(tmp_path / "damsm")],
                            clip_cfg=CLI_CLIP)
    assert isinstance(t.train_batches.dataset, TextImageDataset)
    assert t.state.step == 2
    assert sorted(os.listdir(tmp_path / "damsm" / "Model")) == [
        "clip0.pth", "state_00000002.pt"]
