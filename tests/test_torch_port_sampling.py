"""The port's evaluation entry points against the JAX package's, on the
CPU: ``CondGanTrainer.sampling()`` (the generation + R-precision sweep),
``gen_example``, ``python -m t2igan_torch.main`` in its three modes, and
``generate --weights``.

The sweep runs both packages' trainers at ``TINY_CLIP`` and ``CFG`` widths
(two 2-layer towers, GF 8, DF 4, two scales) on the same synthetic split
(cut to 3 batches of 4) for one round, with the JAX trainer's weights
(its batch statistics moved off 0 and 1) bridged into the port and the JAX
sweep's ``jax.random`` draws fed to the port through its ``noise`` seam.
The hit lists and (mean, std) must be equal, the same PNG names written,
and the uint8 pixels within 1 count (the images agree to 1e-4, and the
truncation to uint8 can fall on either side of a boundary).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_train_modules import TCFG, port_clip_cfg
from test_train_steps import CFG, TINY_CLIP
from t2igan.config import cfg_replace as j_cfg_replace
from t2igan.train import train_gan as jtrain_gan
from t2igan_torch import config as tconfig
from t2igan_torch import generate as tgenerate
from t2igan_torch import main as tmain
from t2igan_torch.models.convert import (load_jax_clip, load_jax_generator,
                                         save_generator_pth)
from t2igan_torch.models.factory import build_generator
from t2igan_torch.models.generator import BatchNorm, init_generator_
from t2igan_torch.ops.image import uint8_from_tanh
from t2igan_torch.train import train_gan as ttrain_gan
from t2igan_torch.train.export import load_generator_weights
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


JCFG = j_cfg_replace(CFG, DATA_DIR="", WORKERS=1,
                     TRAIN={"FLAG": False, "CLIP_MODEL_CHECKPOINT": ""})
PCFG = tconfig.cfg_from_dict(dataclasses.asdict(JCFG))
RECORDS = 12


def _shrink(dataset):
    dataset.n = RECORDS
    dataset.class_id = dataset.class_id[:RECORDS]


def _recording(make_rank_fn, hits):
    def make(*args, **kwargs):
        rank = make_rank_fn(*args, **kwargs)

        def run(*a):
            out = rank(*a)
            flags = out[0] if isinstance(out, tuple) else out
            hits.extend(np.asarray(flags).tolist())
            return out

        return run

    return make


def _pngs(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = np.asarray(Image.open(path))
    return out


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """One round of both sweeps: (JAX, port) each as (hits, (mean, std),
    PNGs by name), and both trainers."""
    out = tmp_path_factory.mktemp("sweep")
    mp = pytest.MonkeyPatch()
    jt = jtrain_gan.CondGanTrainer(JCFG, str(out / "jax"), clip_cfg=TINY_CLIP,
                                   split="test")
    _shrink(jt.dataset)
    rng = np.random.default_rng(9)
    stats = jax.tree.map(
        lambda x: (np.asarray(x) + rng.uniform(0.0, 0.3, x.shape)).astype(
            np.float32), jt.state.g_batch_stats)
    jt.state = jt.state.replace(g_batch_stats=stats)
    pt = ttrain_gan.CondGanTrainer(PCFG, "cpu",
                                   clip_cfg=port_clip_cfg(TINY_CLIP),
                                   output_dir=str(out / "port"), split="test")
    _shrink(pt.dataset)
    load_jax_clip(pt.clip, jax.tree.map(np.asarray, jt.clip_params))
    load_jax_generator(pt.state.gen_ema, {
        "params": jax.tree.map(np.asarray, jt.state.g_ema_params),
        "batch_stats": stats})

    key = [jax.random.PRNGKey(100)]

    def jax_noise(b):
        """The JAX sweep's draws for one batch."""
        key[0], rz, re = jax.random.split(key[0], 3)
        return (torch.from_numpy(np.array(jax.random.normal(
                    rz, (b, JCFG.GAN.Z_DIM)))),
                torch.from_numpy(np.array(jax.random.normal(
                    re, (b, JCFG.GAN.CONDITION_DIM)))))

    results = []
    for module, trainer, kwargs in (
            (jtrain_gan, jt, {"data_parallel": False}),
            (ttrain_gan, pt, {"noise": jax_noise})):
        hits = []
        mp.setattr(module, "make_rank_fn",
                   _recording(module.make_rank_fn, hits))
        r = trainer.sampling("valid", num_rounds=1, n_mis=7, **kwargs)
        results.append((hits, r, _pngs(os.path.join(trainer.output_dir,
                                                     "valid", "single"))))
    mp.undo()
    return results, jt, pt


def test_sampling_sweep_matches_jax(sweeps):
    (jhits, jr, jpngs), (phits, pr, ppngs) = sweeps[0]
    assert len(jhits) == RECORDS and phits == jhits
    assert pr == jr
    assert sorted(ppngs) == sorted(jpngs) and len(ppngs) == RECORDS
    assert "synthetic/000000_0.png" in ppngs
    for name, want in jpngs.items():
        got = ppngs[name]
        assert got.shape == want.shape == (128, 128, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_sampling_stops_at_the_target(sweeps, capsys):
    _, _, pt = sweeps
    mean, std = pt.sampling("valid_stop", num_rounds=5, r_target=8,
                            save_images=False, n_mis=3)
    assert 0.0 <= mean <= 1.0 and std >= 0.0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        f"R mean:{mean:.4f} std:{std:.4f}"
    assert not os.path.exists(os.path.join(pt.output_dir, "valid_stop"))


def test_snapshot_figures_match_jax(sweeps):
    """The sample sheet ``Image/G_<tag>.png`` and its attention figure
    ``G_<tag>_attn.png`` of both trainers on the same weights, probe batch
    and ``z`` (the JAX trainer's draw): the same size and labels, each
    uint8 within 1 count (the images and maps agree to 1e-4; truncation
    can fall either side of a boundary) at under 0.5% of the entries."""
    _, jt, pt = sweeps
    jt._save_sample_grid(9)
    n = len(pt.loader.peek(with_images=False).keys)
    pt._save_sample_grid(9, z=torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, JCFG.GAN.Z_DIM)))))
    for name in ("G_9.png", "G_9_attn.png"):
        want = np.asarray(Image.open(os.path.join(jt.output_dir, "Image",
                                                  name)))
        got = np.asarray(Image.open(os.path.join(pt.output_dir, "Image",
                                                 name)))
        assert got.shape == want.shape, name
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.005, name
    assert got.shape == (4 * 110, 9 * 96, 3)


def test_gen_example_writes_the_jax_file_names(sweeps):
    _, jt, pt = sweeps
    captions = {"demo": ["a bird with red wings", "a small blue bird"]}
    jt.gen_example(captions, n_samples=2)
    pt.gen_example(captions, n_samples=2)
    jnames = set(os.listdir(os.path.join(jt.output_dir, "demo")))
    pnames = set(os.listdir(os.path.join(pt.output_dir, "demo")))
    assert pnames == jnames and len(pnames) == 10
    assert {"0_a0.png", "1_a0.png"} <= pnames
    img = np.asarray(Image.open(os.path.join(pt.output_dir, "demo",
                                             "1_s_1_g1.png")))
    assert img.shape == (128, 128, 3)


# ------------------------------------------------ python -m .main ----

TINY_YAML = """\
CONFIG_NAME: 'DMGAN'
DATA_DIR: '{data}'
TREE: {{BASE_SIZE: 64, BRANCH_NUM: 2}}
GAN: {{GF_DIM: 8, DF_DIM: 4, Z_DIM: 16, CONDITION_DIM: 16, R_NUM: 1}}
TEXT: {{EMBEDDING_DIM: 32, WORDS_NUM: 16}}
B_VALIDATION: {val}
TRAIN: {{FLAG: {flag}, BATCH_SIZE: 32, MAX_EPOCH: 1, SNAPSHOT_INTERVAL: 1,
         CLIP_MODEL_CHECKPOINT: '', NET_G: '{net_g}'}}
"""


def _yaml(tmp_path, name, data="", val=False, flag=False, net_g=""):
    path = tmp_path / name
    path.write_text(TINY_YAML.format(data=data, val=val, flag=flag,
                                     net_g=net_g))
    return str(path)


def test_main_runs_train_sampling_and_examples_on_cpu(tmp_path, capsys,
                                                      monkeypatch):
    clip_cfg = port_clip_cfg(TINY_CLIP)
    out = tmp_path / "train"
    trainer = tmain.main(["--cfg", _yaml(tmp_path, "t.yml", flag=True),
                          "--manualSeed", "3", "--output_dir", str(out),
                          "--device", "cpu"], clip_cfg=clip_cfg)
    log = capsys.readouterr().out
    assert "Seed: 3" in log and "[0/1] Loss_D:" in log
    assert trainer.state.step == 2  # 64 records, batch 32
    assert sorted(os.listdir(out / "Model")) == [
        "netD0.pth", "netD1.pth", "netG_epoch_0.pth", "state_00000002.pt"]
    assert sorted(os.listdir(out / "Image")) == ["G_0.png", "G_0_attn.png"]

    # B_VALIDATION: the sweep from the trained netG_epoch_0.pth (one round
    # of few mis-captions, to keep the test short).
    calls = []
    sampling = ttrain_gan.CondGanTrainer.sampling

    def short(self, split_dir="valid", **kwargs):
        calls.append(split_dir)
        return sampling(self, split_dir, num_rounds=1, n_mis=3)

    monkeypatch.setattr(ttrain_gan.CondGanTrainer, "sampling", short)
    net_g = str(out / "Model" / "netG_epoch_0.pth")
    val = tmp_path / "val"
    trainer = tmain.main(["--cfg", _yaml(tmp_path, "v.yml", val=True,
                                         net_g=net_g),
                          "--output_dir", str(val), "--device", "cpu"],
                         clip_cfg=clip_cfg)
    log = capsys.readouterr().out
    assert calls == ["valid"] and "Seed: 100" in log
    assert f"Loaded generator weights: {net_g}" in log
    assert "R mean:" in log
    assert len(os.listdir(val / "valid" / "single" / "synthetic")) == 64
    want = load_generator_weights(build_generator(
        trainer.cfg), net_g)
    for a, b in zip(want.state_dict().values(),
                    trainer.state.gen_ema.state_dict().values()):
        assert torch.equal(a, b)

    # Neither: gen_example over example_filenames.txt.
    data = tmp_path / "data"
    (data / "text").mkdir(parents=True)
    (data / "example_filenames.txt").write_text("text/one\ntext/two\n")
    (data / "text" / "one.txt").write_text("a red bird\na blue bird\n")
    (data / "text" / "two.txt").write_text("a yellow bird\n")
    assert tmain.load_example_captions(str(data)) == {
        "one": ["a red bird", "a blue bird"], "two": ["a yellow bird"]}
    ex = tmp_path / "ex"
    tmain.main(["--cfg", _yaml(tmp_path, "e.yml", data=str(data)),
                "--output_dir", str(ex), "--device", "cpu"],
               clip_cfg=clip_cfg)
    assert sorted(os.listdir(ex / "one")) == [
        "0_a0.png", "0_s_0_g0.png", "0_s_0_g1.png", "0_s_1_g0.png",
        "0_s_1_g1.png"]
    assert sorted(os.listdir(ex / "two")) == ["0_a0.png", "0_s_0_g0.png",
                                              "0_s_0_g1.png"]


def test_main_and_generate_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--cfg", _yaml(tmp_path, "t.yml", flag=True),
                    "--output_dir", str(tmp_path / "o")],
                   clip_cfg=port_clip_cfg(TINY_CLIP))
    path = tmp_path / "netG_epoch_0.pth"
    save_generator_pth(init_generator_(build_generator(TCFG),
                                       torch.Generator().manual_seed(0)),
                       str(path))
    captions = tmp_path / "captions.txt"
    captions.write_text("a red bird\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgenerate.main(["--cfg", _yaml(tmp_path, "g.yml"), "--captions",
                        str(captions), "--weights", str(path)])


@pytest.mark.parametrize("kind", ["pth", "npz", "net_g"])
def test_generate_reads_the_weights_file(tmp_path, capsys, kind):
    """``--weights`` (or ``TRAIN.NET_G``) puts the file's generator behind
    the sampler; without either the weights are the seeded ones."""
    from t2igan_torch.train.export import save_generator_npz

    cfg = tconfig.cfg_replace(TCFG, TRAIN={"CLIP_MODEL_CHECKPOINT": ""})
    clip_cfg = port_clip_cfg(TINY_CLIP)
    gen = init_generator_(build_generator(cfg),
                          torch.Generator().manual_seed(5))
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, BatchNorm):
                m.running_var.fill_(0.7)
    if kind == "npz":
        path = save_generator_npz(str(tmp_path / "G"), gen)
    else:
        path = str(tmp_path / "netG_epoch_2.pth")
        save_generator_pth(gen, path)
    weights = path if kind != "net_g" else None
    if kind == "net_g":
        cfg = tconfig.cfg_replace(cfg, TRAIN={"NET_G": path})
    out = tgenerate.generate(cfg, ["a red bird"], None, 1, device="cpu",
                             clip_cfg=clip_cfg, weights=weights)[0]
    assert f"generator weights: {path}" in capsys.readouterr().out
    clip, _ = tgenerate.build_models(cfg, 0, torch.device("cpu"),
                                     torch.float32, clip_cfg)
    tok = ttrain_gan.ClipTokenizer.load()(["a red bird"], max_length=16)
    noise = torch.Generator().manual_seed(1)
    z = torch.randn((1, cfg.GAN.Z_DIM), generator=noise)
    eps = torch.randn((1, cfg.GAN.CONDITION_DIM), generator=noise)
    want = make_sampler(cfg, clip, gen.to(memory_format=torch.channels_last))(
        tok["input_ids"], tok["attention_mask"], z, eps)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert uint8_from_tanh(out[-1]).shape == (1, 128, 128, 3)
    seeded = tgenerate.generate(tconfig.cfg_replace(cfg, TRAIN={"NET_G": ""}),
                                ["a red bird"], None, 1, device="cpu",
                                clip_cfg=clip_cfg)[0]
    assert "random, from seed 0" in capsys.readouterr().out
    assert not torch.equal(seeded[-1], out[-1])


def test_trainer_samples_in_bf16_from_refreshed_copies():
    """In bf16 the sweep's G is a copy refilled from the EMA at every call
    (``load_state_dict``, in place): a change to the EMA reaches it."""
    cfg = tconfig.cfg_replace(PCFG, TRAIN={"BATCH_SIZE": 2})
    t = ttrain_gan.CondGanTrainer(cfg, "cpu", torch.bfloat16,
                                  clip_cfg=port_clip_cfg(TINY_CLIP))
    clip, gen = t.eval_models()
    assert gen.ca_net.fc.weight.dtype == torch.bfloat16
    ptr = gen.ca_net.fc.weight.data_ptr()
    with torch.no_grad():
        t.state.gen_ema.ca_net.fc.weight.mul_(2.0)
    clip2, gen2 = t.eval_models()
    assert clip2 is clip and gen2 is gen
    assert gen.ca_net.fc.weight.data_ptr() == ptr
    assert torch.equal(gen.ca_net.fc.weight,
                       t.state.gen_ema.ca_net.fc.weight.to(torch.bfloat16))
