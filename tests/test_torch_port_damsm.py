"""The port's DAMSM slice against the JAX package's, on the CPU.

At the widths of ``tests/test_train_steps.py`` (``TINY_CLIP``, ``CFG``)
the JAX CLIP is initialised and its variables cross to the port through
the loaders; inputs are numpy arrays from a seed.  Compared here:

* ``strip_special_tokens``, exactly (it is a gather);
* the one-cycle schedule against optax's at every step, within
  ``4 * 2**-24 * peak``: optax evaluates its cosine in f32 (the port in
  float64), which at the start of the linear group's warm-up cancels
  ``20 - 19.98`` and is 4.6e-7 off 0.02;
* the global-norm clip against ``optax.clip_by_global_norm`` on both sides
  of its trigger, 1e-6 relative (f32 rounding of the norm's sum);
* the two-group optimizer against the optax chain over 3 steps of the same
  gradients: parameters, mu, nu and count.  Adam's own arithmetic agrees
  to f32 rounding (1e-6 relative); the learning rates differ by optax's
  f32 evaluation, so each parameter may also differ by the 3 steps' lr
  differences times an Adam direction, which is at most 1.0025 in size in
  the first 3 steps (Cauchy-Schwarz over the bias-corrected averages at
  b1 0.9, b2 0.98): ``atol = 3 * 1.01 * 4 * 2**-24 * peak`` per group;
* the DAMSM loss's metrics and its gradients (``jax.grad``, before the
  clip) at 1e-4: the JAX package's own bound for its CLIP;
* 3 steps with the real optimizer: metrics at 1e-4 relative; each
  parameter within 1e-2 of ``S``, its group's 3 learning rates summed (the
  farthest Adam moves a parameter), plus 2 f32 units of its value.  Adam
  divides a gradient by its own size, so an entry's step carries that
  entry's relative gradient error, which is large where the gradient is
  small against its tensor's largest; 1e-2 is 4x the worst seen at this
  seed (2.3e-3 of S, in a vision MLP weight).  The key projections'
  biases have an exactly zero gradient (softmax ignores a shift shared by
  all keys), so Adam steps on rounding noise there: they are held only to
  Adam's largest move, 1.01 S;
* the ``clip%d.pth`` files: the trainer writes them, the JAX converter
  reads them, and both packages' encodings agree within 1e-5 of each
  tensor's largest magnitude (after 16 steps at LINEAR_LR 20 the regions
  reach ~2e3, and f32 sums of that size cancel to a few 1e-4).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_train_steps import CFG, TINY_CLIP, _caption_batch
from test_torch_port_train_modules import TCFG, port_clip_cfg
from t2igan import losses as jl
from t2igan.config import cfg_replace as jcfg_replace
from t2igan.models import clip as jclip
from t2igan.models.clip import convert_torch_clip_state
from t2igan.train.state import damsm_optimizer as jdamsm_optimizer
from t2igan.train.state import init_damsm_state as jinit_damsm_state
from t2igan.train.steps import make_damsm_loss as jmake_damsm_loss
from t2igan.train.steps import make_damsm_step as jmake_damsm_step
from t2igan_torch import config as tconfig
from t2igan_torch import losses as tl
from t2igan_torch.models.clip import init_clip_
from t2igan_torch.models.convert import (clip_reference_state_dict,
                                         load_clip_pth, load_jax_clip,
                                         load_reference_clip_state,
                                         save_clip_pth)
from t2igan_torch.models.factory import build_clip, build_generator
from t2igan_torch.models.generator import init_generator_
from t2igan_torch.train import pretrain_damsm
from t2igan_torch.train.pretrain_damsm import DamsmTrainer
from t2igan_torch.train.schedule import cosine_onecycle
from t2igan_torch.train.state import (clip_by_global_norm_, damsm_optimizer,
                                      init_damsm_state)
from t2igan_torch.train.steps import make_damsm_loss, make_damsm_step
from t2igan_torch.train.train_gan import CondGanTrainer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32_UNIT = 2.0 ** -24
ADAM_MOVE = 1.01  # bound on |Adam direction| over the first 3 steps
TOL = dict(rtol=1e-4, atol=1e-4)
# bird.yml's learning rates; 10 steps an epoch over 5 epochs puts the
# backbone's warm-up end at step 1 and the linear group's at step 5.
LRS = {"BACKBONE_LR": 2e-5, "LINEAR_LR": 20.0, "MAX_EPOCH": 5}
STEPS_PER_EPOCH = 10
JCFG = jcfg_replace(CFG, TRAIN=dict(LRS, CLIP_MODEL_CHECKPOINT=""))
PCFG = tconfig.cfg_replace(TCFG, TRAIN=dict(LRS, CLIP_MODEL_CHECKPOINT=""))
PEAKS = {"backbone": LRS["BACKBONE_LR"], "linear": LRS["LINEAR_LR"]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------- strip_special_tokens ----

@pytest.mark.parametrize("lengths", [(2, 2, 2), (5, 3, 9), (16, 16, 16),
                                     (2, 7, 16)],
                         ids=["empty", "short", "full", "mixed"])
def test_strip_special_tokens_matches_jax(rng, lengths):
    b, l, d = len(lengths), 16, 8
    words = rng.standard_normal((b, l, d)).astype(np.float32)
    mask = np.zeros((b, l), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    w, m = tl.strip_special_tokens(torch.from_numpy(words),
                                   torch.from_numpy(mask))
    jw, jm = jl.strip_special_tokens(jnp.asarray(words), jnp.asarray(mask))
    assert w.shape == (b, l - 2, d) and m.dtype == torch.bool
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert m.sum(-1).tolist() == [n - 2 for n in lengths]


# ------------------------------------------------------------ schedule ----

GROUPS = {"backbone": (2e-5, 0.02, 25.0, 1e4),
          "linear": (20.0, 0.1, 1e3, 1e6)}


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("total", [1, 7, 50, 200])
def test_cosine_onecycle_matches_optax(total, group):
    peak, pct, div, final_div = GROUPS[group]
    ours = cosine_onecycle(total, peak, pct, div, final_div)
    ref = optax.cosine_onecycle_schedule(total, peak, pct, div, final_div)
    if int(pct * total) == 0:
        # optax gives NaN at every step when the warm-up is empty; its
        # piecewise schedule without that empty segment is the reference.
        with np.errstate(invalid="ignore", divide="ignore"):
            assert np.isnan(float(ref(0)))
        ref = optax.piecewise_interpolate_schedule(
            "cosine", peak, {total: 1.0 / (div * final_div)})
    got = np.array([ours(i) for i in range(total + 4)])
    want = np.array([float(ref(i)) for i in range(total + 4)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * F32_UNIT * peak)
    assert got[0] == pytest.approx(peak / div if int(pct * total) else peak)
    assert got[-1] == pytest.approx(peak / (div * final_div), rel=1e-12)
    assert np.isclose(got.max(), peak, rtol=1e-12)


def test_cosine_onecycle_rejects_bad_counts():
    with pytest.raises(ValueError):
        cosine_onecycle(0, 1.0)
    with pytest.raises(ValueError):
        cosine_onecycle(10, 1.0)(-1)


# ---------------------------------------------------------------- clip ----

@pytest.mark.parametrize("max_norm", [0.25, 100.0],
                         ids=["clipped", "kept"])
def test_clip_by_global_norm_matches_optax(rng, max_norm):
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), ())]
    ts = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(ts, max_norm)
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    assert (float(norm) < max_norm) == (max_norm == 100.0)
    np.testing.assert_allclose(float(norm),
                               float(optax.global_norm(grads)), rtol=1e-6)
    for t, r, g in zip(ts, ref, grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
        if max_norm == 100.0:
            np.testing.assert_array_equal(t.numpy(), g)


# ----------------------------------------------------------- optimizer ----

class _Tree(nn.Module):
    """backbone/{kernel, bias}, linear_subr/{kernel, bias} and
    logit_scale, named and shaped as the JAX tree."""

    def __init__(self, tree):
        super().__init__()
        for name in ("backbone", "linear_subr"):
            setattr(self, name, nn.ParameterDict(
                {k: nn.Parameter(torch.tensor(v))
                 for k, v in tree[name].items()}))
        self.logit_scale = nn.Parameter(torch.tensor(tree["logit_scale"]))


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


def test_damsm_optimizer_matches_the_optax_chain(rng):
    tree = {"backbone": {"kernel": rng.standard_normal((3, 4)),
                         "bias": rng.standard_normal(4)},
            "linear_subr": {"kernel": rng.standard_normal((4, 2)),
                            "bias": rng.standard_normal(2)},
            "logit_scale": np.asarray(2.6)}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    module = _Tree(tree)
    opt = damsm_optimizer(PCFG, STEPS_PER_EPOCH)(module)
    assert [len(g["params"]) for g in opt.adam.param_groups] == [3, 2]
    tx = jdamsm_optimizer(JCFG, STEPS_PER_EPOCH)
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    # Global norms ~0.03 (kept), then ~3 and ~30 (clipped at 0.25).
    for scale in (0.01, 1.0, 10.0):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                         .astype(np.float32), tree)
        g["logit_scale"] = np.zeros((), np.float32)  # the loss ignores it
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in module.named_parameters():
            p.grad = (None if name == "logit_scale"
                      else torch.from_numpy(_leaf(g, name).copy()))
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
    assert opt.count == 3
    for label in ("backbone", "linear"):
        adam, sched = state[1].inner_states[label].inner_state
        assert int(adam.count) == int(sched.count) == opt.count
        atol = 3 * ADAM_MOVE * 4 * F32_UNIT * PEAKS[label]
        for name, p in module.named_parameters():
            if (name.split(".")[0] == "linear_subr") != (label == "linear"):
                continue
            st = opt.adam.state[p]
            assert int(st["step"]) == 3
            np.testing.assert_allclose(p.detach().numpy(), _leaf(jp, name),
                                       rtol=1e-6, atol=atol, err_msg=name)
            np.testing.assert_allclose(st["exp_avg"].numpy(),
                                       _leaf(adam.mu, name), rtol=1e-6,
                                       atol=1e-9, err_msg=name)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       _leaf(adam.nu, name), rtol=1e-6,
                                       atol=1e-12, err_msg=name)
    assert module.logit_scale.item() == np.float32(2.6)
    lrs = {g["name"]: g["lr"] for g in opt.adam.param_groups}
    total = STEPS_PER_EPOCH * LRS["MAX_EPOCH"]
    assert lrs == {"backbone": cosine_onecycle(total, 2e-5, 0.02, 25.0,
                                               1e4)(2),
                   "linear": cosine_onecycle(total, 20.0, 0.1, 1e3, 1e6)(2)}


# ----------------------------------------------------- loss and steps ----

def _damsm_batch(rng, b=6):
    ids, mask = _caption_batch(rng, b, 16)
    ids2, mask2 = _caption_batch(rng, b, 16)
    return {"images": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            "ids": ids, "mask": mask, "ids_2": ids2, "mask_2": mask2,
            # 3 classes over 6 images: same-class pairs are masked.
            "class_ids": np.asarray([0, 1, 2, 0, 1, 1], np.int32)[:b]}


@functools.lru_cache(maxsize=None)
def _jax_clip():
    model = jclip.ClipWithRegionHead(TINY_CLIP)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    return model, _np(variables["params"])


def _port_clip(params):
    return load_jax_clip(build_clip(port_clip_cfg(TINY_CLIP)), params)


def test_damsm_loss_and_gradients_match_jax():
    model, params = _jax_clip()
    batch = _damsm_batch(np.random.default_rng(3))
    loss_fn = jmake_damsm_loss(JCFG, model)
    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), batch)
    clip = _port_clip(params).requires_grad_(True)
    total, metrics = make_damsm_loss(PCFG, clip)(batch)
    assert metrics.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(metrics[k].item(), float(ref[k]),
                                   err_msg=k, **TOL)
    names = [n for n, _ in clip.named_parameters()]
    ours = torch.autograd.grad(total, list(clip.parameters()),
                               allow_unused=True)
    want = dict(_port_clip(_np(grads)).named_parameters())
    for name, g in zip(names, ours):
        w = want[name].detach().numpy()
        got = np.zeros_like(w) if g is None else g.numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    assert ours[names.index("logit_scale")] is None
    assert not np.any(want["logit_scale"].detach().numpy())


@pytest.fixture(scope="module")
def three_steps():
    """3 steps of both packages' DAMSM step with the real optimizer from
    the same weights and batches: (port state, port metrics, JAX params,
    JAX metrics)."""
    model, params = _jax_clip()
    rng = np.random.default_rng(5)
    batches = [_damsm_batch(rng) for _ in range(3)]
    tx = jdamsm_optimizer(JCFG, STEPS_PER_EPOCH)
    state = jinit_damsm_state(JCFG, {"params": jax.tree.map(jnp.asarray,
                                                            params)}, tx)
    step = jax.jit(jmake_damsm_step(JCFG, model, tx))
    jmetrics = []
    for batch in batches:
        state, m = step(state, batch)
        jmetrics.append(_np(m))
    pstate = init_damsm_state(PCFG, _port_clip(params),
                              damsm_optimizer(PCFG, STEPS_PER_EPOCH))
    pstep = make_damsm_step(PCFG, pstate.clip, pstate.opt)
    pmetrics = [{k: float(v) for k, v in pstep(b).items()} for b in batches]
    return pstate, pmetrics, _np(state.clip_params), jmetrics, params


def test_three_damsm_steps_metrics(three_steps):
    _, pmetrics, _, jmetrics, _ = three_steps
    for ours, ref in zip(pmetrics, jmetrics):
        assert ours.keys() == ref.keys()
        assert ours["grad_norm"] > 0.25  # the clip fires at random init
        for k in ref:
            np.testing.assert_allclose(ours[k], float(ref[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("label", ["backbone", "linear"])
def test_three_damsm_steps_parameters(three_steps, label):
    pstate, _, jparams, _, before = three_steps
    assert pstate.step == 3
    total = STEPS_PER_EPOCH * LRS["MAX_EPOCH"]
    peak, pct, div, final_div = GROUPS[label]
    sched = cosine_onecycle(total, peak, pct, div, final_div)
    lr_sum = sum(sched(i) for i in range(3))
    want = dict(_port_clip(jparams).named_parameters())
    was = dict(_port_clip(before).named_parameters())
    moved = 0
    for name, p in pstate.clip.named_parameters():
        if (name.split(".")[0] == "linear_subr") != (label == "linear"):
            continue
        got = p.detach().numpy()
        ref = want[name].detach().numpy()
        start = was[name].detach().numpy()
        tol = 1e-2 * lr_sum + 2 * F32_UNIT * np.abs(ref)
        if name.endswith("qkv_proj.bias"):
            k = slice(len(got) // 3, 2 * len(got) // 3)
            for x in (got[k], ref[k]):
                assert np.all(np.abs(x - start[k]) <= ADAM_MOVE * lr_sum)
            tol[k] = np.inf
        assert np.all(np.abs(got - ref) <= tol), name
        moved += not np.array_equal(got, start)
    assert moved > 0
    assert torch.equal(pstate.clip.logit_scale, was["logit_scale"])


# ------------------------------------------------------ clip%d.pth files --

def _tiny_damsm_cfg(**train):
    return tconfig.cfg_replace(
        PCFG, DATA_DIR="", TREE={"BRANCH_NUM": 1, "BASE_SIZE": 32},
        TRAIN=dict({"BATCH_SIZE": 8, "EVAL_MAX_BATCHES": 1,
                    "SNAPSHOT_INTERVAL": 1}, **train))


def test_trainer_writes_clip_pth_that_jax_reads(tmp_path, capsys):
    trainer = DamsmTrainer(_tiny_damsm_cfg(), str(tmp_path), device="cpu",
                           clip_cfg=port_clip_cfg(TINY_CLIP), words_num=16)
    assert len(trainer.train_batches) == 8  # 64 synthetic records / 8
    metrics = trainer.train(max_epochs=2)
    out = capsys.readouterr().out
    assert out.count("| end epoch") == 2
    assert sum(ln.startswith("| epoch") for ln in out.splitlines()) == 16
    assert trainer.state.step == 16 and all(map(math.isfinite,
                                                metrics.values()))
    paths = [tmp_path / "Model" / f"clip{e}.pth" for e in (0, 1)]
    assert all(p.is_file() for p in paths)

    clip = trainer.state.clip.eval()
    fresh = load_clip_pth(build_clip(port_clip_cfg(TINY_CLIP)),
                          str(paths[1]))
    for (n, a), b in zip(clip.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n

    sd = torch.load(paths[1], weights_only=True)
    jvars = convert_torch_clip_state(sd, TINY_CLIP)
    model = jclip.ClipWithRegionHead(TINY_CLIP)
    batch = _damsm_batch(np.random.default_rng(8))
    jsubr, jimg = model.apply(jvars, batch["images"],
                              method=jclip.ClipWithRegionHead
                              .encode_image_verbose)
    jwords, jsent = model.apply(jvars, batch["ids"], batch["mask"],
                                method=jclip.ClipWithRegionHead
                                .encode_text_verbose)
    with torch.no_grad():
        subr, img = clip.encode_image_verbose(torch.from_numpy(
            batch["images"]))
        words, sent = clip.encode_text_verbose(
            torch.from_numpy(batch["ids"]), torch.from_numpy(batch["mask"]))
    for ours, ref in ((subr, jsubr), (img, jimg), (words, jwords),
                      (sent, jsent)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        np.asarray(jvars["params"]["logit_scale"]),
        clip.logit_scale.detach().numpy())


def _random_port_clip(seed):
    return init_clip_(build_clip(port_clip_cfg(TINY_CLIP)),
                      torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("prefix", ["", "module.", "backbone.",
                                    "module.backbone."])
def test_reference_state_round_trips_through_jax(prefix):
    src = _random_port_clip(1)
    sd = {prefix + k: v for k, v in clip_reference_state_dict(src).items()}
    ours = load_reference_clip_state(build_clip(port_clip_cfg(TINY_CLIP)),
                                     sd)
    for (n, a), b in zip(src.state_dict().items(),
                         ours.state_dict().values()):
        assert torch.equal(a, b), n
    # The JAX converter reads the same dict into the same weights.
    via_jax = _port_clip(_np(convert_torch_clip_state(sd,
                                                      TINY_CLIP)["params"]))
    for (n, a), b in zip(src.state_dict().items(),
                         via_jax.state_dict().values()):
        assert torch.equal(a, b), n


def test_bare_clipmodel_state_gets_the_jax_fresh_head():
    sd = {k: v for k, v in clip_reference_state_dict(
        _random_port_clip(2)).items()
        if not k.startswith("linear_subr") and k != "logit_scale"}
    ours = load_reference_clip_state(_random_port_clip(3), sd)
    ref = convert_torch_clip_state(sd, TINY_CLIP)["params"]
    np.testing.assert_array_equal(ours.linear_subr.weight.detach().numpy(),
                                  np.asarray(ref["linear_subr"]["kernel"]).T)
    np.testing.assert_array_equal(ours.linear_subr.bias.detach().numpy(),
                                  np.asarray(ref["linear_subr"]["bias"]))
    assert ours.logit_scale.item() == pytest.approx(
        float(ref["logit_scale"]), rel=1e-7)


@pytest.mark.parametrize("break_it, error", [
    (lambda sd: sd.pop("text_model.final_layer_norm.bias"), KeyError),
    (lambda sd: sd.update(extra=torch.zeros(1)), ValueError),
    (lambda sd: sd.update({"text_projection.weight": torch.zeros(3, 3)}),
     ValueError)], ids=["missing", "unused", "shape"])
def test_reference_state_loader_raises(break_it, error):
    sd = clip_reference_state_dict(_random_port_clip(4))
    break_it(sd)
    with pytest.raises(error):
        load_reference_clip_state(build_clip(port_clip_cfg(TINY_CLIP)), sd)


GAN_CFG = tconfig.cfg_replace(TCFG, TRAIN={"CLIP_MODEL_CHECKPOINT": ""})


def test_gan_trainer_loads_the_clip_checkpoint(tmp_path):
    src = _random_port_clip(6)
    path = tmp_path / "Model" / "clip3.pth"
    save_clip_pth(src, str(path))
    cfg = tconfig.cfg_replace(GAN_CFG,
                              TRAIN={"CLIP_MODEL_CHECKPOINT": str(path)})
    trainer = CondGanTrainer(cfg, "cpu", clip_cfg=port_clip_cfg(TINY_CLIP))
    for (n, a), b in zip(src.state_dict().items(),
                         trainer.clip.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("ckpt", ["", "missing/clip9.pth"])
def test_gan_trainer_without_a_checkpoint_keeps_its_seeded_weights(ckpt):
    """CLIP, then G, draw from one generator in that order, as before the
    checkpoint was read."""
    cfg = tconfig.cfg_replace(GAN_CFG, TRAIN={"CLIP_MODEL_CHECKPOINT": ckpt})
    trainer = CondGanTrainer(cfg, "cpu", seed=4,
                             clip_cfg=port_clip_cfg(TINY_CLIP))
    rng = torch.Generator().manual_seed(4)
    clip = init_clip_(build_clip(port_clip_cfg(TINY_CLIP)), rng)
    gen = init_generator_(build_generator(cfg), rng)
    for want, got in ((clip, trainer.clip), (gen, trainer.state.gen)):
        for (n, a), b in zip(want.state_dict().items(),
                             got.state_dict().values()):
            assert torch.equal(a, b), n


# ----------------------------------------------------------------- CLI ----

TINY_YAML = """\
CONFIG_NAME: 'DAMSM_CLIP'
DATA_DIR: ''
TREE: {BRANCH_NUM: 1, BASE_SIZE: 32}
TRAIN: {BATCH_SIZE: 16, MAX_EPOCH: 100, CLIP_MODEL_CHECKPOINT: '',
        LINEAR_LR: 20.0, RNN_GRAD_CLIP: 0.25, EVAL_MAX_BATCHES: 1}
"""
# Room for the 30-token captions of the DAMSM step.
CLI_CLIP = dataclasses.replace(port_clip_cfg(TINY_CLIP), max_positions=32)


def test_pretrain_damsm_entry_point_on_cpu(tmp_path, capsys):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    out = tmp_path / "out"
    trainer = pretrain_damsm.main(
        ["--cfg", str(cfg), "--max_epochs", "2", "--device", "cpu",
         "--output_dir", str(out), "--batch", "32"], clip_cfg=CLI_CLIP)
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("| epoch")]
    assert len(steps) == 4  # 2 batches of 32 out of 64 records, 2 epochs
    for ln in steps:
        for key in ("loss", "w_loss", "s_loss", "contrastive", "grad_norm"):
            assert math.isfinite(float(ln.split(f" {key} ")[1].split()[0]))
    assert trainer.state.step == 4
    assert sorted(p.name for p in (out / "Model").iterdir()) == [
        "clip0.pth", "clip1.pth", "state_00000002.pt", "state_00000004.pt"]


def test_pretrain_damsm_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_damsm.main(["--cfg", str(cfg), "--max_epochs", "1",
                             "--output_dir", str(tmp_path / "out")],
                            clip_cfg=CLI_CLIP)
