"""The port's figures and metrics log against the JAX package's, on the
CPU: PIL's bicubic resize (``resize_pil_bicubic``), PIL's default-font
labels (``glyphs.draw_text`` and the committed glyph table), the
attention grid (``attention_grid``: bit for bit against the JAX package's
PIL grid under hypothesis, and the committed fixture's recorded sha256),
the DAMSM trainer's ``attn_epoch%d.png`` beside the JAX trainer's, and
``MetricsLogger`` rows beside the JAX logger's.

Bounds: the resize, the labels and the grid on the same inputs bitwise.
The DAMSM figure from the two packages' own encoders: the same size and
labels, every uint8 within 1 count of the JAX figure's (the attention
maps agree to 1e-5, and ``astype(np.uint8)`` can truncate either side of
a boundary) at under 0.5% of its entries.  Logged metric values equal to
the floats the JAX logger writes for the same inputs.
"""

import hashlib
import json
import math
import sys
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw, ImageFont

from make_torch_port_fixtures import GLYPHS, OUT, glyph_table
from test_torch_port_damsm import _tiny_damsm_cfg
from test_torch_port_train_modules import port_clip_cfg
from test_train_steps import TINY_CLIP
from t2igan.utils import logging as jlogging
from t2igan.utils import viz as jviz
from t2igan_torch.data.native import resize_pil_bicubic
from t2igan_torch.utils import glyphs
from t2igan_torch.utils import logging as tlogging
from t2igan_torch.utils import viz as tviz

LATIN1 = st.characters(min_codepoint=0x20, max_codepoint=0xFF)
LABEL = st.one_of(st.just(""), st.just("·"), st.text(LATIN1, max_size=16))


@pytest.fixture(autouse=True, scope="module")
def _hashable_sys_modules():
    """hypothesis hashes every entry of ``sys.modules`` while it draws;
    another test file of the suite registers a ``SimpleNamespace`` there
    as a stub module, which cannot be hashed.  Such entries stand in as
    real modules with the same attributes while this file runs."""
    swapped = {}
    for name, mod in list(sys.modules.items()):
        try:
            hash(mod)
        except TypeError:
            swapped[name] = mod
            stand_in = types.ModuleType(name)
            stand_in.__dict__.update(vars(mod))
            sys.modules[name] = stand_in
    yield
    sys.modules.update(swapped)


# ------------------------------------------------------------- resize ----

def test_pil_resize_defaults_to_bicubic_for_rgb():
    """The JAX grid calls ``Image.resize(size)``: pin that its default
    filter for RGB is BICUBIC, which the port reproduces."""
    a = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    img = Image.fromarray(a)
    np.testing.assert_array_equal(
        np.asarray(img.resize((96, 96))),
        np.asarray(img.resize((96, 96), Image.Resampling.BICUBIC)))


@pytest.mark.parametrize("size", [64, 128, 224, 256])
def test_resize_pil_bicubic_is_pil(size):
    rng = np.random.default_rng(size)
    for a in (rng.integers(0, 256, (size, size, 3), np.uint8),
              np.repeat(np.repeat(rng.integers(0, 256, (size // 8,) * 2 +
                                               (3,), np.uint8), 8, 0), 8, 1)):
        np.testing.assert_array_equal(
            resize_pil_bicubic(a, 96, 96),
            np.asarray(Image.fromarray(a).resize((96, 96))))


# ------------------------------------------------------------- labels ----

def test_glyph_table_is_pils_default_font():
    """Every entry of the committed table is what PIL draws now, and code
    points outside it draw as the missing glyph."""
    font = ImageFont.load_default()
    table = glyphs.GlyphTable(GLYPHS)
    assert table.info["pillow"] == Image.__version__
    assert "Aileron Regular" in table.info["font"]
    assert "CC0" in table.info["licence"]
    for ch in [chr(c) for c in range(0x20, 0x100)] + list(table.glyphs):
        mask, off = font.getmask2(ch, "L")
        want = np.asarray(Image.frombytes("L", mask.size, bytes(mask)))
        got, got_off, adv = table.glyph(ch)
        assert got_off == tuple(off) and adv == font.getlength(ch), ch
        np.testing.assert_array_equal(got, want.reshape(got.shape), ch)
    missing, off, adv = table.missing
    for ch in ("中", "Ā", "\U0001f426"):
        assert ch not in table.glyphs
        mask, moff = font.getmask2(ch, "L")
        assert tuple(moff) == off and font.getlength(ch) == adv
    assert table.kerning == {}


def test_glyph_table_file_is_the_generators():
    """The committed table holds what ``glyph_table()`` renders."""
    want = glyph_table()
    with np.load(GLYPHS) as f:
        assert sorted(f.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(f[k], v, k)


OTHER = st.sampled_from("’…ﬁ中\U0001f426")  # beyond Latin-1; two missing


@settings(max_examples=60, deadline=None)
@given(text=st.text(st.one_of(LATIN1, OTHER), max_size=14),
       x=st.integers(-12, 70), y=st.integers(-12, 30),
       seed=st.integers(0, 2**16), white=st.booleans())
def test_draw_text_is_pil(text, x, y, seed, white):
    """Labels anywhere on a canvas, clipped at its edges, over white or
    noise: the port's pixels are PIL's."""
    rng = np.random.default_rng(seed)
    canvas = (np.full((24, 60, 3), 255, np.uint8) if white else
              rng.integers(0, 256, (24, 60, 3), np.uint8))
    img = Image.fromarray(canvas.copy())
    ImageDraw.Draw(img).text((x, y), text, fill="black")
    glyphs.draw_text(canvas, x, y, text)
    np.testing.assert_array_equal(canvas, np.asarray(img))


# --------------------------------------------------------------- grid ----

@settings(max_examples=25, deadline=None)
@given(data=st.data(), b=st.integers(1, 8), size=st.sampled_from([64, 128,
                                                                   256]),
       flat=st.booleans(), side=st.integers(1, 9), words=st.integers(1, 11))
def test_attention_grid_matches_jax(data, b, size, flat, side, words):
    seed = data.draw(st.integers(0, 2**16))
    rng = np.random.default_rng(seed)
    images = rng.random((b, size, size, 3)).astype(np.float32)
    if flat:  # [B, P, L], P not always a square
        attn = rng.random((b, side * side + side // 3, words))
    else:
        attn = rng.random((b, side, side, words))
    attn = attn.astype(np.float32)
    attn[rng.random(attn.shape) < 0.02] = np.nan
    if words > 1:
        attn[..., 1] = -attn[..., 1]
    labels = [data.draw(st.lists(LABEL, max_size=10)) for _ in range(b)]
    got = tviz.attention_grid(images, attn, labels)
    want = jviz.attention_grid(images, attn, labels)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_attention_grid_fixture_hash():
    """The committed fixture: the sha256 recorded beside it is the JAX
    package's PIL grid's, and the port's grid has it (the card machine's
    check of the labels, which has no PIL)."""
    record = json.loads((OUT / "fixtures.json").read_text())["attention_grid"]
    with np.load(OUT / record["file"]) as f:
        images = f["images_u8"].astype(np.float32) / 255.0
        attn = f["attn"]
    for grid in (jviz.attention_grid(images, attn, record["labels"]),
                 tviz.attention_grid(images, attn, record["labels"])):
        assert list(grid.shape) == record["shape"]
        assert hashlib.sha256(grid.tobytes()).hexdigest() == \
            record["sha256_grid"]


def test_denormalize_clip_and_tanh_to01_match_jax():
    x = np.random.default_rng(2).normal(0, 2, (2, 8, 8, 3)).astype(
        np.float32)
    for f in ("denormalize_clip", "tanh_to01"):
        got, want = getattr(tviz, f)(x), getattr(jviz, f)(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- metrics log ----

def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_logger_rows_are_the_jax_loggers(tmp_path, capsys):
    """The same steps and values through both loggers: the same keys in
    the same order and the same values (``time`` and ``sec_per_step``
    aside); the port's 0-dim tensors are written when ``print_every``
    rows are held, at a console line and at ``flush``, never before."""
    rng = np.random.default_rng(0)
    steps = [1, 2, 3, 4, 5, 7, 8]
    vals = [{"loss": np.float32(rng.normal()), "acc": np.float32(rng.random()),
             "vec": np.zeros(3), "note": "x"} for _ in steps]
    jlog = jlogging.MetricsLogger(str(tmp_path / "jax"), print_every=4)
    plog = tlogging.MetricsLogger(str(tmp_path / "port"), print_every=4)
    timer = tlogging.StepTimer(4)
    written = []
    for step, v in zip(steps, vals):
        jlog.log(step, dict(v, images_per_sec=12.5))
        timer.tick()
        plog.log(step, {"loss": torch.tensor(v["loss"]),
                        "acc": torch.tensor(v["acc"]),
                        "vec": torch.zeros(3), "note": "x",
                        "images_per_sec": 12.5})
        written.append(len(_rows(plog.path)))
    jlog.close()
    out = capsys.readouterr().out.splitlines()
    assert written == [0, 0, 0, 4, 4, 4, 7]  # at 4: a console line
    plog.close()
    assert out[0] == out[1] and out[0].startswith("[train step 4] loss:")
    want, got = _rows(jlog.path), _rows(plog.path)
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k in ("time", "sec_per_step"):
            g.pop(k, None), w.pop(k, None)
        assert g == w
    assert math.isfinite(timer.images_per_sec) and timer.ms_per_step > 0


def test_damsm_trainer_figure_and_metrics_match_jax(tmp_path):
    """The port's DAMSM trainer and the JAX trainer's figure code on the
    same CLIP weights and probe batch draw the same ``attn_epoch%d.png``,
    within the bound above; an epoch of the port's trainer writes
    ``metrics.jsonl`` (one row a step, the JAX step's metric keys) and the
    figure."""
    import jax
    from t2igan.data.tokenizer import ClipTokenizer as JTokenizer
    from t2igan.models import clip as jclip
    from t2igan.train import pretrain_damsm as jpretrain
    from t2igan_torch.models.convert import load_jax_clip
    from t2igan_torch.train.pretrain_damsm import DamsmTrainer

    cfg = _tiny_damsm_cfg()
    out = tmp_path / "port"
    trainer = DamsmTrainer(cfg, str(out), device="cpu",
                           clip_cfg=port_clip_cfg(TINY_CLIP), words_num=16)
    model = jclip.ClipWithRegionHead(TINY_CLIP)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(3), np.zeros((1, 32, 32, 3), np.float32),
        np.zeros((1, 16), np.int32), np.ones((1, 16), np.int32))["params"])
    load_jax_clip(trainer.state.clip, params)
    trainer.save_attention_figure(7)

    jt = object.__new__(jpretrain.DamsmTrainer)
    jt.cfg, jt.clip_model, jt.output_dir = cfg, model, str(tmp_path / "jax")
    jt.val_loader, jt.tokenizer = trainer.val_batches, JTokenizer.load(None)
    jt.state = types.SimpleNamespace(clip_params=params)
    jt._save_attention_figure(7)
    want = np.asarray(Image.open(tmp_path / "jax" / "Image" /
                                 "attn_epoch7.png"))
    got = np.asarray(Image.open(out / "Image" / "attn_epoch7.png"))
    assert got.shape == want.shape == (4 * 110, 9 * 96, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005

    trainer.train(max_epochs=1)
    rows = _rows(out / "metrics.jsonl")
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert set(rows[-1]) == {"step", "time", "prefix", "loss", "w_loss",
                             "s_loss", "contrastive", "grad_norm",
                             "images_per_sec", "sec_per_step"}
    assert (out / "Image" / "attn_epoch0.png").is_file()
