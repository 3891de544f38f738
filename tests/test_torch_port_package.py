"""The port's package boundary: config, tokenizer and YAML copies agree
with the JAX package's, the package and ``chip_smoke.py`` import nothing
of JAX, ``t2igan`` or PIL (the card machine has none of them), and
``chip_smoke.py`` refuses to run without a card."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import t2igan_torch
from t2igan import config as jconfig
from t2igan.data import tokenizer as jtok
from t2igan_torch import config as tconfig
from t2igan_torch.data import tokenizer as ttok

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIGS = sorted((REPO / "t2igan" / "configs").rglob("*.yml"))
PORT = Path(t2igan_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "t2igan", "PIL")

CAPTIONS = [
    "this bird has a red crown and a short pointed beak",
    "A small   YELLOW bird &amp; black wings; it's 12 cm long!",
    "",
    "ünïcödé bïrd " * 20,  # longer than 77 tokens: truncated with <eos>
]


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=lambda p: p.name)
def test_config_copy_matches_for_every_yaml(path):
    ours = tconfig.cfg_from_file(str(path))
    ref = jconfig.cfg_from_file(str(path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.branch_sizes == ref.branch_sizes


def test_config_defaults_and_rules_match():
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(
        jconfig.Config())
    for mod in (tconfig, jconfig):
        with pytest.raises(KeyError):
            mod.cfg_from_dict({"GAN": {"NOT_A_KEY": 1}})
        with pytest.raises(ValueError):
            mod.cfg_from_dict({"GAN": {"GF_DIM": "64"}})
        assert mod.cfg_replace(mod.Config(),
                               TRAIN={"SMOOTH": {"GAMMA1": 4}}).TRAIN.SMOOTH \
            .GAMMA1 == 4.0


def test_packaged_eval_config_is_the_jax_one():
    src = REPO / "t2igan" / "configs" / "eval_clip_bird.yml"
    assert (PORT / "configs" / "eval_clip_bird.yml").read_text() == \
        src.read_text()


def test_eval_config_dict_is_the_packaged_yaml():
    import yaml

    from t2igan_torch.configs import EVAL_CLIP_BIRD

    path = PORT / "configs" / "eval_clip_bird.yml"
    assert EVAL_CLIP_BIRD == yaml.safe_load(path.read_text())
    assert tconfig.cfg_from_dict(EVAL_CLIP_BIRD) == \
        tconfig.cfg_from_file(str(path))


def test_packaged_train_config_is_the_jax_one():
    src = REPO / "t2igan" / "configs" / "clip_bird_dmgan.yml"
    assert (PORT / "configs" / "clip_bird_dmgan.yml").read_text() == \
        src.read_text()


def test_train_config_dict_is_the_packaged_yaml():
    import yaml

    from t2igan_torch.configs import CLIP_BIRD_DMGAN

    path = PORT / "configs" / "clip_bird_dmgan.yml"
    assert CLIP_BIRD_DMGAN == yaml.safe_load(path.read_text())
    assert tconfig.cfg_from_dict(CLIP_BIRD_DMGAN) == \
        tconfig.cfg_from_file(str(path))


@pytest.mark.parametrize("name", ["bird.yml", "coco.yml"])
def test_packaged_damsm_configs_are_the_jax_ones(name):
    src = REPO / "t2igan" / "configs" / "damsm" / name
    assert (PORT / "configs" / "damsm" / name).read_text() == src.read_text()


def test_damsm_config_dict_is_the_packaged_yaml():
    import yaml

    from t2igan_torch.configs import DAMSM_BIRD

    path = PORT / "configs" / "damsm" / "bird.yml"
    assert DAMSM_BIRD == yaml.safe_load(path.read_text())
    assert tconfig.cfg_from_dict(DAMSM_BIRD) == \
        tconfig.cfg_from_file(str(path))


def _assert_same_tokens(ours, ref, captions):
    a, b = ours(captions, max_length=77), ref(captions, max_length=77)
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    for i in range(len(captions)):
        assert ours.decode(a["input_ids"][i]) == ref.decode(b["input_ids"][i])


def test_tokenizer_fallback_matches():
    ours, ref = ttok.ClipTokenizer.load(), jtok.ClipTokenizer.fallback()
    _assert_same_tokens(ours, ref, CAPTIONS)
    assert ours(CAPTIONS)["input_ids"][3, -1] == ttok.VOCAB_SIZE - 1


def test_tokenizer_bpe_files_match(tmp_path):
    """With vocab.json + merges.txt both run the same BPE merges."""
    enc = dict(jtok.ClipTokenizer.fallback().encoder)
    merges = [("t", "h"), ("th", "e</w>"), ("b", "i"), ("bi", "r"),
              ("bir", "d</w>"), ("r", "e"), ("re", "d</w>")]
    for a, b in merges:
        enc.setdefault(a + b, len(enc))
    (tmp_path / "vocab.json").write_text(json.dumps(enc))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    ours = ttok.ClipTokenizer.load(str(tmp_path))
    ref = jtok.ClipTokenizer.from_files(str(tmp_path / "vocab.json"),
                                        str(tmp_path / "merges.txt"))
    assert ours.bpe_ranks and ours.tokenize("the red bird") == [
        "the</w>", "red</w>", "bird</w>"]
    _assert_same_tokens(ours, ref, CAPTIONS + ["the red bird the bird"])


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_nothing_of_jax_or_t2igan(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_import_guard_covers_every_module_of_the_train_slice():
    """The two guards above walk every source of the package; these are
    the modules the train slice added."""
    sources = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"ops/spectral.py", "models/discriminator.py",
            "losses/__init__.py", "losses/gan.py", "losses/damsm.py",
            "losses/ntxent.py", "train/state.py", "train/train_gan.py",
            "data/synthetic.py", "train_gan.py"} <= sources


def test_import_guard_covers_every_module_of_the_eval_slice():
    """The modules the fused-tail and gen+eval slice added, and its CUDA
    source among the sources the build compiles."""
    from t2igan_torch.ops.kernels import build

    sources = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"ops/kernels/reschain.py", "models/inception.py",
            "evaluation/__init__.py", "evaluation/fid.py"} <= sources
    assert "reschain" in build.SOURCES
    assert (build.CSRC_DIR / "reschain.cu").is_file()


def test_import_guard_covers_every_module_of_the_damsm_slice():
    """The modules the DAMSM slice added."""
    sources = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"train/schedule.py", "train/pretrain_damsm.py",
            "pretrain_damsm.py"} <= sources


def test_import_guard_covers_every_module_of_the_checkpoint_slice():
    """The modules the train -> checkpoint -> evaluate slice added."""
    sources = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"train/checkpoint.py", "train/export.py",
            "evaluation/rprecision.py", "utils/__init__.py", "utils/png.py",
            "utils/viz.py", "main.py"} <= sources


def test_importing_the_port_loads_no_jax_or_t2igan():
    """Import the package and every submodule in a fresh interpreter; no
    JAX, flax or t2igan module may appear in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import t2igan_torch\n"
        "for m in pkgutil.walk_packages(t2igan_torch.__path__,"
        " 't2igan_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card():
    """Here torch has no CUDA: the script exits non-zero and prints no
    result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_import_guard_covers_every_module_of_the_data_slice():
    """The modules the real-data slice added (the decoder's bindings, the
    dataset, its loader, FID/IS from directories and their CLIs), and the
    host library's C++ sources beside the CUDA ones."""
    from t2igan_torch.data import native

    sources = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"data/native.py", "data/dataset.py", "data/clip_dataset.py",
            "data/pipeline.py", "data/cub_tree.py",
            "evaluation/inception_score.py", "fid_score.py",
            "inception_score.py"} <= sources
    for name in native.SOURCES + native.HEADERS:
        assert (native.CSRC_DIR / name).is_file()


def test_import_guard_covers_every_module_of_the_parallel_slice():
    """The modules the parallelism slice added."""
    sources = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/tp.py"} <= sources
