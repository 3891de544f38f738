"""``python -m t2igan_torch.quality_parity`` (the port of
``tools/quality_parity.py``) on the CPU, at the widths of
``tests/test_train_steps.py`` (``TINY_CLIP``, GF 8, DF 4, two scales).

The dry run (synthetic data, random weights, batch 8, one round): FID of
the sweep's images against themselves is 0 up to float64 rounding
(|FID| <= 1e-6), R-precision equals what ``CondGanTrainer.sampling()``
gives on the same config and seed, IS lies in [1, classes], and only
``--write_baseline PATH`` writes the JAX tool's result block, to ``PATH``
and nowhere else.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from test_torch_port_train_modules import port_clip_cfg
from test_train_steps import TINY_CLIP
from t2igan_torch import config as tconfig
from t2igan_torch import quality_parity
from t2igan_torch.train.train_gan import CondGanTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = ("TREE: {BASE_SIZE: 64, BRANCH_NUM: 2}\n"
             "GAN: {GF_DIM: 8, DF_DIM: 4, Z_DIM: 16, CONDITION_DIM: 16, "
             "R_NUM: 1}\n"
             "TEXT: {EMBEDDING_DIM: 32, WORDS_NUM: 16}\n")
R_TARGET = 16  # two sweep batches of 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch ops on one thread: beside the other test
    processes a process that takes every core slows down many times over
    (ROADMAP F26)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """One dry run with ``--write_baseline``; the repo's BASELINE.md must
    not change."""
    root = tmp_path_factory.mktemp("qp")
    cfg = root / "tiny.yml"
    cfg.write_text(TINY_YAML)
    baseline = os.path.join(REPO, "BASELINE.md")
    before = _sha(baseline)
    argv = ["--cfg", str(cfg), "--dry_run", "--r_target", str(R_TARGET),
            "--write_baseline", str(root / "baseline.md")]
    out = root / "run"
    results = quality_parity.main(
        argv + ["--device", "cpu", "--dtype", "f32", "--output_dir",
                str(out)], clip_cfg=port_clip_cfg(TINY_CLIP))
    assert _sha(baseline) == before
    return dict(root=root, cfg=cfg, out=out, results=results,
                args=quality_parity.parse_args(argv))


def test_dry_run_fid_of_a_set_against_itself_is_zero(dry_run):
    assert abs(dry_run["results"]["fid"]) <= 1e-6


def test_dry_run_writes_only_the_sweep_images(dry_run):
    out = dry_run["out"]
    assert sorted(os.listdir(out)) == ["valid"]
    pngs = [f for _, _, files in os.walk(out / "valid" / "single")
            for f in files]
    assert len(pngs) == R_TARGET and all(p.endswith("_0.png") for p in pngs)
    assert sorted(os.listdir(dry_run["root"])) == ["baseline.md", "run",
                                                   "tiny.yml"]


def test_dry_run_r_precision_is_the_trainers_sweep(dry_run, tmp_path):
    cfg = tconfig.cfg_replace(
        tconfig.cfg_from_file(str(dry_run["cfg"])), DATA_DIR="",
        B_VALIDATION=True, TRAIN={"FLAG": False, "BATCH_SIZE": 8})
    trainer = CondGanTrainer(cfg, "cpu", clip_cfg=port_clip_cfg(TINY_CLIP),
                             output_dir=str(tmp_path), split="test")
    want = trainer.sampling("valid", num_rounds=1, r_target=R_TARGET)
    res = dry_run["results"]
    assert (res["r_precision_mean"], res["r_precision_std"]) == want
    assert 0.0 <= want[0] <= 1.0
    assert 1.0 <= res["is_mean"] <= 1000.0 and np.isfinite(res["is_std"])
    assert res["dry_run"] and res["dataset"] == "birds"
    assert res["net_g"] == res["clip"] == "(random init)"


def test_write_baseline_appends_the_jax_block_to_the_named_file(dry_run):
    res, args = dry_run["results"], dry_run["args"]
    block = quality_parity.baseline_block(args, res, "2026-01-02")
    assert block.startswith("\n### Quality parity run — 2026-01-02\n")
    assert "DRY RUN — synthetic data, random weights" in block
    assert f"| FID (birds) | {res['fid']:.3f} |" in block
    assert (f"| CLIP R-precision | {100 * res['r_precision_mean']:.2f}% ± "
            f"{100 * res['r_precision_std']:.2f}% (n≈{R_TARGET}) |") in block
    # The run appended exactly that block, dated the day it ran.
    text = (dry_run["root"] / "baseline.md").read_text()
    date = text.split("— ")[1].split("\n")[0]
    assert text == quality_parity.baseline_block(args, res, date)


def test_the_default_device_is_the_card():
    args = quality_parity.parse_args([])
    assert args.device == "cuda" and args.dtype == "bf16"
    assert args.cfg == "t2igan_torch/configs/eval_clip_bird.yml"
    assert args.r_target == 30000 and not args.write_baseline


def test_without_a_card_the_runbook_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_parity.main(["--dry_run", "--output_dir", str(tmp_path)])
