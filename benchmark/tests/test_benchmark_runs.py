"""Whole runs at tiny widths on the CPU: the harness past its look for a
card (``harness.run`` on the CPU device), with the timed path broken
underneath or the control in the program's place, must come out
``correct: false``; and a card run on the card.

The limits are the cells' own (``workloads/<cell>.json``)."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import tiny
from benchmark import faults, harness, spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("tiny"))


def run(root, name, control=None):
    cell = spec.load_cell(name, root)
    return harness.run(cell, SEED, 0.3, False, CPU, time.time(), control)


@pytest.mark.parametrize("name", [
    "cub_train_bf16_b16", "coco_sample_fused_f32_b128",
    "cub_sweep_bf16_b10", "cub_sample_fused_bf16_b128"])
def test_control_is_not_correct(root, name):
    """The reference one precision below the configuration's, in the
    program's place (bf16 -> fp8 operands; f32 -> bf16)."""
    dtype = json.loads((root / "configs" / (
        "coco_dmgan.json" if name.startswith("coco") else
        "cub_dmgan.json")).read_text())["dtype"]
    out = run(root, name, harness.CONTROL[dtype])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name, fault", [
    ("cub_train_bf16_b16", "unchanged"), ("cub_train_bf16_b16", "half_batch"),
    ("coco_sample_fused_f32_b128", "altered"),
    ("coco_sample_fused_f32_b128", "half_batch"),
    ("cub_sample_fused_bf16_b128", "altered"),
    ("cub_sample_fused_bf16_b128", "half_batch"),
    ("cub_sweep_bf16_b10", "altered"), ("cub_sweep_bf16_b10", "half_batch")])
def test_faults_are_not_correct(root, name, fault):
    """The timed path broken underneath (:mod:`benchmark.faults`)."""
    entry = spec.load_cell(name, root).entry
    with faults.planted(entry, fault):
        out = run(root, name)
    assert out["correct"] is False, out["checks"]
    if fault == "unchanged":
        assert out["checks"]["change_gap_median"]["value"] > 0.5


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """The command as the driver gives it, a short window: the result
    line, ``correct``, and the device named."""
    repo = Path(__file__).resolve().parents[2]
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cub_sample_fused_bf16_b128", "--seed", str(SEED), "--seconds",
         "2", "--trace", "1"], cwd=repo, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert list(line)[-1] == "checks"
