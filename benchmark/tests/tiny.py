"""A copy of the benchmark at tiny widths for the CPU tests: every
configuration's widths and every traffic mix's batch cut down, so that a
whole run (set-up, window, reference) takes seconds on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_WIDTHS = {"GF_DIM": 8, "DF_DIM": 4, "R_NUM": 1, "Z_DIM": 16,
               "CONDITION_DIM": 32, "EMBEDDING_DIM": 32}
TINY_CLIP = {"projection_dim": 32, "region_dim": 32, "image_size": 64,
             "text": {"hidden_size": 32, "num_layers": 2, "num_heads": 2,
                      "mlp_dim": 64},
             "vision": {"hidden_size": 48, "num_layers": 2, "num_heads": 2,
                        "mlp_dim": 96}}
TINY_TRAFFIC = {"batch": 4, "batches": 4, "bank": 64, "classes": 4}


def copy(tmp: Path) -> Path:
    """The benchmark's folder and ``BENCHMARK.json`` under ``tmp``, at
    tiny widths; returns the copy's folder."""
    root = tmp / "benchmark"
    shutil.copytree(REPO / "benchmark", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["widths"].update(TINY_WIDTHS)
        cfg["clip"].update(TINY_CLIP)
        path.write_text(json.dumps(cfg))
    for path in (root / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update({k: v for k, v in TINY_TRAFFIC.items() if k in t})
        path.write_text(json.dumps(t))
    return root
