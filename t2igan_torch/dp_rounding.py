"""Rounding or a fault: the data-parallel GAN step against one process,
in f32 and in f64, on the CPU.

    python -m t2igan_torch.dp_rounding [--world 2] [--lr 1.0 0.01] \
        [--threads N] [--tiny]

Builds the ``configs/clip_bird_dmgan.yml`` trainer at full width
(ViT-B/32 CLIP, weights from seed 0) and takes one step with SGD at each
``--lr`` on the same global batch of 4 and noise: ``--world`` gloo ranks
on the CPU, each on its rows, and one process without a group on all
four.  It does so in f32 (the port's arithmetic) and again in f64: the
modules are cast to f64 and, inside the f64 run, ``Tensor.float`` casts
to f64, so the same code computes in double precision.  A split that
only reorders sums shrinks its gap by the precision's ratio, ~5e8; a
fault of the data-parallel path (a wrong row, term or factor) keeps it.

For each precision and learning rate it prints the gap, each as a ratio
to its bound: the metrics (1e-4 relative); every parameter and buffer
against ``1e-4 + 1e-4 |x|`` (the CPU test's bound); each parameter
against 1e-3 of its module's largest change (``chip_smoke.py`` phase
9b's measure) and against 1e-3 of its own largest change; and each
gradient against its own largest entry.  The last line is a JSON object
of the same figures.  ``--tiny`` runs the tests' small widths instead (a
quick check of the script itself).  Writes nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from t2igan_torch.config import cfg_from_dict, cfg_replace
from t2igan_torch.configs import CLIP_BIRD_DMGAN
from t2igan_torch.data.synthetic import bench_train_batches
from t2igan_torch.models.clip import ClipConfig, ClipTowerConfig
from t2igan_torch.parallel.mesh import DataMesh, spawn_local
from t2igan_torch.train.state import init_gan_state
from t2igan_torch.train.train_gan import CondGanTrainer

BATCH = 4
SEED = 7
# The tests' small widths (tests/test_train_steps.py), for --tiny.
TINY_CLIP = ClipConfig(projection_dim=32, image_size=32, patch_size=16,
                       region_dim=32, text=ClipTowerConfig(32, 2, 2, 64),
                       vision=ClipTowerConfig(48, 2, 2, 96))


def config(tiny: bool):
    cfg = cfg_replace(cfg_from_dict(CLIP_BIRD_DMGAN), DATA_DIR="",
                      TRAIN={"BATCH_SIZE": BATCH, "CLIP_MODEL_CHECKPOINT": ""})
    if tiny:
        cfg = cfg_replace(cfg, TREE={"BRANCH_NUM": 2, "BASE_SIZE": 64},
                          GAN={"GF_DIM": 8, "DF_DIM": 4, "Z_DIM": 16,
                               "CONDITION_DIM": 16, "R_NUM": 1},
                          TEXT={"EMBEDDING_DIM": 32})
    return cfg, TINY_CLIP if tiny else ClipConfig()


@contextlib.contextmanager
def precision(f64: bool):
    """With ``f64``, inside the block ``Tensor.float()`` returns f64 (the
    port casts to f32 with ``.float()``) and new tensors default to f64;
    without it nothing changes."""
    if not f64:
        yield
        return
    as_f32, dtype = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = as_f32
        torch.set_default_dtype(dtype)


def steps(mesh: DataMesh, tiny: bool, f64: bool, lrs, start=None):
    """One SGD step at each of ``lrs`` from the same seeded state (or from
    ``start``, G's and the Ds' state dicts) on this rank's rows of the
    global batch: per lr the metrics, every module's state before and
    after, and the (reduced) gradients."""
    cfg, clip_cfg = config(tiny)
    trainer = CondGanTrainer(cfg, "cpu", seed=0, clip_cfg=clip_cfg,
                             mesh=mesh)
    modules = [trainer.clip, trainer.state.gen, *trainer.state.ds]
    if f64:
        for m in modules:
            m.double()
    if start is None:
        start = [{k: v.clone() for k, v in m.state_dict().items()}
                 for m in modules[1:]]
    batch = bench_train_batches(BATCH, trainer.clip.cfg.eos_token_id)[0]
    # A same-class pair across the ranks' boundary.
    batch["class_ids"] = (np.arange(BATCH, dtype=np.int32) + 1) // 2
    g = torch.Generator().manual_seed(SEED)
    noise = [torch.randn((BATCH, d), generator=g) for d in
             (cfg.GAN.Z_DIM, cfg.GAN.CONDITION_DIM, cfg.GAN.CONDITION_DIM)]
    b = BATCH // mesh.world
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    local = {k: [x[rows] for x in v] if isinstance(v, list) else v[rows]
             for k, v in batch.items()}
    out = {}
    for lr in lrs:
        for m, sd in zip(modules[1:], start):
            m.load_state_dict(sd)
        sgd = lambda params: torch.optim.SGD(params, lr=lr)  # noqa: E731
        state = init_gan_state(cfg, modules[1], modules[2:], sgd, sgd)
        with precision(f64):
            metrics = trainer.step_fn(state, local, *noise)
        out[lr] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "before": start,
            "after": [{k: v.detach().clone()
                       for k, v in m.state_dict().items()}
                      for m in (state.gen, *state.ds)],
            "grads": [{n: p.grad.clone() for n, p in m.named_parameters()
                       if p.grad is not None}
                      for m in (state.gen, *state.ds)]}
    return out


def gaps(dp, one, names):
    """The worst gap of any rank's run ``dp`` to the one-process run
    ``one``, each as a ratio to its bound, with the tensor that gives it;
    ``names`` labels the modules of ``after``.  The parameters are the
    tensors with gradients, or those ``one["params"]`` names per module
    (an EMA copy has none)."""
    worst = {}

    def note(key, value, where):
        if value > worst.get(key, (-1.0, ""))[0]:
            worst[key] = (value, where)

    params = one.get("params", [list(g) for g in one["grads"]])
    for r in dp:
        for k, want in one["metrics"].items():
            note("metrics", abs(r["metrics"][k] - want)
                 / max(1e-5, abs(want)) / 1e-4, k)
        for name, a, b, b0, grads, want_grads, keys in zip(
                names, r["after"], one["after"], one["before"], r["grads"],
                one["grads"], params):
            change = {k: (b[k] - b0[k]).abs().max().item() for k in keys}
            module = max(change.values(), default=0.0)
            for k in b:
                d = (a[k] - b[k]).abs()
                note("abs_rel", (d / (1e-4 + 1e-4 * b[k].abs())).max()
                     .item(), f"{name}.{k}")
                if k in change:
                    note("module_change", d.max().item()
                         / (1e-3 * module), f"{name}.{k}")
                    if change[k] > 0:
                        note("own_change", d.max().item()
                             / (1e-3 * change[k]), f"{name}.{k}")
            for k, w in want_grads.items():
                scale = w.abs().max().item()
                if scale > 0:
                    note("grad", (grads[k] - w).abs().max().item() / scale,
                         f"{name}.{k}")
    return worst


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--lr", type=float, nargs="+", default=[1.0, 0.01])
    p.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    p.add_argument("--tiny", action="store_true",
                   help="the tests' small widths (a check of the script)")
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for f64 in (False, True):
            name = "f64" if f64 else "f32"
            t0 = time.perf_counter()
            dp = spawn_local(steps, args.world, "gloo", "cpu",
                             os.path.join(tmp, f"store_{name}"), 3600,
                             (args.tiny, f64, args.lr),
                             max(1, args.threads // args.world))
            # From the ranks' weights: the orthogonal initializer's QR
            # rounds differently at another thread count.
            one = steps(DataMesh.single("cpu"), args.tiny, f64, args.lr,
                        dp[0][args.lr[0]]["before"])
            for lr in args.lr:
                worst = gaps([r[lr] for r in dp], one[lr], ["g"] + [
                    f"d{i}" for i in range(len(one[lr]["after"]) - 1)])
                summary[f"{name} lr {lr:g}"] = {
                    k: [v, where] for k, (v, where) in worst.items()}
                print(f"{name}, SGD lr {lr:g}, {args.world} gloo ranks vs one "
                      f"process, global batch {BATCH}; gap / bound: " + ", ".join(
                          f"{k} {v:.3e} ({where})"
                          for k, (v, where) in sorted(worst.items())),
                      flush=True)
            print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
