"""One command from checkpoints to the headline quality metrics (the port's
counterpart of ``tools/quality_parity.py``).

    python -m t2igan_torch.quality_parity \\
        --cfg t2igan_torch/configs/eval_clip_bird.yml \\
        --data_dir data/birds \\
        --clip_ckpt output/pretrained/clip350.pth \\
        --net_g models/netG_bird/netG_epoch_600.pth \\
        --fid_inception_ckpt weights/pt_inception-2015-12-05.pth \\
        --is_inception_ckpt weights/inception_v3_torchvision.pth \\
        [--write_baseline BASELINE.md]

It runs the generation + R-precision sweep
(:meth:`CondGanTrainer.sampling` over split ``test``, 11 rounds, stopping
at ``--r_target`` ranked images), the FID of the sweep's
``valid/single`` images against the dataset's real images
(``CUB_200_2011/images`` for birds, ``val2014`` for COCO, or
``--real_dir``), and their Inception Score, and prints one JSON object of
the results.  ``--net_g`` may name a ``netG_epoch_%d.pth`` or a JAX
``.npz`` export; ``--clip_ckpt`` a ``clip%d.pth``.  Without an Inception
checkpoint the network is random (from seed 0) and its score means
nothing, which it says.

``--dry_run`` pulls every wire without any of those files: the synthetic
dataset, random weights, batch 8, one round, at most 64 ranked images,
and the FID of ``valid/single`` against itself (0 up to float64
rounding).

``--write_baseline PATH`` appends the result block of the JAX tool to
``PATH``; without it nothing but the sweep's images is written.  The
default device is ``cuda``; without a card this raises rather than
falling back to the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

from t2igan_torch.config import cfg_from_file, cfg_replace
from t2igan_torch.evaluation.fid import (calculate_fid_given_paths,
                                         make_activation_fn)
from t2igan_torch.evaluation.inception_score import inception_score
from t2igan_torch.fid_score import load_inception
from t2igan_torch.models.clip import ClipConfig
from t2igan_torch.ops.kernels import LAUNCHES
from t2igan_torch.train.train_gan import DTYPES, CondGanTrainer

# The reference's real-image directories (fid_score.py:238-241).
REAL_DIRS = {"birds": "CUB_200_2011/images", "coco": "val2014"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", default="t2igan_torch/configs/eval_clip_bird.yml")
    p.add_argument("--data_dir", default="")
    p.add_argument("--clip_ckpt", default="",
                   help="clip*.pth from DAMSM pretraining")
    p.add_argument("--net_g", default="",
                   help="netG_epoch_*.pth (reference torch) or .npz export")
    p.add_argument("--fid_inception_ckpt",
                   default=os.environ.get("T2IGAN_INCEPTION_CKPT", ""),
                   help="pt_inception-2015-12-05 weights (pytorch-fid)")
    p.add_argument("--is_inception_ckpt",
                   default=os.environ.get("T2IGAN_IS_INCEPTION_CKPT", ""),
                   help="torchvision inception_v3 weights")
    p.add_argument("--real_dir", default="",
                   help="real-image dir for FID; defaults per dataset "
                        "(fid_score.py:238-241)")
    p.add_argument("--output_dir", default="")
    p.add_argument("--r_target", type=int, default=30000,
                   help="R-precision query count (trainer.py:605)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="override TRAIN.BATCH_SIZE")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dry_run", action="store_true",
                   help="synthetic data + random weights + tiny sweep; "
                        "validates the pipeline, not the scores")
    p.add_argument("--write_baseline", default="", metavar="PATH",
                   help="append the result block to PATH")
    return p.parse_args(argv)


def baseline_block(args: argparse.Namespace, results: Dict[str, Any],
                   date: str) -> str:
    """The JAX tool's result block for ``results``."""
    return (
        f"\n### Quality parity run — {date}\n\n"
        f"Protocol: trainer.py:485-613 / fid_score.py / "
        f"inception_score.py equivalents via python -m "
        f"t2igan_torch.quality_parity "
        f"(cfg `{args.cfg}`, netG `{results['net_g']}`, CLIP "
        f"`{results['clip']}`"
        + (", DRY RUN — synthetic data, random weights"
           if args.dry_run else "") + ").\n\n"
        f"| Metric | Value |\n|---|---|\n"
        f"| FID ({results['dataset']}) | {results['fid']:.3f} |\n"
        f"| Inception Score | {results['is_mean']:.3f} ± "
        f"{results['is_std']:.3f} |\n"
        f"| CLIP R-precision | {100 * results['r_precision_mean']:.2f}% ± "
        f"{100 * results['r_precision_std']:.2f}% (n≈{args.r_target}) |\n")


def main(argv: Optional[Sequence[str]] = None,
         clip_cfg: ClipConfig = ClipConfig()) -> Dict[str, Any]:
    args = parse_args(argv)
    cfg = cfg_from_file(args.cfg)
    over: Dict[str, Any] = {"B_VALIDATION": True}
    train_over: Dict[str, Any] = {"FLAG": False}
    if args.data_dir:
        over["DATA_DIR"] = args.data_dir
    if args.dry_run:
        over["DATA_DIR"] = ""  # the synthetic dataset
        train_over["BATCH_SIZE"] = 8
        args.r_target = min(args.r_target, 64)
    if args.net_g:
        train_over["NET_G"] = args.net_g
    if args.clip_ckpt:
        train_over["CLIP_MODEL_CHECKPOINT"] = args.clip_ckpt
    if args.batch_size:
        train_over["BATCH_SIZE"] = args.batch_size
    cfg = cfg_replace(cfg, TRAIN=train_over, **over)

    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    output_dir = args.output_dir or os.path.join(
        "output", f"quality_parity_{stamp}")
    results: Dict[str, Any] = {
        "config": args.cfg, "dataset": cfg.DATASET_NAME,
        "net_g": args.net_g or "(random init)",
        "clip": args.clip_ckpt or "(random init)",
        "dry_run": bool(args.dry_run)}
    seconds: Dict[str, float] = {}

    # 1. The generation sweep and R-precision (trainer.py:485-613).
    t0 = time.perf_counter()
    trainer = CondGanTrainer(cfg, args.device, DTYPES[args.dtype],
                             clip_cfg=clip_cfg, output_dir=output_dir,
                             split="test")
    r_mean, r_std = trainer.sampling("valid",
                                     num_rounds=1 if args.dry_run else 11,
                                     r_target=args.r_target)
    results["r_precision_mean"], results["r_precision_std"] = r_mean, r_std
    gen_dir = os.path.join(output_dir, "valid", "single")
    seconds["sweep"] = time.perf_counter() - t0

    # 2. FID (fid_score.py:206-241); the dry run's is FID(X, X).
    t0 = time.perf_counter()
    real_dir = args.real_dir or os.path.join(
        cfg.DATA_DIR, REAL_DIRS.get(cfg.DATASET_NAME, ""))
    if args.dry_run:
        real_dir = gen_dir
    fid_net = load_inception("fid", args.fid_inception_ckpt, args.device)
    results["fid"] = float(calculate_fid_given_paths(
        [gen_dir, real_dir], make_activation_fn(fid_net, dims=2048),
        batch_size=50))
    del fid_net
    seconds["fid"] = time.perf_counter() - t0

    # 3. Inception Score (inception_score.py:35-103).
    t0 = time.perf_counter()
    if not (args.is_inception_ckpt
            and os.path.isfile(args.is_inception_ckpt)):
        print("WARNING: no IS inception checkpoint — random backbone "
              "(IS == 1.0 expected).")
    is_net = load_inception("torchvision", args.is_inception_ckpt,
                            args.device)
    results["is_mean"], results["is_std"] = inception_score(gen_dir, is_net)
    seconds["is"] = time.perf_counter() - t0
    results["seconds"] = seconds
    print(json.dumps(results, indent=2))
    if trainer.device.type == "cuda":
        print("kernel launches: " + json.dumps(dict(sorted(
            LAUNCHES.items()))), flush=True)

    # 4. The result block, only where asked.
    if args.write_baseline:
        with open(args.write_baseline, "a") as f:
            f.write(baseline_block(args, results,
                                   datetime.date.today().isoformat()))
        print(f"Appended results to {args.write_baseline}")
    return results


if __name__ == "__main__":
    main()
