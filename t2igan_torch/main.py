"""Adversarial training and evaluation of the DM-GAN (the port's
counterpart of the root ``main.py``).

    python -m t2igan_torch.main --cfg t2igan_torch/configs/clip_bird_dmgan.yml \
        [--data_dir D] [--NET_G PATH] [--manualSeed N] [--max_epochs N] \
        [--output_dir D] [--dtype f32|bf16] [--device cuda|cpu]

``TRAIN.FLAG`` trains (:meth:`CondGanTrainer.train`, split ``train``);
otherwise ``B_VALIDATION`` runs the generation + R-precision sweep
(:meth:`CondGanTrainer.sampling`, split ``test``), and otherwise the
captions named in ``<DATA_DIR>/example_filenames.txt`` are rendered
(:meth:`CondGanTrainer.gen_example`).  The seed is 100 in evaluation, and
``--manualSeed`` (random when not given) in training.  The default device
is ``cuda``; without a card this raises rather than falling back to the
CPU.  Under ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node N -m t2igan_torch.main ...``) it is data-parallel over
the ranks (:class:`t2igan_torch.train.train_gan.CondGanTrainer`), every
rank with rank 0's seed and output directory.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pprint
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from t2igan_torch.config import cfg_from_file, cfg_replace
from t2igan_torch.models.clip import ClipConfig
from t2igan_torch.parallel.mesh import init_distributed, shutdown
from t2igan_torch.train.train_gan import DTYPES, CondGanTrainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a DM-GAN network")
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="t2igan_torch/configs/clip_bird_dmgan.yml")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--NET_G", type=str, default="")
    p.add_argument("--manualSeed", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None,
                   help="override TRAIN.MAX_EPOCH")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                   help="precision of the forwards (parameters stay f32)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def load_example_captions(data_dir: str) -> Dict[str, List[str]]:
    """``{name: [caption, ...]}`` from ``example_filenames.txt``: one file
    name a line, each naming a ``<name>.txt`` of captions, one a line;
    ``name`` is the part after its last ``/``."""
    path = os.path.join(data_dir, "example_filenames.txt")
    out = {}
    with open(path) as f:
        names = [n for n in f.read().split("\n") if n]
    for name in names:
        with open(os.path.join(data_dir, name + ".txt")) as f:
            sentences = [s for s in f.read().split("\n") if s]
        out[name[name.rfind("/") + 1:]] = sentences
    return out


def main(argv: Optional[Sequence[str]] = None,
         clip_cfg: ClipConfig = ClipConfig()) -> CondGanTrainer:
    args = parse_args(argv)
    cfg = cfg_from_file(args.cfg_file)
    if args.NET_G:
        cfg = cfg_replace(cfg, TRAIN={"NET_G": args.NET_G})
    if args.data_dir:
        cfg = cfg_replace(cfg, DATA_DIR=args.data_dir)
    print("Using config:")
    pprint.pprint(cfg)

    seed = args.manualSeed
    if not cfg.TRAIN.FLAG:
        seed = 100
    elif seed is None:
        seed = random.randint(1, 10000)

    timestamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    output_dir = args.output_dir or os.path.join(
        "output", f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}_{timestamp}")
    # Under torchrun every rank takes rank 0's seed and output directory.
    mesh = init_distributed(args.device)
    seed, output_dir = mesh.gather_objects((seed, output_dir))[0]
    random.seed(seed)
    np.random.seed(seed)
    print(f"Seed: {seed}")
    split = "train" if cfg.TRAIN.FLAG else "test"
    trainer = CondGanTrainer(cfg, args.device, DTYPES[args.dtype], seed,
                             clip_cfg, output_dir=output_dir, split=split,
                             mesh=mesh)
    if cfg.TRAIN.FLAG:
        trainer.train(max_epochs=args.max_epochs)
    elif cfg.B_VALIDATION:
        trainer.sampling("valid")
    else:
        trainer.gen_example(load_example_captions(cfg.DATA_DIR))
    return trainer


if __name__ == "__main__":
    main()
    shutdown()
