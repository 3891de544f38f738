"""Inception Score over a directory of generated images (the port's
counterpart of the root ``inception_score.py``).

    python -m t2igan_torch.inception_score --data bird|coco | --path DIR \
        [--batch_size 32] [--splits 10] [--inception_ckpt PT] \
        [--device cuda|cpu]

The torchvision Inception-v3's weights come from a local torchvision state
dict (``--inception_ckpt`` or ``$T2IGAN_IS_INCEPTION_CKPT``); without one
the network is random, from seed 0, and the score means nothing, which it
says loudly.  The default device is ``cuda``; without a card this raises
rather than falling back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence, Tuple

from t2igan_torch.evaluation.inception_score import inception_score
from t2igan_torch.fid_score import load_inception

PRESETS = {"bird": "models/netG_bird/valid/single",
           "coco": "models/netG_coco/valid/single"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Inception Score")
    p.add_argument("--data", type=str, default=None, choices=sorted(PRESETS))
    p.add_argument("--path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--inception_ckpt", type=str,
                   default=os.environ.get("T2IGAN_IS_INCEPTION_CKPT", ""))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float]:
    args = parse_args(argv)
    path = args.path or PRESETS.get(args.data)
    if path is None:
        raise SystemExit("pass --data {bird,coco} or --path DIR")
    model = load_inception("torchvision", args.inception_ckpt, args.device)
    t0 = time.perf_counter()
    mean, std = inception_score(path, model, args.batch_size, args.splits)
    print(f"scored {path} in {time.perf_counter() - t0:.2f} s")
    print(f"IS mean: {mean:.4f} std: {std:.4f}")
    return mean, std


if __name__ == "__main__":
    main()
