"""FID between generated and real image directories (the port's counterpart
of the root ``fid_score.py``).

    python -m t2igan_torch.fid_score --data bird|coco [--dims 2048] \
        [--batch_size 50] [--inception_ckpt PT] [--device cuda|cpu]
    python -m t2igan_torch.fid_score --path GENERATED REAL ...

``--data`` takes the reference's paths (fid_score.py:238-241); ``--path``
two directories, or ``.npz`` statistics (``mu``, ``sigma``).  The FID
Inception-v3's weights come from a local pytorch-fid state dict
(``--inception_ckpt`` or ``$T2IGAN_INCEPTION_CKPT``; the port's module
names are pytorch-fid's); without one the network is random, from seed 0,
and the score means nothing, which it says loudly.  Images are decoded by
the port's own decoder.  The default device is ``cuda``; without a card
this raises rather than falling back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from t2igan_torch.evaluation.fid import (calculate_fid_given_paths,
                                         make_activation_fn)
from t2igan_torch.models.inception import InceptionV3, init_inception_

PRESETS = {"bird": ["models/netG_bird/valid/single",
                    "data/birds/CUB_200_2011/images"],
           "coco": ["models/netG_coco/valid/single", "data/coco/val2014"]}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="FID")
    p.add_argument("--data", type=str, default=None, choices=sorted(PRESETS))
    p.add_argument("--path", type=str, nargs=2, default=None,
                   help="generated-dir real-dir (overrides --data presets)")
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--dims", type=int, default=2048,
                   choices=[64, 192, 768, 2048],
                   help="feature tap: 64/192/768/2048 map to the same "
                        "blocks as pytorch-fid")
    p.add_argument("--inception_ckpt", type=str,
                   default=os.environ.get("T2IGAN_INCEPTION_CKPT", ""))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def load_inception(variant: str, ckpt: str, device: str) -> InceptionV3:
    """The Inception-v3 ``variant`` in eval mode on ``device``: weights from
    the state dict ``ckpt`` when it is a file, else random from seed 0 with
    a warning."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the evaluation CLIs run on the "
                           "card by default; pass --device cpu to run on "
                           "the CPU")
    model = InceptionV3(variant=variant)
    if ckpt and os.path.isfile(ckpt):
        model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                         weights_only=True))
        print(f"Loaded inception weights: {ckpt}")
    else:
        print("WARNING: no inception checkpoint found — using random "
              "weights; scores are NOT comparable to the reference.")
        init_inception_(model, torch.Generator().manual_seed(0))
    return model.eval().to(dev, memory_format=torch.channels_last)


def main(argv: Optional[Sequence[str]] = None) -> float:
    args = parse_args(argv)
    if args.path:
        paths = args.path
    elif args.data:
        paths = PRESETS[args.data]
    else:
        raise SystemExit("pass --data {bird,coco} or --path GEN REAL")
    model = load_inception("fid", args.inception_ckpt, args.device)
    t0 = time.perf_counter()
    fid = calculate_fid_given_paths(
        paths, make_activation_fn(model, dims=args.dims), args.batch_size)
    print(f"statistics of {len(paths)} paths in "
          f"{time.perf_counter() - t0:.2f} s")
    print("FID: ", fid)
    return fid


if __name__ == "__main__":
    main()
